"""Transfer-count schedule for the block denoising loop.

Counterpart of ``sampling/schedule.py``: ``mask_num`` masked tokens are spread
over ``steps`` — every step gets ``mask_num // steps``, the first
``mask_num % steps`` steps one extra.
"""

from __future__ import annotations

import torch


def get_num_transfer_tokens(mask_index: torch.Tensor, steps: int) -> torch.Tensor:
    """mask_index: [B, L] bool → counts [B, steps] int32."""
    mask_num = mask_index.to(torch.int32).sum(dim=1, keepdim=True,
                                              dtype=torch.int32)
    base = mask_num // steps
    remainder = mask_num % steps
    step_ids = torch.arange(steps, dtype=torch.int32,
                            device=mask_index.device)[None, :]
    return base + (step_ids < remainder).to(torch.int32)
