"""Grouped (ragged) expert GEMM dispatch for MoE FFNs.

Counterpart of ``ops/grouped_gemm.py::grouped_expert_ffn`` for bf16 and f32
weights: every call goes to the padded-layout path of
``ops/grouped_gemm_cuda.py`` (CUDA kernels on the card, their plain
versions on the CPU).  The ragged backend, int8 weights and the backward
belong to later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm_cuda import (
    grouped_expert_ffn_cuda)


def grouped_expert_ffn(x: torch.Tensor, topk_probs: torch.Tensor,
                       topk_idx: torch.Tensor, we_gate: torch.Tensor,
                       we_up: torch.Tensor, we_down: torch.Tensor,
                       layer_index: Optional[int] = None) -> torch.Tensor:
    """x [N, D], topk [N, K]; weights [E, D, Fm]/[E, Fm, D] or the
    layer-stacked [L, ...] forms with ``layer_index``."""
    if we_gate.ndim == 4 and layer_index is None:
        raise ValueError(
            "stacked [L, E, D, Fm] expert weights require layer_index "
            "(defaulting to layer 0 would silently compute with the wrong "
            "layer's experts)")
    li = layer_index if we_gate.ndim == 4 else None
    return grouped_expert_ffn_cuda(x, topk_probs, topk_idx, we_gate, we_up,
                                   we_down, layer_index=li)
