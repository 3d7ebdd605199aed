"""Core transformer layers: RMSNorm, RoPE, SwiGLU.

Counterpart of ``models/layers.py``.  Norms and rotary math run in float32
whatever the activation dtype; products accumulate in f32.  The norm and
SwiGLU's activation are ``ops/glue.py``'s: one kernel each on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.ops import glue
from ct_diffusionmodelbench_tpu_torch.ops.quant import qdot


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``ops/glue.py::rms_norm`` over x's last dim; a strided x (the block
    cache's slice of its block) is made contiguous first."""
    return glue.rms_norm(x.contiguous(), scale, eps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings.

    positions: [B, S] int → cos, sin each [B, S, head_dim//2] f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)  # a host scalar: no copy
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]) — HF LLaMA convention.

    x: [B, S, H, Dh]; cos/sin: [B, S, Dh//2]."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    gate = qdot(x, w_gate)
    up = qdot(x, w_up)
    h = glue.swiglu_act(gate, up, x.dtype)
    return qdot(h, w_down).to(x.dtype)
