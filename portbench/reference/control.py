"""The control: the plain reference computed one precision below the
configuration's.

The configurations state bf16; the precision below is fp8.  :func:`fp8`
rounds one operand of a linear product to float8 e4m3 with one scale per
row of the reduction (per token for activations, per output column for
weights), the way an fp8 GEMM takes its operands, and the product then sums
in float32.  The reference given this cast stands in for a program that
computed its products in fp8: the comparison has to fail it.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x rounded to e4m3 along ``axis``'s scale, back in float32."""
    scale = x.abs().amax(dim=axis, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
