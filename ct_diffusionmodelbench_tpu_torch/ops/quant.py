"""``qdot``: the reference's ``jnp.dot(x, w, preferred_element_type=f32)``.

Counterpart of ``ops/quant.py::qdot`` (plain-array branch only; int8 weights
belong to a later slice).  The product is returned in **f32**: ``torch.matmul``
on bf16 operands would round it to bf16, earlier than the reference does
wherever it keeps the f32 product (SwiGLU's gate/up, the LM-head logits).
"""

from __future__ import annotations

import torch


class _MatmulF32Out(torch.autograd.Function):
    """bf16 × bf16 → f32 product on the card, with a gradient.

    ``torch.mm(..., out_dtype=torch.float32)`` has no derivative of its own.
    The backward is the transpose of JAX's ``preferred_element_type=f32``
    dot: two products accumulated in f32, dx and dw cast to the operand
    dtypes.  The f32 cotangent is rounded to bf16 before them, so both run
    as bf16 tensor-core GEMMs (the TPU's default-precision pass also rounds
    an f32 operand to bf16)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def qdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation and an f32 result.

    On the card, bf16 operands go to cuBLAS with an f32 output type (one
    bf16×bf16→f32 GEMM, no upcast copies); elsewhere the operands are upcast
    and multiplied in f32, which gives the same f32-accumulated product.
    Both carry gradients."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        out = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())
