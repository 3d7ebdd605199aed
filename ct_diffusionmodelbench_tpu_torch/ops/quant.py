"""``qdot``: the reference's ``jnp.dot(x, w, preferred_element_type=f32)``.

Counterpart of ``ops/quant.py::qdot`` (plain-array branch only; int8 weights
belong to a later slice).  The product is returned in **f32**: ``torch.matmul``
on bf16 operands would round it to bf16, earlier than the reference does
wherever it keeps the f32 product (SwiGLU's gate/up, the LM-head logits).
"""

from __future__ import annotations

import torch


def qdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation and an f32 result.

    On the card, bf16 operands go to cuBLAS with an f32 output type (one
    bf16×bf16→f32 GEMM, no upcast copies); elsewhere the operands are upcast
    and multiplied in f32, which gives the same f32-accumulated product."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())
