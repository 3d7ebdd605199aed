"""Ring attention: sequence parallelism over the mesh's ``seq`` axis.

Counterpart of ``ops/ring_attention.py``.  Each seq rank holds one slice of
the sequence of q, k and v (S/sp positions).  In each of ``sp`` steps it
folds one K / V chunk into a running f32 (output, log-sum-exp) pair with
the online-softmax combine, then passes (k, v, mask) to the next seq rank
and takes the previous rank's (``parallel/comm.py::ring_shift``); the last
chunk is folded without a transfer.  Every rank sees every chunk once, and
no rank holds the whole sequence.

One step is one chunk of flash attention with its lse
(``ops/flash_attention.py::flash_attention_fwd``, no RoPE: q and k arrive
rotated): the flash forward kernel on a CUDA tensor, its plain version on
the CPU.  The reference's chunk (``_chunk_attention``, an einsum softmax in
XLA) keeps its output in f32 and its lse as [B, S, H]; the port's chunk
returns the output in q.dtype and the lse as [B, H, S], so :func:`combine`
works in that layout.  A chunk whose keys are all padding has lse ≈ −1e30
and weight exp(−1e30 − lse) = 0 in the combine.

The backward (:class:`RingAttention`) is written out, because the flash
forward has no gradient through its lse: with the final output o and the
final lse, each chunk's probabilities are exp(s − lse), so the flash
backward kernels (``ops/flash_attention_bwd.py``) on (q, k_c, v_c) give
that chunk's exact share of dq, dk_c and dv_c.  The backward rotates (k,
v, mask) around the same ring together with the dk / dv accumulators of
the chunk it holds; after ``sp`` rotations of the accumulators each is back
with its owner.
"""

from __future__ import annotations

from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention_fwd, mask_bias)
from ct_diffusionmodelbench_tpu_torch.parallel.comm import ring_shift
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh

__all__ = ["NEG_INF", "combine", "ring_attention", "ring_attention_local",
           "RingAttention"]


def combine(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor,
            lse_i: torch.Tensor):
    """Online-softmax combine of two normalized partial results: o, o_i
    [B, S, H, Dh] (o f32), lse, lse_i [B, H, S] f32 → (o f32, lse)."""
    m = torch.maximum(lse, lse_i)
    w_old = torch.exp(lse - m)
    w_new = torch.exp(lse_i - m)
    denom = torch.clamp_min(w_old + w_new, 1e-30)

    def rows(w):   # [B, H, S] → [B, S, H, 1]
        return w.transpose(1, 2)[..., None]

    o = (o * rows(w_old) + o_i.float() * rows(w_new)) / rows(denom)
    return o, m + torch.log(denom)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *, mesh: Mesh):
    """This seq rank's (o [B, S/sp, H, Dh] in q.dtype, lse [B, H, S/sp] f32)
    of attention over the whole ring.  q, k, v: [B, S/sp, H|KV, Dh] local
    slices, rotated; mask: [B, S/sp] local (1 = real)."""
    b, s, h, _ = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    o = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                    device=q.device)
    lse = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    k_c, v_c, m_c = k, v, mask
    for step in range(mesh.seq):
        o, lse = combine(o, lse, *flash_attention_fwd(q, k_c, v_c, mask=m_c))
        if step < mesh.seq - 1:
            k_c, v_c, m_c = _rotate(k_c, v_c, m_c, mesh=mesh)
    return o.to(q.dtype), lse


def _rotate(*tensors, mesh: Mesh):
    """The tensors (None passes through) from the previous seq rank."""
    real = [t for t in tensors if t is not None]
    moved = iter(ring_shift(real, mesh))
    return tuple(None if t is None else next(moved) for t in tensors)


class RingAttention(torch.autograd.Function):
    """Ring attention with the chunked flash backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, mesh):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if mask is not None:
            mask = mask.to(torch.int32).contiguous()
        o, lse = ring_attention_local(q, k, v, mask, mesh=mesh)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.mesh = mesh
        return o

    @staticmethod
    def backward(ctx, do):
        # Imported here: flash_attention_bwd imports flash_attention, which
        # the models package imports while this module loads.
        from ct_diffusionmodelbench_tpu_torch.ops.flash_attention_bwd import (
            flash_attention_bwd)

        q, k, v, mask, o, lse = ctx.saved_tensors
        mesh = ctx.mesh
        b, s = q.shape[:2]
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_c, v_c, m_c = k, v, mask
        for step in range(mesh.seq):
            bias = mask_bias(m_c, b, s, q.device)
            dq_i, dk_i, dv_i = flash_attention_bwd(q, k_c, v_c, bias, o, do, lse)
            dq += dq_i
            dk += dk_i
            dv += dv_i
            if step < mesh.seq - 1:
                k_c, v_c, m_c, dk, dv = _rotate(k_c, v_c, m_c, dk, dv, mesh=mesh)
            else:   # the accumulators' last hop home
                dk, dv = _rotate(dk, dv, mesh=mesh)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *, mesh: Mesh) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``seq`` axis on this rank's slices.

    q: [B, S/sp, H, Dh]; k, v: [B, S/sp, KV, Dh] (rotated); mask [B, S/sp]
    (1 = real).  The rows are the rank's rows over ``data`` and the heads
    its heads over ``model``; every rank of the seq group must call it.
    Differentiable (:class:`RingAttention`) when grad is on and an input
    requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RingAttention.apply(q, k, v, mask, mesh)
    return ring_attention_local(q, k, v, mask, mesh=mesh)[0]
