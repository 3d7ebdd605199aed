"""Grouped (ragged) expert GEMM dispatch for MoE FFNs, differentiable.

Counterpart of ``ops/grouped_gemm.py::grouped_expert_ffn`` and of its
training path ``_pallas_ffn_ad``: every call, plain or int8-quantized
weights, runs its forward on the padded layout of
``ops/grouped_gemm_cuda.py`` (the CUDA kernels on the card, their plain
versions on the CPU).  The port has no ragged backend to dispatch to.

When autograd needs a gradient, bf16/f32 experts go through
:class:`GroupedFFN`, whose backward is the VJP of the reference's ragged
formulation (``_ffn_ragged``) with respect to x, topk_probs and the three
expert weights: it recomputes gate and up, as ``_pallas_ffn_bwd`` does
through ``jax.vjp``, and computes every product with :func:`grouped_mm`
(``torch._grouped_mm`` on the card, one ``torch.mm`` per expert on the CPU,
the same function: a library product, as the reference's ``lax.ragged_dot``
is XLA's).  The Function takes one layer's 3-D ``[E, D, Fm]`` weights, so
its weight gradients are per layer: a caller with layer-stacked weights
unbinds them once per forward (``models/transformer.py::split_layers``) and
autograd stacks the gradients once, where the reference's backward scatters
a full ``[L, E, D, Fm]`` cotangent per layer.  int8 weights stay
inference-only, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm_cuda import (
    _round_up, combine, ffn_padded, gather_rows, grouped_expert_ffn_cuda)
from ct_diffusionmodelbench_tpu_torch.ops.quant import is_quantized


def grouped_mm_plain(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_mm` in plain PyTorch: one f32 ``torch.mm`` per group,
    rounded to ``a``'s dtype."""
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    if b.ndim == 3:
        out = torch.empty((a.shape[0], b.shape[-1]), dtype=a.dtype, device=a.device)
        for e, (lo, hi) in enumerate(zip(starts, ends)):
            out[lo:hi] = torch.mm(a[lo:hi].float(), b[e].float())
        return out
    return torch.stack([torch.mm(a[:, lo:hi].float(), b[lo:hi].float()).to(a.dtype)
                        for lo, hi in zip(starts, ends)])


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Products over row groups ending at ``offs`` (int32 [E]): with 3-D
    ``b`` [E, K, N], ``a`` [M, K] → [M, N], group e's rows times ``b[e]``;
    with 2-D ``b`` [M, N], ``a`` [K, M] → [E, K, N], group e's columns of
    ``a`` times its rows of ``b``.  f32 accumulation, result in ``a``'s
    dtype.  ``torch._grouped_mm`` on a CUDA tensor, :func:`grouped_mm_plain`
    on the CPU."""
    if a.device.type == "cpu":
        return grouped_mm_plain(a, b, offs)
    return torch._grouped_mm(a, b, offs=offs)


def _silu_grads(gate, up, dh):
    """(h, d_gate, d_up) of h = silu(gate) · up, in f32."""
    gate, up, dh = gate.float(), up.float(), dh.float()
    sig = torch.sigmoid(gate)
    silu = gate * sig
    d_up = dh * silu
    d_gate = dh * up * (sig * (1.0 + gate * (1.0 - sig)))
    return silu * up, d_gate, d_up


class GroupedFFN(torch.autograd.Function):
    """The routed expert FFN, x [N, D] → [N, D], with a backward.

    Forward: ``grouped_expert_ffn_cuda``'s (K1/K2, or K3 under
    ``CTDB_GROUPED_FUSED=1``, then the combine G3, on the card).  Backward, on the forward's
    padded layout (each expert's rows one group, the tail padding rows the
    last expert's; padding rows get a zero cotangent and add nothing):

        dprobs[n, k] = g[n] · out[dest[n, k]]
        d_out[dest[n, k]] = probs[n, k] · g[n]
        gate, up = xs @ Wg[e], xs @ Wu[e]           (recomputed)
        dh = d_out @ Wd[e]ᵀ;  h, d_gate, d_up from silu(gate) · up
        dWd[e] = h_eᵀ d_out_e;  dWg[e] = xs_eᵀ d_gate_e;  dWu[e] = xs_eᵀ d_up_e
        dxs = d_gate @ Wg[e]ᵀ + d_up @ Wu[e]ᵀ;  dx[n] = Σ_k dxs[dest[n, k]]

    Every product is one :func:`grouped_mm` over the experts."""

    @staticmethod
    def forward(ctx, x, topk_probs, topk_idx, we_gate, we_up, we_down,
                drop_foreign=False):
        out_padded, dest, sizes, tile_m = ffn_padded(
            x, topk_idx, we_gate, we_up, we_down, drop_foreign=drop_foreign)
        # A dropped slot's row is zero, so its output and probability
        # gradient are; its d_out row must be too.
        probs_b = (topk_probs.masked_fill(topk_idx >= we_gate.shape[0], 0.0)
                   if drop_foreign else topk_probs)
        ctx.save_for_backward(x, probs_b, we_gate, we_up, we_down, out_padded,
                              dest, sizes)
        ctx.tile_m = tile_m
        n, k = topk_idx.shape
        return combine(out_padded, dest, topk_probs, n, k, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, probs, wg, wu, wd, out_padded, dest, sizes = ctx.saved_tensors
        n, k = probs.shape
        m_pad, d = out_padded.shape
        dt = x.dtype
        g32 = g.float()
        slot_rows = out_padded.index_select(0, dest).reshape(n, k, d)
        dprobs = torch.bmm(slot_rows.float(), g32[:, :, None])[..., 0]
        del slot_rows
        d_out = torch.zeros((m_pad, d), dtype=dt, device=x.device)
        d_out.index_copy_(0, dest, (probs[:, :, None] * g32[:, None, :])
                          .reshape(n * k, d).to(dt))
        # Group ends of the padded layout; the rows past the last expert's
        # tiles belong to it, as tile_expert clamps them.
        offs = torch.cumsum(_round_up(sizes, ctx.tile_m), 0, dtype=torch.int32)
        offs[-1] = m_pad
        xs = gather_rows(x, dest, k, m_pad)
        gate = grouped_mm(xs, wg, offs)
        up = grouped_mm(xs, wu, offs)
        dh = grouped_mm(d_out, wd.transpose(-2, -1), offs)
        h, d_gate, d_up = _silu_grads(gate, up, dh)
        del gate, up, dh
        h, d_gate, d_up = h.to(dt), d_gate.to(dt), d_up.to(dt)
        dwd = grouped_mm(h.t(), d_out, offs)
        del h, d_out
        dwg = grouped_mm(xs.t(), d_gate, offs)
        dwu = grouped_mm(xs.t(), d_up, offs)
        del xs
        dxs = grouped_mm(d_gate, wg.transpose(-2, -1), offs).float()
        dxs += grouped_mm(d_up, wu.transpose(-2, -1), offs).float()
        dx = dxs.index_select(0, dest).reshape(n, k, d).sum(dim=1).to(dt)
        return (dx, dprobs, None, dwg.to(wg.dtype), dwu.to(wu.dtype),
                dwd.to(wd.dtype), None)


def grouped_expert_ffn(x: torch.Tensor, topk_probs: torch.Tensor,
                       topk_idx: torch.Tensor, we_gate, we_up, we_down,
                       layer_index: Optional[int] = None,
                       drop_foreign: bool = False) -> torch.Tensor:
    """x [N, D], topk [N, K]; weights [E, D, Fm]/[E, Fm, D] or the
    layer-stacked [L, ...] forms with ``layer_index``, as tensors or as
    quantized ``{"q", "s"}`` dicts.  Differentiable for plain weights
    (:class:`GroupedFFN`); a stacked weight that needs a gradient is sliced
    to its layer here, which costs a full-stack gradient per layer: callers
    that train hand 3-D weights.  ``drop_foreign`` (expert parallelism):
    ``topk_idx`` holds E for slots of experts this rank does not hold; they
    add nothing (``ops/grouped_gemm_cuda.py::counting_layout``)."""
    wg = we_gate["q"] if is_quantized(we_gate) else we_gate
    if wg.ndim == 4 and layer_index is None:
        raise ValueError(
            "stacked [L, E, D, Fm] expert weights require layer_index "
            "(defaulting to layer 0 would silently compute with the wrong "
            "layer's experts)")
    li = layer_index if wg.ndim == 4 else None
    needs_grad = torch.is_grad_enabled() and not is_quantized(we_gate) and any(
        t.requires_grad for t in (x, topk_probs, we_gate, we_up, we_down))
    if not needs_grad:
        return grouped_expert_ffn_cuda(x, topk_probs, topk_idx, we_gate, we_up,
                                       we_down, layer_index=li,
                                       drop_foreign=drop_foreign)
    if li is not None:
        we_gate, we_up, we_down = we_gate[li], we_up[li], we_down[li]
    return GroupedFFN.apply(x, topk_probs, topk_idx, we_gate, we_up, we_down,
                            drop_foreign)
