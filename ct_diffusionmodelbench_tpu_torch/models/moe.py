"""Mixture-of-experts FFN block (LLaDA-MoE).

Counterpart of ``models/moe.py``: softmax router → top-k expert probs
(optionally renormalized), routed experts through the grouped path
(``impl="grouped"``, the default on every device) or the dense one-hot
oracle (``impl="dense"``), the shared expert added on top, and the
switch-style load-balancing aux loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.models.layers import swiglu
from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import grouped_expert_ffn
from ct_diffusionmodelbench_tpu_torch.ops.quant import dequantize_tensor, is_quantized


def router_probs(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
                 norm_topk: bool):
    """(topk_probs [N,K] f32, topk_idx [N,K], full_probs [N,E] f32).

    Top-k through a stable descending sort: ties go to the lowest expert
    index, as ``jax.lax.top_k`` orders them (``torch.topk`` on CUDA does not
    promise that)."""
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_probs = sorted_p[:, :top_k]
    topk_idx = order[:, :top_k]
    if norm_topk:
        topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
    return topk_probs, topk_idx, probs


def load_balancing_loss(full_probs: torch.Tensor, topk_idx: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e f_e * P_e (f32 scalar)."""
    flat = topk_idx.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    frac_tokens = counts / torch.clamp_min(counts.sum(), 1.0)
    frac_probs = full_probs.mean(dim=0)
    return num_experts * torch.sum(frac_tokens * frac_probs)


def _experts_dense(x, topk_probs, topk_idx, we_gate, we_up, we_down):
    """One-hot dense evaluation: every expert sees every token (the oracle)."""
    num_experts = we_gate.shape[0]
    combine = torch.zeros((x.shape[0], num_experts), dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(1, topk_idx.long(), topk_probs.float())
    xf = x.float()
    gate = torch.einsum("nd,edf->nef", xf, we_gate.float())
    up = torch.einsum("nd,edf->nef", xf, we_up.float())
    h = (F.silu(gate) * up).to(x.dtype)
    out = torch.einsum("nef,efd->ned", h.float(), we_down.float())
    return torch.einsum("ned,ne->nd", out, combine).to(x.dtype)


def moe_block(x: torch.Tensor, params: dict, *, top_k: int, norm_topk: bool,
              impl: str = "auto", layer_index: Optional[int] = None):
    """x [N, D] → ([N, D], aux_loss scalar).

    ``layer_index`` with 4-D ``we_*`` stacks keeps the full [L, E, D, Fm]
    stacks intact: the kernels index the layer themselves.

    Quantized experts (``ops/quant.py`` dicts): lane-aligned stacks (D and
    Fm multiples of 128) go to the int8 grouped kernels; otherwise, or on
    the dense path, this layer's experts are dequantized to x's dtype and
    take the plain-weight path, as in the reference."""
    topk_probs, topk_idx, full_probs = router_probs(
        x, params["router"], top_k, norm_topk)
    if impl == "auto":
        impl = "grouped"
    we = [params["we_gate"], params["we_up"], params["we_down"]]
    li = layer_index
    if is_quantized(we[0]):
        shp = we[0]["q"].shape
        aligned = shp[-2] % 128 == 0 and shp[-1] % 128 == 0
        if impl != "grouped" or not aligned:
            if we[0]["q"].ndim == 4:
                we = [{"q": w["q"][li], "s": w["s"][li]} for w in we]
                li = None
            we = [dequantize_tensor(w, x.dtype) for w in we]
    if impl == "grouped":
        out = grouped_expert_ffn(x, topk_probs, topk_idx, *we, layer_index=li)
    elif impl == "dense":
        if we[0].ndim == 4:
            we = [w[li] for w in we]
        out = _experts_dense(x, topk_probs, topk_idx, *we)
    else:
        raise ValueError(f"unknown MoE impl {impl!r}")
    if "ws_gate" in params:
        out = out + swiglu(x, params["ws_gate"], params["ws_up"], params["ws_down"])
    aux = load_balancing_loss(full_probs, topk_idx, params["router"].shape[-1])
    return out, aux
