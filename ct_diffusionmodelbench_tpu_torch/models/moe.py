"""Mixture-of-experts FFN block (LLaDA-MoE; DeepSeek-V3's sigmoid router).

Counterpart of ``models/moe.py``: softmax router → top-k expert probs
(optionally renormalized; or, port only, DeepSeek-V3's sigmoid scores with
a selection bias, renormalized and scaled: :func:`router_probs`), routed
experts through the grouped path
(``impl="grouped"``, the default on every device) or the dense one-hot
oracle (``impl="dense"``), the shared expert added on top, and the
switch-style load-balancing aux loss.  Every piece is differentiable: the
router's gradient flows through the top-k probabilities (the grouped
path's autograd wrapper returns their gradient) and through the aux loss's
mean router probabilities.

Expert parallelism (a tensor-parallel plan under a ``parallel/`` mesh whose
expert count divides the model axis): each model rank holds E/tp experts
and runs them through the same grouped path; routing slots of other ranks'
experts drop out of its padded layout.  The router replicates.  The routed
and the shared expert's partials (the shared expert splits column / row)
are added and summed over the model group once, in f32.  The reference
takes its one-hot dense path under a mesh, a constraint of GSPMD, not of
the function.  The load-balancing loss is computed once, from the
replicated router probabilities; when the batch is split over ``data`` or
its sequence over ``seq`` and the scope asks for the whole batch's loss,
its token counts and mean probabilities are summed over those axes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.models.layers import swiglu
from ct_diffusionmodelbench_tpu_torch.ops.glue import swiglu_act
from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import grouped_expert_ffn
from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm_cuda import router_topk
from ct_diffusionmodelbench_tpu_torch.ops.quant import dequantize_tensor, is_quantized, qdot
from ct_diffusionmodelbench_tpu_torch.parallel.comm import (
    copy_to_model, reduce_from_model, sum_over_data, sum_over_seq)
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import current_mesh, current_scope


def router_probs(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
                 norm_topk: bool, sigmoid: bool = False,
                 bias: Optional[torch.Tensor] = None, scale: float = 1.0):
    """(topk_probs [N,K] f32, topk_idx [N,K] int64, full_probs [N,E] f32).

    The f32 logits' softmax and top-k through a stable descending sort:
    ties go to the lowest expert index, as ``jax.lax.top_k`` orders them
    (``ops/grouped_gemm_cuda.py::router_topk``: G4 on the card unless the
    logits need a gradient).  ``sigmoid``: DeepSeek-V3's router instead,
    the top-k of the sigmoid scores plus the selection ``bias`` [E], the
    weights the chosen unbiased scores, renormalized with ``norm_topk``,
    times ``scale``; ``full_probs`` are then the sigmoid scores."""
    logits = torch.matmul(x.float(), w_router.float())
    return router_topk(logits, top_k, norm_topk, sigmoid=sigmoid, bias=bias, scale=scale)


def load_balancing_loss(full_probs: torch.Tensor, topk_idx: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e f_e * P_e (f32 scalar).

    Under a scope whose batch is split over ``data`` (or its sequence over
    ``seq``) and that asks for the whole batch's loss, the counts and
    probability sums are summed over ``data`` (``seq``) first.
    ``sum_over_data``'s backward sums the data ranks' cotangents, so the
    training step's gradient mean over ``data`` stays exact;
    ``sum_over_seq``'s is the identity, as the step sums the gradients over
    ``seq``."""
    flat = topk_idx.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    scope = current_scope()
    over_data = scope is not None and scope.global_aux and scope.batch is not None
    over_seq = scope is not None and scope.global_aux and scope.positions is not None
    if over_data or over_seq:
        mesh, n = scope.mesh, full_probs.shape[0]
        probs = full_probs.sum(dim=0)
        if over_seq:
            counts, probs, n = sum_over_seq(counts, mesh), sum_over_seq(probs, mesh), n * mesh.seq
        if over_data:
            counts, probs, n = sum_over_data(counts, mesh), sum_over_data(probs, mesh), n * mesh.data
        frac_probs = probs / n
    else:
        frac_probs = full_probs.mean(dim=0)
    frac_tokens = counts / torch.clamp_min(counts.sum(), 1.0)
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


def local_slots(topk_idx: torch.Tensor, e_local: int, model_rank: int) -> torch.Tensor:
    """Routing ids relative to model rank ``model_rank``'s experts; slots of
    other ranks' experts become ``e_local``, the grouped layout's dropped
    id."""
    local = topk_idx - model_rank * e_local
    return torch.where((local >= 0) & (local < e_local), local,
                       torch.full_like(local, e_local))


def _shared_partial(xc: torch.Tensor, params: dict) -> torch.Tensor:
    """This rank's f32 partial of the column / row split shared expert."""
    h = swiglu_act(qdot(xc, params["ws_gate"]), qdot(xc, params["ws_up"]), xc.dtype)
    return qdot(h, params["ws_down"])


def moe_block(x: torch.Tensor, params: dict, *, top_k: int, norm_topk: bool,
              impl: str = "auto", layer_index: Optional[int] = None,
              plan=None, sigmoid: bool = False, scale: float = 1.0,
              routes: Optional[list] = None):
    """x [N, D] → ([N, D], aux_loss scalar).

    ``sigmoid`` / ``scale``: the router of :func:`router_probs`, with the
    layer's selection bias ``params["e_bias"]`` where it has one.
    ``routes``: a list that gets the chosen experts, ``topk_idx`` [N, K].

    ``layer_index`` with 4-D ``we_*`` stacks keeps the full [L, E, D, Fm]
    stacks intact: the kernels index the layer themselves.

    Quantized experts (``ops/quant.py`` dicts): lane-aligned stacks (D and
    Fm multiples of 128) go to the int8 grouped kernels; otherwise, or on
    the dense path, this layer's experts are dequantized to x's dtype and
    take the plain-weight path, as in the reference.

    ``plan`` (``parallel/sharding.py::TPPlan``): expert parallelism and the
    split shared expert where it says so; the output is then already summed
    over the model group."""
    topk_probs, topk_idx, full_probs = router_probs(
        x, params["router"], top_k, norm_topk, sigmoid, params.get("e_bias"), scale)
    if routes is not None:
        routes.append(topk_idx)
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
    aux = load_balancing_loss(full_probs, topk_idx, params["router"].shape[-1])
    experts = plan is not None and plan.experts
    shared = plan is not None and plan.shared and "ws_gate" in params
    # The sharded products read x through one copy_to_model: its backward
    # sums their partial gradients over the model group once.
    xc = copy_to_model(x) if experts or shared else x
    if experts:
        if impl != "grouped":
            raise ValueError("expert parallelism runs the grouped path")
        out = grouped_expert_ffn(
            xc, copy_to_model(topk_probs),
            local_slots(topk_idx, we[0].shape[-3], current_mesh().model_rank),
            *we, layer_index=li, drop_foreign=True)
    elif impl == "grouped":
        out = grouped_expert_ffn(x, topk_probs, topk_idx, *we, layer_index=li)
    elif impl == "dense":
        if we[0].ndim == 4:
            we = [w[li] for w in we]
        out = _experts_dense(x, topk_probs, topk_idx, *we)
    else:
        raise ValueError(f"unknown MoE impl {impl!r}")
    if experts or shared:
        # One sum over the model group for the routed and shared partials.
        if experts and shared:
            partial = out.float() + _shared_partial(xc, params)
        else:
            partial = out.float() if experts else _shared_partial(xc, params)
        summed = reduce_from_model(partial).to(x.dtype)
        out = summed if experts else out + summed
    if "ws_gate" in params and not shared:
        out = out + swiglu(x, params["ws_gate"], params["ws_up"], params["ws_down"])
    return out, aux
