"""Config-driven masked-diffusion transformer in PyTorch.

Counterpart of ``models/transformer.py``: pre-norm residual blocks with
RMSNorm, RoPE, GQA bidirectional cache-less attention and a SwiGLU FFN that
is dense or mixture-of-experts per config.

Parameters keep the reference's layer-stacked layout: ``params["blocks"][k]``
is ``[L, ...]`` and the forward is a Python loop over the layer id.  Each
stack is split once per forward (``torch.unbind``: zero-copy views whose
backward stacks the per-layer gradients once, where a slice per layer
would allocate a full-stack zero gradient for every layer); the MoE expert
stacks ``[L, E, D, Fm]`` go to the grouped kernels whole, with the layer
id, as the TPU kernels took a scalar-prefetched layer id, unless autograd
needs their gradient: then they are split too, and each layer's expert FFN
gets its own 3-D weights (``ops/grouped_gemm.py``).  An expert entry may
also be a list of per-layer tensors (the trainer's per-layer gradient
leaves).  Quantized leaves (``ops/quant.py`` dicts) ride the same way: a
stack's ``q`` and ``s`` are split together, the expert stacks stay whole.

``forward(..., remat=True)`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``);
``remat="dots"`` saves the outputs of the blocks' no-batch matrix products
and recomputes everything else (a selective-checkpoint policy, the
reference's ``dots_with_no_batch_dims_saveable``), for the trainer;
:func:`make_forward_fn` is the inference entry point.

With the tracer on (``utils/profiling.py``), each call of the inference
entry point is a ``model.forward`` span with its counters
(:func:`count_pass`), and :func:`forward` records ``model.embed``, one
``model.attn`` (``attn_norm`` through the residual add) and one
``model.ffn`` (``ffn_norm`` through the FFN's add) a layer, both in
:func:`block`, and ``model.head`` (final norm, slice, LM head).

Multi-head latent attention (``cfg.is_mla``: DeepSeek-V3's layers,
``models/mla.py``) projects q and the latent row in :func:`block` and hands
them to the pass's attention as ``attend(li, q, latent, None)``; the full
forward attends in the up-projected form.  An MoE model's first
``cfg.dense_layers`` layers have a dense FFN (:func:`split_layers`), and
its router may be DeepSeek-V3's sigmoid one (``models/moe.py``).

The SDAR family (``cfg.block_length`` > 0) runs the same blocks with
block-causal attention (``ops/attention.py``): blocks of ``block_length``
positions from the first position of the padded row, so under the
runner's left padding a generated block starts right after the prompt when
the padded prompt length is a multiple of the block length (the SDAR
sampler pads it so); positions restart at each row's first real token and
pad keys are never seen; logits are unshifted (position i predicts token
i).  Every pass runs the layer body :func:`block`, each with its own
attention: the full forward here, the dual cache's refresh and cached step
(``models/block_cache.py``) and SDAR's prefill and block pass
(``models/sdar_cache.py``).

Under a ``parallel/`` mesh whose model axis is above 1 the forward takes
this rank's shard of the parameters (``parallel/sharding.py``): a
vocab-parallel embedding (each rank looks up the ids of its vocabulary
slice, the rows are summed), head-sharded attention whose ``wo`` partial
product is summed over the model group in f32 before the residual add, a
column / row split FFN summed likewise (expert parallelism for MoE,
``models/moe.py``), and a vocab-sharded LM head whose slices are gathered.
Parts whose dimensions do not divide the model axis run whole on every
rank (``parallel/sharding.py::tp_plan``).

Under a scope that splits the sequence over ``seq`` (``parallel/mesh.py``)
the forward takes this rank's slice of the tokens: RoPE at the global
positions (the real tokens before the slice are counted over ``seq``),
ring attention (``ops/attention.py``), the FFN / MoE on the local tokens
(the MoE statistics summed over ``seq``) and the local logits.  A logit
range (``logit_start``) gathers the final hidden states over ``seq`` first,
so every seq rank returns the whole range; the shifted-logit families take
the previous seq rank's last hidden state (``parallel/comm.py::shift_seq``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.models import mla
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.layers import rms_norm, rope_angles, swiglu
from ct_diffusionmodelbench_tpu_torch.models.moe import moe_block
from ct_diffusionmodelbench_tpu_torch.ops.attention import attention
from ct_diffusionmodelbench_tpu_torch.ops.glue import swiglu_act
from ct_diffusionmodelbench_tpu_torch.ops.quant import is_quantized, qdot
from ct_diffusionmodelbench_tpu_torch.parallel.comm import (
    all_gather, copy_to_model, gather_from_model, gather_from_seq,
    reduce_from_model, shift_seq)
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import current_mesh, current_scope
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import TPPlan, tp_plan
from ct_diffusionmodelbench_tpu_torch.utils.profiling import count, span

EXPERT_STACK_KEYS = ("we_gate", "we_up", "we_down")
DENSE_FFN_KEYS = ("w_gate", "w_up", "w_down")
MOE_KEYS = ("router", "e_bias", "ws_gate", "ws_up", "ws_down") + EXPERT_STACK_KEYS
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# remat="dots": the products whose outputs the backward keeps (no batch
# dimension, as jax.checkpoint_policies.dots_with_no_batch_dims_saveable).
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                leaf_transform: Optional[Callable] = None) -> dict:
    """Random-init parameter dict (scaled normals), built on ``device`` in
    the model dtype from a seeded ``torch.Generator`` on that device.

    Each tensor is drawn directly in its dtype: no f32 staging of the
    2.1 G-element expert stacks.  The draws differ from the JAX init's (a
    different generator); parity tests bridge one set of weights instead
    (io/bridge.py).

    ``leaf_transform(name, tensor)`` is applied to each drawn weight as it
    is built, before the next is drawn (``ops/quant.py`` quantizes there, so
    a full-size int8 init never holds the whole bf16 tree)."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xform = leaf_transform or (lambda name, t: t)

    def dense(shape, fan_in, name):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        return xform(name, t.mul_(1.0 / math.sqrt(fan_in)))

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    L, D, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    Hq, Hkv, Dh = cfg.q_size, cfg.kv_size, cfg.head_dim
    if cfg.is_mla:
        H, R, P = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        Hv = H * cfg.v_head_dim
        blocks = {
            "attn_norm": ones((L, D)),
            "wq": dense((L, D, H * cfg.qk_head_dim), D, "wq"),
            "wkv_a": dense((L, D, R + P), D, "wkv_a"),
            "kv_norm": ones((L, R)),
            "wkv_b": dense((L, R, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)), R, "wkv_b"),
            "wo": dense((L, Hv, D), Hv, "wo"),
            "ffn_norm": ones((L, D)),
        }
    else:
        blocks = {
            "attn_norm": ones((L, D)),
            "wq": dense((L, D, Hq), D, "wq"),
            "wk": dense((L, D, Hkv), D, "wk"),
            "wv": dense((L, D, Hkv), D, "wv"),
            "wo": dense((L, Hq, D), Hq, "wo"),
            "ffn_norm": ones((L, D)),
        }
    if cfg.attention_bias:
        blocks["bq"] = zeros((L, Hq))
        blocks["bk"] = zeros((L, Hkv))
        blocks["bv"] = zeros((L, Hkv))
    if cfg.qk_norm:
        blocks["q_norm"] = ones((L, Dh))
        blocks["k_norm"] = ones((L, Dh))
    # An MoE model's first cfg.dense_layers layers are dense: their FFN
    # stacks hold those layers, the expert stacks the rest (split_layers).
    Ld = cfg.dense_layers if cfg.is_moe else L
    if cfg.is_moe:
        E, Fm, Lm = cfg.num_experts, cfg.moe_intermediate_size, L - Ld
        blocks["router"] = dense((Lm, D, E), D, "router")
        if cfg.scoring_func == "sigmoid":
            blocks["e_bias"] = torch.zeros((Lm, E), dtype=torch.float32, device=dev)
        blocks["we_gate"] = dense((Lm, E, D, Fm), D, "we_gate")
        blocks["we_up"] = dense((Lm, E, D, Fm), D, "we_up")
        blocks["we_down"] = dense((Lm, E, Fm, D), Fm, "we_down")
        if cfg.num_shared_experts:
            Fs = Fm * cfg.num_shared_experts
            blocks["ws_gate"] = dense((Lm, D, Fs), D, "ws_gate")
            blocks["ws_up"] = dense((Lm, D, Fs), D, "ws_up")
            blocks["ws_down"] = dense((Lm, Fs, D), Fs, "ws_down")
    if Ld:
        Fd = cfg.intermediate_size
        blocks["w_gate"] = dense((Ld, D, Fd), D, "w_gate")
        blocks["w_up"] = dense((Ld, D, Fd), D, "w_up")
        blocks["w_down"] = dense((Ld, Fd, D), Fd, "w_down")
    params = {
        "embed": dense((V, D), D, "embed"),
        "blocks": blocks,
        "final_norm": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V), D, "lm_head")
    return params


def token_positions(attn_mask: Optional[torch.Tensor], B: int, S: int,
                    device: torch.device) -> torch.Tensor:
    """RoPE position ids: cumsum-restart over the attention mask (padding
    rows repeat position 0), else plain arange."""
    if attn_mask is not None:
        pos = torch.cumsum(attn_mask.to(torch.int32), dim=-1, dtype=torch.int32) - 1
        return torch.clamp_min(pos, 0)
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def seq_positions(attn_mask: Optional[torch.Tensor], B: int, S: int, scope,
                  device: torch.device) -> torch.Tensor:
    """:func:`token_positions` of the whole row, at this seq rank's slice
    (S local positions): the real tokens of the earlier slices are counted
    over ``seq``."""
    mesh, lo = scope.mesh, scope.positions.start
    if attn_mask is None:
        return torch.arange(lo, lo + S, dtype=torch.int32, device=device)[None].expand(B, S)
    m = attn_mask.to(torch.int32)
    counts = all_gather(m.sum(dim=-1, keepdim=True), mesh.seq_group, mesh, dim=1)
    before = counts[:, :mesh.seq_rank].sum(dim=1, keepdim=True, dtype=torch.int32)
    pos = torch.cumsum(m, dim=-1, dtype=torch.int32) + before - 1
    return torch.clamp_min(pos, 0)


def tp_plan_of(cfg: Optional[ModelConfig]) -> Optional[TPPlan]:
    """The tensor-parallel plan under the active mesh (``parallel/``), or
    None off a mesh, at tp 1 or without a config."""
    mesh = current_mesh()
    if cfg is None or mesh is None or mesh.model == 1:
        return None
    return tp_plan(cfg, mesh.model)


def lm_head_logits(params: dict, x: torch.Tensor,
                   cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Hidden states → f32 vocab logits, with the tied-embedding fallback.
    With ``cfg``, under a mesh whose plan shards the vocabulary, each model
    rank computes its slice of the vocabulary and the slices are gathered:
    every rank returns the full-vocab logits."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    plan = tp_plan_of(cfg)
    if plan is not None and plan.vocab:
        return gather_from_model(qdot(copy_to_model(x), head))
    return qdot(x, head)


def final_logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The cache passes' head: final norm, then f32 vocab logits."""
    with span("model.head"):
        return lm_head_logits(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def _project(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` in x's dtype: a bf16 product for plain weights, the f32
    ``qdot`` rounded once for quantized ones (as the reference's
    ``qdot(...).astype``)."""
    if is_quantized(w):
        return qdot(x, w).to(x.dtype)
    return torch.matmul(x, w)


def _unbind(leaf):
    """A layer stack → per-layer views; a quantized stack → per-layer
    ``{"q", "s"}`` dicts."""
    if is_quantized(leaf):
        return [{"q": q, "s": s} for q, s in
                zip(torch.unbind(leaf["q"]), torch.unbind(leaf["s"]))]
    return torch.unbind(leaf)


def _per_layer_experts(stacks: dict) -> bool:
    """Whether the expert weights go to the blocks layer by layer: they
    come as per-layer lists, or autograd needs a stack's gradient."""
    return any(isinstance(v, (list, tuple)) or (
        torch.is_grad_enabled() and isinstance(v, torch.Tensor) and v.requires_grad)
        for v in stacks.values())


def split_layers(cfg: ModelConfig, params: dict):
    """(per-layer param dicts, the whole MoE expert stacks or None): every
    stack is unbound once per forward but the experts', which stay whole
    unless :func:`_per_layer_experts`.  In an MoE model with leading dense
    layers (``cfg.dense_layers``), the dense FFN stacks hold those layers
    and the MoE stacks the rest: layer li takes MoE entry li - dense_layers
    (the whole expert stacks too, ``_ffn_block``)."""
    blocks = params["blocks"]
    stacks = {k: blocks[k] for k in EXPERT_STACK_KEYS if k in blocks} or None
    if stacks is not None and _per_layer_experts(stacks):
        stacks = None
    layers = {k: v if isinstance(v, (list, tuple)) else _unbind(v)
              for k, v in blocks.items()
              if stacks is None or k not in EXPERT_STACK_KEYS}
    k = cfg.dense_layers
    if not k:
        return [{name: v[li] for name, v in layers.items()}
                for li in range(cfg.num_layers)], stacks
    shared = {name: v for name, v in layers.items() if name not in DENSE_FFN_KEYS + MOE_KEYS}
    dense = {name: v for name, v in layers.items() if name in DENSE_FFN_KEYS}
    moe = {name: v for name, v in layers.items() if name in MOE_KEYS}
    return [{**{name: v[li] for name, v in shared.items()},
             **({name: v[li] for name, v in dense.items()} if li < k
                else {name: v[li - k] for name, v in moe.items()})}
            for li in range(cfg.num_layers)], stacks


def embed_tokens(params: dict, input_ids: torch.Tensor,
                 plan: Optional[TPPlan] = None) -> torch.Tensor:
    """Token embeddings; out-of-range ids clamp, as the reference's
    ``mode="clip"`` gather.  With a plan that shards the vocabulary, each
    model rank looks up the ids in its slice (zeros elsewhere) and the
    ranks' rows are summed."""
    embed = params["embed"]
    if plan is None or not plan.vocab:
        return F.embedding(input_ids.clamp(0, embed.shape[0] - 1), embed)
    n = embed.shape[0]
    local = input_ids.clamp(0, n * plan.tp - 1) - current_mesh().model_rank * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), embed) * mine[..., None].to(embed.dtype)
    return reduce_from_model(rows).to(embed.dtype)


def _attn_project(cfg: ModelConfig, h: torch.Tensor, lp: dict,
                  plan: Optional[TPPlan] = None):
    """QKV projection: [B, S, D] → q [B, S, H, Dh], k/v [B, S, KV, Dh],
    biased and qk-normed per config, unrotated.  Under a plan that shards
    attention, ``lp`` holds this rank's H/tp and KV/tp heads (the qk-norm
    gain is per head dim, so head sharding leaves it whole)."""
    tp = 1
    if plan is not None and plan.attn:
        h, tp = copy_to_model(h), plan.tp
    B, S, _ = h.shape
    H, KV, Dh = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
    q = _project(h, lp["wq"])
    k = _project(h, lp["wk"])
    v = _project(h, lp["wv"])
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KV, Dh)
    v = v.reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        # Under tp the gains meet only this rank's heads: copy_to_model sums
        # their gradient over the model group.
        gq, gk = lp["q_norm"], lp["k_norm"]
        if tp > 1:
            gq, gk = copy_to_model(gq), copy_to_model(gk)
        q = rms_norm(q, gq, cfg.norm_eps)
        k = rms_norm(k, gk, cfg.norm_eps)
    return q, k, v


def _out_project(a: torch.Tensor, w, plan: Optional[TPPlan] = None) -> torch.Tensor:
    """Attention output @ ``wo``; under a plan that shards attention, this
    rank's f32 partial product summed over the model group."""
    if plan is not None and plan.attn:
        return reduce_from_model(qdot(a, w)).to(a.dtype)
    return _project(a, w)


def _swiglu_partial(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """This rank's f32 partial of a column / row split SwiGLU."""
    hc = copy_to_model(h)
    a = swiglu_act(qdot(hc, lp["w_gate"]), qdot(hc, lp["w_up"]), h.dtype)
    return qdot(a, lp["w_down"])


def _ffn_block(cfg: ModelConfig, x, lp, moe_stacks=None, layer_index=None,
               plan: Optional[TPPlan] = None, routes: Optional[list] = None):
    """Post-attention FFN half of a block: residual stream → (ffn_out, aux).
    Under a tp plan the output is already summed over the model group.
    ``routes``: an MoE layer appends its chosen experts (``moe_block``)."""
    B, S, D = x.shape
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if cfg.is_moe and (layer_index is None or layer_index >= cfg.dense_layers):
        moe_params = {k: lp[k] for k in MOE_KEYS if k in lp}
        if moe_stacks is not None:
            moe_params.update(moe_stacks)
        out, aux = moe_block(h.reshape(B * S, D), moe_params,
                             top_k=cfg.num_experts_per_tok,
                             norm_topk=cfg.norm_topk_prob,
                             layer_index=(None if layer_index is None
                                          else layer_index - cfg.dense_layers),
                             plan=plan, sigmoid=cfg.scoring_func == "sigmoid",
                             scale=cfg.routed_scaling_factor, routes=routes)
        return out.reshape(B, S, D), aux
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if plan is not None and plan.ffn:
        return reduce_from_model(_swiglu_partial(h, lp)).to(x.dtype), zero
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), zero


def block(cfg: ModelConfig, x: torch.Tensor, lp: dict, li: int, attend: Callable,
          stacks: Optional[dict] = None, plan: Optional[TPPlan] = None,
          routes: Optional[list] = None):
    """Layer ``li`` of every pass on x [B, S, D]: (x, the FFN's aux loss).
    ``lp``: the layer's params; ``stacks``: the whole MoE expert stacks or
    None.  ``attend(li, q, k, v)`` → [B, S, H, Dh] is the pass's attention
    on the layer's unrotated projections (under latent attention q and the
    latent row, ``models/mla.py::project``, and no v): where it rotates,
    which keys it reads, whether K and V go into a cache.  ``plan`` (tensor parallelism
    under the active mesh): a head-sharded attention computes this rank's
    heads, ``wo``'s partial product and the FFN's are summed over the model
    group before their residual adds; parts the plan replicates run whole.
    ``routes``: a list that an MoE layer appends its chosen experts to."""
    B, S, _ = x.shape
    with span("model.attn"):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        if cfg.is_mla:
            q, k, v = mla.project(cfg, h, lp)
        else:
            q, k, v = _attn_project(cfg, h, lp, plan)
        x = x + _out_project(attend(li, q, k, v).reshape(B, S, -1), lp["wo"], plan)
    with span("model.ffn"):
        ffn_out, aux = _ffn_block(cfg, x, lp, stacks, li, plan, routes)
        x = x + ffn_out
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def run_blocks(cfg: ModelConfig, params: dict, x: torch.Tensor, cos, sin,
               attn_mask, plan: Optional[TPPlan] = None,
               remat: "bool | str" = False):
    """The ``cfg.num_layers`` blocks of ``params`` on x with the full
    forward's attention: (x, the sum of the layers' aux losses).
    ``remat``: see :func:`forward`."""

    layers, stacks = split_layers(cfg, params)
    if cfg.is_mla:
        key_start = mla.key_starts(attn_mask, x.shape[0], x.shape[1], x.device)

    def attend(li, q, k, v):
        if cfg.is_mla:
            q_pe, lat = mla.rotate(cfg, q, k, cos, sin)
            return mla.up_attention(cfg, q, q_pe, lat, layers[li]["wkv_b"], key_start)
        return attention(q, k, v, mask=attn_mask, impl=cfg.attn_impl,
                         causal=cfg.causal, rope=(cos, sin), block_len=cfg.block_length)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt_kw = dict(use_reentrant=False)
    if remat == "dots":
        ckpt_kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                        _save_dots)
    for li, lp in enumerate(layers):
        if remat:
            x, aux_l = checkpoint(block, cfg, x, lp, li, attend, stacks, plan, **ckpt_kw)
        else:
            x, aux_l = block(cfg, x, lp, li, attend, stacks, plan)
        aux = aux + aux_l
    return x, aux


def shift_right(x: torch.Tensor, scope=None) -> torch.Tensor:
    """The shifted-logit families' hidden states: position i takes i - 1's
    (the first keeps its own).  Under a scope that splits the sequence, the
    slice's first position takes the previous seq rank's last."""
    if scope is None or scope.positions is None:
        return torch.cat([x[:, :1], x[:, :-1]], dim=1)
    prev = shift_seq(x[:, -1:].contiguous(), x[:, :1], scope.mesh)
    return torch.cat([prev, x[:, :-1]], dim=1)


def forward(cfg: ModelConfig, params: dict, input_ids: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            logit_start: Optional[int] = None,
            logit_length: Optional[int] = None,
            return_hidden: bool = False, remat: "bool | str" = False):
    """input_ids [B, S] → (logits [B, S or logit_length, V] f32, aux_loss).

    ``logit_start``/``logit_length`` (host ints): LM head only for
    positions [start, start + length), as the block sampler asks.
    ``return_hidden``: final-norm hidden states instead of logits (shift
    applied).  ``remat=True``: each block is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``remat="dots"``: only
    what is not a no-batch matrix product is (:data:`SAVED_DOTS`)."""
    B, S = input_ids.shape
    plan = tp_plan_of(cfg)
    scope = current_scope()
    if scope is not None and scope.positions is None:
        scope = None   # only a split sequence changes the forward below
    with span("model.embed"):
        x = embed_tokens(params, input_ids, plan)
        positions = (token_positions(attn_mask, B, S, x.device) if scope is None
                     else seq_positions(attn_mask, B, S, scope, x.device))
        cos, sin = rope_angles(positions, cfg.rope_dim, cfg.rope_theta)

    x, aux = run_blocks(cfg, params, x, cos, sin, attn_mask, plan, remat)
    aux = aux / max(cfg.num_layers, 1)
    with span("model.head"):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if scope is not None and logit_start is not None:
            x = gather_from_seq(x, scope.mesh)   # the range may cross slices
            scope = None

        if return_hidden:
            if cfg.logit_shift:
                x = shift_right(x, scope)
            return x, aux
        if logit_start is not None:
            # Shifted-logit families read position i's prediction from hidden
            # state i - 1 (block starts are always > 0).
            start = logit_start - 1 if cfg.logit_shift else logit_start
            x = x[:, start:start + logit_length]
        elif cfg.logit_shift and scope is not None:
            x = shift_right(x, scope)
        logits = lm_head_logits(params, x, cfg)
        if cfg.logit_shift and logit_start is None and scope is None:
            logits = torch.cat([logits[:, :1], logits[:, :-1]], dim=1)
    return logits, aux


def count_pass(input_ids: torch.Tensor) -> None:
    """The tracer's counters of one model call: a pass, and the B·S
    positions it runs (from the shape; no device read)."""
    count("model.forward", 1)
    count("model.positions", input_ids.shape[0] * input_ids.shape[1])


def make_forward_fn(cfg: ModelConfig, device: DeviceLike = None):
    """Return ``f(params, input_ids, attn_mask=None, logit_start=None,
    logit_length=None, *, return_hidden=False) -> (logits, aux)`` running on
    ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, input_ids, attn_mask=None, logit_start=None,
           logit_length=None, *, return_hidden=False):
        with span("model.forward"):
            count_pass(input_ids)
            input_ids = input_ids.to(dev)
            if attn_mask is not None:
                attn_mask = attn_mask.to(dev)
            return forward(cfg, params, input_ids, attn_mask=attn_mask,
                           logit_start=logit_start, logit_length=logit_length,
                           return_hidden=return_hidden)

    return fn
