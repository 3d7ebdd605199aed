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
id, as the TPU kernels took a scalar-prefetched layer id.  Quantized leaves
(``ops/quant.py`` dicts) ride the same way: a stack's ``q`` and ``s`` are
split together, the expert stacks stay whole.

``forward(..., remat=True)`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), for the
trainer; :func:`make_forward_fn` is the inference entry point.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.layers import rms_norm, rope_angles, swiglu
from ct_diffusionmodelbench_tpu_torch.models.moe import moe_block
from ct_diffusionmodelbench_tpu_torch.ops.attention import attention
from ct_diffusionmodelbench_tpu_torch.ops.quant import is_quantized, qdot

EXPERT_STACK_KEYS = ("we_gate", "we_up", "we_down")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    if cfg.is_moe:
        E, Fm = cfg.num_experts, cfg.moe_intermediate_size
        blocks["router"] = dense((L, D, E), D, "router")
        blocks["we_gate"] = dense((L, E, D, Fm), D, "we_gate")
        blocks["we_up"] = dense((L, E, D, Fm), D, "we_up")
        blocks["we_down"] = dense((L, E, Fm, D), Fm, "we_down")
        if cfg.num_shared_experts:
            Fs = Fm * cfg.num_shared_experts
            blocks["ws_gate"] = dense((L, D, Fs), D, "ws_gate")
            blocks["ws_up"] = dense((L, D, Fs), D, "ws_up")
            blocks["ws_down"] = dense((L, Fs, D), Fs, "ws_down")
    else:
        Fd = cfg.intermediate_size
        blocks["w_gate"] = dense((L, D, Fd), D, "w_gate")
        blocks["w_up"] = dense((L, D, Fd), D, "w_up")
        blocks["w_down"] = dense((L, Fd, D), Fd, "w_down")
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


def lm_head_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Hidden states → f32 vocab logits, with the tied-embedding fallback."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return qdot(x, head)


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


def _attn_project(cfg: ModelConfig, h: torch.Tensor, lp: dict):
    """QKV projection: [B, S, D] → q [B, S, H, Dh], k/v [B, S, KV, Dh],
    biased and qk-normed per config, unrotated."""
    B, S, _ = h.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return q, k, v


def _ffn_block(cfg: ModelConfig, x, lp, moe_stacks=None, layer_index=None):
    """Post-attention FFN half of a block: residual stream → (ffn_out, aux)."""
    B, S, D = x.shape
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if cfg.is_moe:
        moe_params = {k: lp[k] for k in
                      ("router", "we_gate", "we_up", "we_down",
                       "ws_gate", "ws_up", "ws_down") if k in lp}
        if moe_stacks is not None:
            moe_params.update(moe_stacks)
        out, aux = moe_block(h.reshape(B * S, D), moe_params,
                             top_k=cfg.num_experts_per_tok,
                             norm_topk=cfg.norm_topk_prob,
                             layer_index=layer_index)
        return out.reshape(B, S, D), aux
    ffn_out = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return ffn_out, torch.zeros((), dtype=torch.float32, device=x.device)


def _block_forward(cfg: ModelConfig, x, lp, cos, sin, mask, moe_stacks=None,
                   layer_index=None):
    """One transformer block. x: [B, S, D]; lp: this layer's params."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_project(cfg, h, lp)
    attn_out = attention(q, k, v, mask=mask, impl=cfg.attn_impl,
                         causal=cfg.causal, rope=(cos, sin))
    o = _project(attn_out.reshape(B, S, cfg.num_heads * cfg.head_dim), lp["wo"])
    x = x + o
    ffn_out, aux = _ffn_block(cfg, x, lp, moe_stacks, layer_index)
    return x + ffn_out, aux


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
    (``torch.utils.checkpoint``, non-reentrant)."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save matmul outputs only) is not ported; use "
            "remat=True or False")
    B, S = input_ids.shape
    embed = params["embed"]
    # The reference gathers with mode="clip": out-of-range ids clamp.
    x = F.embedding(input_ids.clamp(0, embed.shape[0] - 1), embed)
    positions = token_positions(attn_mask, B, S, x.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    blocks = params["blocks"]
    stacks = {k: blocks[k] for k in EXPERT_STACK_KEYS if k in blocks} or None
    layers = {k: _unbind(v) for k, v in blocks.items()
              if k not in EXPERT_STACK_KEYS}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.num_layers):
        lp = {k: v[li] for k, v in layers.items()}
        if remat:
            x, aux_l = checkpoint(_block_forward, cfg, x, lp, cos, sin,
                                  attn_mask, stacks, li, use_reentrant=False)
        else:
            x, aux_l = _block_forward(cfg, x, lp, cos, sin, attn_mask, stacks, li)
        aux = aux + aux_l
    aux = aux / max(cfg.num_layers, 1)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)

    if return_hidden:
        if cfg.logit_shift:
            x = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        return x, aux
    if logit_start is not None:
        # Shifted-logit families read position i's prediction from hidden
        # state i - 1 (block starts are always > 0).
        start = logit_start - 1 if cfg.logit_shift else logit_start
        x = x[:, start:start + logit_length]
    logits = lm_head_logits(params, x)
    if cfg.logit_shift and logit_start is None:
        logits = torch.cat([logits[:, :1], logits[:, :-1]], dim=1)
    return logits, aux


def make_forward_fn(cfg: ModelConfig, device: DeviceLike = None):
    """Return ``f(params, input_ids, attn_mask=None, logit_start=None,
    logit_length=None, *, return_hidden=False) -> (logits, aux)`` running on
    ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, input_ids, attn_mask=None, logit_start=None,
           logit_length=None, *, return_hidden=False):
        input_ids = input_ids.to(dev)
        if attn_mask is not None:
            attn_mask = attn_mask.to(dev)
        return forward(cfg, params, input_ids, attn_mask=attn_mask,
                       logit_start=logit_start, logit_length=logit_length,
                       return_hidden=return_hidden)

    return fn
