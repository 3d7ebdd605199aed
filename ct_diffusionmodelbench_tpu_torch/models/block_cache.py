"""Dual KV-cache block decoding (Fast-dLLM "DualCache").

Counterpart of ``models/block_cache.py``.  Within a block of the LLaDA
sampler every position outside the block is frozen: the prompt and earlier
blocks hold their final tokens, later blocks stay all mask.  So at each
block start one full forward (:func:`forward_refresh`) rebuilds every
layer's rotated K and V for the whole sequence, and the block's other steps
(:func:`forward_cached_step`) forward only the block's tokens, whose
queries attend over the cache with the block's slice replaced by this
step's fresh K/V.  Per-step rows through every product drop from B·S to
B·block_length.

Approximation contract (as the reference's): exact for a 1-layer model
(layer-0 K/V depend only on each position's own token) and with
``steps_per_block == 1`` (every step refreshes); for deeper models the
frozen positions' K/V are stale by up to ``steps_per_block - 1`` steps.
Dream/DiffuCoder (shifted logits) and causal models are refused.

Both passes run ``models/transformer.py``'s embedding, layer body
(:func:`~ct_diffusionmodelbench_tpu_torch.models.transformer.block`) and
head, so they and the exact forward cannot drift apart; each brings only
its attention.  The refresh's rotates q/k, writes the rotated K and V into
the cache and attends without ``rope`` (the flash kernel with no fused
rotation on a CUDA tensor); the cached step's rectangular attention (block
queries × S keys) is the plain ``attention_reference``, as in the
reference.

With the tracer on (``utils/profiling.py``), each refresh and each cached
step is a ``model.forward`` span, counted as one pass over the positions
it runs (B·S for a refresh, B·block_length for a cached step), with
``model.embed``, ``model.attn`` and ``model.ffn`` a layer, and
``model.head`` inside, as the full forward's.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rope_angles
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    block, count_pass, embed_tokens, final_logits, split_layers, token_positions)
from ct_diffusionmodelbench_tpu_torch.ops.attention import attention, attention_reference
from ct_diffusionmodelbench_tpu_torch.utils.profiling import span


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.logit_shift:
        raise NotImplementedError(
            "block-cache decode does not support shifted-logit families "
            "(Dream/DiffuCoder) — use the exact sampler")
    if cfg.causal:
        raise NotImplementedError("block-cache decode is for diffusion "
                                  "(bidirectional) models only")
    if cfg.block_length:
        raise NotImplementedError("block-causal models (SDAR) keep an exact cache "
                                  "of their own: models/sdar_cache.py")


def forward_refresh(cfg: ModelConfig, params: dict, input_ids: torch.Tensor,
                    attn_mask: Optional[torch.Tensor], block_start: int,
                    block_length: int):
    """Full forward that returns the active block's logits [B, bl, V] f32
    and every layer's rotated K and V, each [L, B, S, KV, Dh].
    ``block_start`` / ``block_length`` are host ints."""
    B, S = input_ids.shape
    with span("model.embed"):
        x = embed_tokens(params, input_ids)
        cos, sin = rope_angles(token_positions(attn_mask, B, S, x.device),
                               cfg.head_dim, cfg.rope_theta)
    k_cache = torch.empty((cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim),
                          dtype=x.dtype, device=x.device)
    v_cache = torch.empty_like(k_cache)

    def attend(li, q, k, v):
        # The cache holds ROTATED k: positions are absolute and fixed, so a
        # cached step never rotates it again.
        qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        k_cache[li] = kr
        v_cache[li] = v
        return attention(qr, kr, v, mask=attn_mask, impl=cfg.attn_impl)

    layers, stacks = split_layers(cfg, params)
    for li, lp in enumerate(layers):
        x, _ = block(cfg, x, lp, li, attend, stacks)
    xb = x[:, block_start:block_start + block_length]
    return final_logits(cfg, params, xb), k_cache, v_cache


def forward_cached_step(cfg: ModelConfig, params: dict, block_ids: torch.Tensor,
                        block_start: int, k_cache: torch.Tensor,
                        v_cache: torch.Tensor,
                        attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Block-only forward against the dual cache: ``block_ids`` [B, bl] are
    the block's current tokens, queries sit at the block's positions, keys
    and values are the cache with the block's slice replaced by this step's
    fresh projections (the cache itself is not updated).  Returns the
    block's logits [B, bl, V] f32."""
    B, bl = block_ids.shape
    S = k_cache.shape[2]
    with span("model.embed"):
        x = embed_tokens(params, block_ids)
        pos = token_positions(attn_mask, B, S, x.device)[:, block_start:block_start + bl]
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)

    def attend(li, q, k, v):
        kc, vc = k_cache[li], v_cache[li]
        k_full = torch.cat([kc[:, :block_start], apply_rope(k, cos, sin),
                            kc[:, block_start + bl:]], dim=1)
        v_full = torch.cat([vc[:, :block_start], v, vc[:, block_start + bl:]], dim=1)
        return attention_reference(apply_rope(q, cos, sin), k_full, v_full,
                                   mask=attn_mask)

    layers, stacks = split_layers(cfg, params)
    for li, lp in enumerate(layers):
        x, _ = block(cfg, x, lp, li, attend, stacks)
    return final_logits(cfg, params, x)


@functools.lru_cache(maxsize=None)
def make_cached_fns(cfg: ModelConfig):
    """``(refresh_fn, step_fn, init_cache_fn)`` for the sampler, memoized
    per (frozen, hashable) config, as the reference's:

    - ``refresh_fn(params, x, attn_mask, block_start, block_length)`` →
      (block logits, k_cache, v_cache);
    - ``step_fn(params, block_ids, block_start, k_cache, v_cache,
      attn_mask)`` → block logits;
    - ``init_cache_fn(params, B, S)`` → zeroed (k_cache, v_cache) of the
      cache's shape (the reference's loop carry; the port's loop starts
      every block with a refresh and needs none)."""
    _check_supported(cfg)

    def refresh_fn(params, x, attn_mask, block_start, block_length):
        with span("model.forward"):
            count_pass(x)
            return forward_refresh(cfg, params, x, attn_mask, block_start, block_length)

    def step_fn(params, block_ids, block_start, k_cache, v_cache, attn_mask):
        with span("model.forward"):
            count_pass(block_ids)
            return forward_cached_step(cfg, params, block_ids, block_start, k_cache,
                                       v_cache, attn_mask)

    def init_cache_fn(params, B, S):
        shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
        dt, dev = params["embed"].dtype, params["embed"].device
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    return refresh_fn, step_fn, init_cache_fn
