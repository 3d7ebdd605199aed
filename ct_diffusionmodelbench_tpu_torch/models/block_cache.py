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

Both passes are built from ``models/transformer.py``'s helpers (positions,
embedding, projections with int8 leaves, the FFN with the whole expert
stacks and the layer id, the LM head), so they and the exact forward
cannot drift apart.  The refresh's attention takes the rotated q/k without
``rope`` (the flash kernel with no fused rotation on a CUDA tensor); the
cached step's rectangular attention (block queries × S keys) is the plain
``attention_reference``, as in the reference.

With the tracer on (``utils/profiling.py``), each refresh and each cached
step is a ``model.forward`` span, counted as one pass over the positions
it runs (B·S for a refresh, B·block_length for a cached step).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rms_norm, rope_angles
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    _attn_project, _ffn_block, _project, count_pass, embed_tokens, lm_head_logits,
    split_layers, token_positions)
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


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    return lm_head_logits(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def forward_refresh(cfg: ModelConfig, params: dict, input_ids: torch.Tensor,
                    attn_mask: Optional[torch.Tensor], block_start: int,
                    block_length: int):
    """Full forward that returns the active block's logits [B, bl, V] f32
    and every layer's rotated K and V, each [L, B, S, KV, Dh].
    ``block_start`` / ``block_length`` are host ints."""
    B, S = input_ids.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = embed_tokens(params, input_ids)
    cos, sin = rope_angles(token_positions(attn_mask, B, S, x.device), Dh,
                           cfg.rope_theta)
    layers, stacks = split_layers(cfg, params)
    k_cache = torch.empty((cfg.num_layers, B, S, KV, Dh), dtype=x.dtype, device=x.device)
    v_cache = torch.empty_like(k_cache)
    for li, lp in enumerate(layers):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _attn_project(cfg, h, lp)
        # The cache holds ROTATED k: positions are absolute and fixed, so a
        # cached step never rotates it again.
        qr = apply_rope(q, cos, sin)
        kr = apply_rope(k, cos, sin)
        k_cache[li] = kr
        v_cache[li] = v
        attn = attention(qr, kr, v, mask=attn_mask, impl=cfg.attn_impl)
        x = x + _project(attn.reshape(B, S, H * Dh), lp["wo"])
        ffn, _ = _ffn_block(cfg, x, lp, stacks, li)
        x = x + ffn
    xb = x[:, block_start:block_start + block_length]
    return _lm_head(cfg, params, xb), k_cache, v_cache


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
    H, Dh = cfg.num_heads, cfg.head_dim
    x = embed_tokens(params, block_ids)
    pos = token_positions(attn_mask, B, S, x.device)[:, block_start:block_start + bl]
    cos, sin = rope_angles(pos, Dh, cfg.rope_theta)
    layers, stacks = split_layers(cfg, params)
    for li, lp in enumerate(layers):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _attn_project(cfg, h, lp)
        kc, vc = k_cache[li], v_cache[li]
        k_full = torch.cat([kc[:, :block_start], apply_rope(k, cos, sin),
                            kc[:, block_start + bl:]], dim=1)
        v_full = torch.cat([vc[:, :block_start], v, vc[:, block_start + bl:]], dim=1)
        attn = attention_reference(apply_rope(q, cos, sin), k_full, v_full,
                                   mask=attn_mask)
        x = x + _project(attn.reshape(B, bl, H * Dh), lp["wo"])
        ffn, _ = _ffn_block(cfg, x, lp, stacks, li)
        x = x + ffn
    return _lm_head(cfg, params, x)


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
