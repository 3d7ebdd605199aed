"""Multi-head latent attention (DeepSeek-V3's MLA, without a low-rank q).

Per layer, on the normed residual h [B, S, D] (``cfg.kv_lora_rank`` R,
``cfg.qk_nope_head_dim`` N, ``cfg.qk_rope_head_dim`` P, ``cfg.v_head_dim``
V, H heads):

- q = h ``wq`` [B, S, H, N + P]: each head's nope part, then its rope part;
- h ``wkv_a`` [B, S, R + P]: the latent c (RMSNorm'd by ``kv_norm``) and
  one rope key k_pe shared by every head;
- c ``wkv_b`` [B, S, H, N + V]: each head's nope key and value;
- scores (q_nope · k_nope + rot(q_pe) · rot(k_pe)) · (N + P)^-½; the
  output [B, S, H, V] goes through ``wo``.

:func:`project` is the projection that ``models/transformer.py::block``
runs for an MLA model: it hands the pass's attention q and the latent row
``[c | k_pe]`` (unrotated), and no v.  Each pass's attention then rotates
(:func:`rotate`), and

- the full forward and SDAR's prefill (``models/sdar_cache.py``) take the
  up-projected form, :func:`up_attention`: every head's key and value from
  c, then K8's block-causal mode at q/k heads of N + P and v heads of V
  (``ops/mla_attention.py::mla_prefill_attention``);
- SDAR's cached step and commit take the absorbed form,
  :func:`absorbed_attention`: q_nope · W_UK into the latent space, K13
  (``ops/mla_attention.py::mla_cache_attention``) over the cache's latent
  rows (R + P values a key, R of them the value), then · W_UV.  The cache
  holds the latent rows alone: R + P values a token a layer.

Left padding only (the runner's): a row's real keys are ``key_start[b]
..``, and a query before ``key_start[b]`` sees none (its output is zero).

The published weights pair the rope dims (2i, 2i + 1) (``rope_interleave``);
:func:`interleaved_to_halves` permutes those columns of ``wq`` and
``wkv_a`` once at load, so the port's rotate-half RoPE
(``models/layers.py::apply_rope``) gives the same scores (a permutation of
both q_pe and k_pe leaves every dot product as it was).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rms_norm
from ct_diffusionmodelbench_tpu_torch.ops.mla_attention import (
    mla_cache_attention, mla_prefill_attention)


def halves_order(n: int) -> torch.Tensor:
    """The columns of an interleaved rope part in rotate-half order: the
    even dims, then the odd ones."""
    return torch.cat([torch.arange(0, n, 2), torch.arange(1, n, 2)])


@torch.no_grad()
def interleaved_to_halves(cfg: ModelConfig, params: dict) -> dict:
    """A tree whose ``wq`` (each head's last P columns) and ``wkv_a`` (its
    last P) have their rope columns moved from the published pairs (2i,
    2i + 1) to halves; every other leaf is shared with ``params``, which is
    left as it was.  ``params`` itself unless ``cfg.rope_interleave``."""
    if not cfg.rope_interleave:
        return params
    blocks = dict(params["blocks"])
    n, p, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    order = halves_order(p).to(blocks["wq"].device)
    wq = blocks["wq"].clone()
    heads = wq.view(*wq.shape[:-1], cfg.num_heads, n + p)
    heads[..., n:] = heads[..., n:].index_select(-1, order)
    wkv_a = blocks["wkv_a"].clone()
    wkv_a[..., r:] = wkv_a[..., r:].index_select(-1, order)
    blocks.update(wq=wq, wkv_a=wkv_a)
    return {**params, "blocks": blocks}


def project(cfg: ModelConfig, h: torch.Tensor, lp: dict) -> Tuple:
    """(q [B, S, H, N + P], the latent row [B, S, R + P] with c normed and
    k_pe unrotated, None): the layer's projections (bf16 weights: the
    family takes no int8)."""
    B, S, _ = h.shape
    r = cfg.kv_lora_rank
    q = torch.matmul(h, lp["wq"]).reshape(B, S, cfg.num_heads, cfg.qk_head_dim)
    lat = torch.matmul(h, lp["wkv_a"])
    c = rms_norm(lat[..., :r], lp["kv_norm"], cfg.norm_eps)
    return q, torch.cat([c, lat[..., r:]], dim=-1), None


def rotate(cfg: ModelConfig, q: torch.Tensor, lat: torch.Tensor, cos, sin):
    """(rot(q_pe) [B, S, H, P], the latent row with k_pe rotated)."""
    n, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_pe = apply_rope(q[..., n:], cos, sin)
    k_pe = apply_rope(lat[:, :, None, r:], cos, sin)[:, :, 0]
    return q_pe, torch.cat([lat[..., :r], k_pe], dim=-1)


def scale(cfg: ModelConfig) -> float:
    return cfg.qk_head_dim ** -0.5


def key_starts(attn_mask, B: int, S: int, device) -> torch.Tensor:
    """int32 [B]: each left-padded row's first real position."""
    if attn_mask is None:
        return torch.zeros((B,), dtype=torch.int32, device=device)
    return S - attn_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def up_attention(cfg: ModelConfig, q: torch.Tensor, q_pe: torch.Tensor, lat: torch.Tensor,
                 wkv_b: torch.Tensor, key_start: torch.Tensor) -> torch.Tensor:
    """The up-projected form over the rows' own latent rows: [B, S, H, V]."""
    B, S, H, _ = q.shape
    n, r, v_dim = cfg.qk_nope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim
    kv = torch.matmul(lat[..., :r], wkv_b).view(B, S, H, n + v_dim)
    k_pe = lat[:, :, None, r:].expand(B, S, H, cfg.qk_rope_head_dim)
    qf = torch.cat([q[..., :n], q_pe], dim=-1)
    kf = torch.cat([kv[..., :n], k_pe], dim=-1)
    return mla_prefill_attention(qf, kf, kv[..., n:].contiguous(), key_start,
                                 cfg.block_length, scale(cfg))


def absorbed_weights(cfg: ModelConfig, wkv_b: torch.Tensor):
    """(W_UK [L, H, N, R], W_UV [L, H, R, V]) of the stacked ``wkv_b`` [L, R,
    H·(N + V)], contiguous: q_nope · W_UK[h] is head h's query in the latent
    space, o_lat · W_UV[h] its output."""
    L, r, _ = wkv_b.shape
    n = cfg.qk_nope_head_dim
    w = wkv_b.view(L, r, cfg.num_heads, n + cfg.v_head_dim)
    return (w[..., :n].permute(0, 2, 3, 1).contiguous(),
            w[..., n:].permute(0, 2, 1, 3).contiguous())


def absorbed_attention(cfg: ModelConfig, q: torch.Tensor, q_pe: torch.Tensor,
                       cache: torch.Tensor, key_start: torch.Tensor, key_end: torch.Tensor,
                       w_uk: torch.Tensor, w_uv: torch.Tensor) -> torch.Tensor:
    """The absorbed form of a block q [B, bl, H, N + P] against one layer's
    latent cache [B, S, R + P] (keys ``key_start[b] .. key_end - 1``):
    [B, bl, H, V]."""
    B, bl, H, _ = q.shape
    n = cfg.qk_nope_head_dim
    q_nope = q[..., :n].reshape(B * bl, H, n).transpose(0, 1)          # [H, M, N]
    q_lat = torch.bmm(q_nope, w_uk).transpose(0, 1)                    # [M, H, R]
    qf = torch.cat([q_lat, q_pe.reshape(B * bl, H, -1)], dim=-1).view(B, bl, H, -1)
    o_lat = mla_cache_attention(qf, cache, key_start, key_end, cfg.kv_lora_rank, scale(cfg))
    o = torch.bmm(o_lat.view(B * bl, H, -1).transpose(0, 1), w_uv)     # [H, M, V]
    return o.transpose(0, 1).reshape(B, bl, H, cfg.v_head_dim)


def prefill_pairs(lengths: List[int], P: int, bl: int) -> int:
    """Query-key pairs of a block-causal prefill over real keys alone: a
    row of ``n`` real tokens left-padded to ``P`` (a multiple of ``bl``)
    has its query at padded position i see keys P - n .. (i // bl + 1)·bl."""
    total = 0
    for n in lengths:
        ks = P - n
        for b0 in range(ks // bl * bl, P, bl):
            q = min(b0 + bl, P) - max(b0, ks)
            total += q * (b0 + bl - ks)
    return total


class Absorbed:
    """Each layer's (W_UK, W_UV) views of a parameter tree's ``wkv_b``,
    built once per tree (kept by the weights' address and shape)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.built: Dict[tuple, tuple] = {}

    def __call__(self, params: dict):
        w = params["blocks"]["wkv_b"]
        key = (w.data_ptr(), tuple(w.shape), w.dtype)
        if key not in self.built:
            uk, uv = absorbed_weights(self.cfg, w)
            self.built = {key: (torch.unbind(uk), torch.unbind(uv))}
        return self.built[key]
