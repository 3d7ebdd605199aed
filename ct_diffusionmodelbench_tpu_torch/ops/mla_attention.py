"""Multi-head latent attention's two kernels (``models/mla.py``), each with
its plain version.  No TPU kernel is replaced: the JAX package has no
latent attention.

- :func:`mla_prefill_attention` (K8's block-causal design at q/k heads of
  192 and v heads of 128, ``csrc/mla_attention.cu``, launch counter
  ``mla_prefill_attention``): the prefill's up-projected form.  q, k ``[B,
  S, H, Dqk]``, v ``[B, S, H, Dv]`` bf16, rotated; row b's keys are
  ``key_start[b] .. S - 1`` (left padding before them is never read);
  query i sees keys j < (i // block_len + 1) · block_len.  A query that
  sees no key (a padding position in a block before the row's first real
  one) gets zeros.
- :func:`mla_cache_attention` (K13, the absorbed form over the latent
  cache, launch counter ``mla_cache_attention``): q ``[B, bl, H, R + P]``
  (each head's query in the latent space, then its rotated rope part)
  against one layer's latent cache ``[B, S, R + P]`` (c, then the rotated
  rope key), keys ``key_start[b] .. key_end - 1``; the value of a key is
  its first ``value_dim`` (R) values.  Out ``[B, bl, H, R]``.
  ``key_end`` is an int32 ``[1]`` read from device memory, so a CUDA graph
  of a pass replays at any block.

Both compute the scores and the softmax in f32, round P to bf16 for P·V
summed in f32, divide by the f32 sum of P, and return q's dtype.  A CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import FLOAT, INT, PTR, Kernel, Library
from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import check_operand

PREFILL_DIMS = ((192, 128),)     # (q/k head dim, v head dim) the kernel is built for
CACHE_DIMS = ((576, 512),)       # (latent key width R + P, value width R)
SPLITS = 16                      # K13's key splits a row (csrc/mla_attention.cu)
ROW_TILE = 64                    # K13's query rows a block

LIBRARY = Library("mla_attention.cu")
PREFILL_KERNEL = Kernel("mla_prefill_attention", LIBRARY, "ctdb_mla_prefill_attention",
                        [PTR] * 5 + [INT] * 6 + [FLOAT, PTR])
CACHE_KERNEL = Kernel("mla_cache_attention", LIBRARY, "ctdb_mla_cache_attention",
                      [PTR] * 7 + [INT] * 6 + [FLOAT, PTR])


def _softmax_pv(scores: torch.Tensor, seen: torch.Tensor, v: torch.Tensor,
                spec: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P·V in f32, the f32 sum of P): the f32 softmax numerators of
    ``scores`` over the keys ``seen`` marks, P rounded to v's dtype for the
    product; a row that sees no key has P zero."""
    scores = torch.where(seen, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum(spec, p.to(v.dtype).float(), v.float())
    return pv, l


def mla_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                key_start: torch.Tensor, block_len: int,
                                scale: float) -> torch.Tensor:
    """The prefill kernel's function in PyTorch."""
    b, s, h, _ = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    end = (pos // block_len + 1) * block_len
    seen = (pos[None, None, :] < end[None, :, None]) & (
        pos[None, None, :] >= key_start.long()[:, None, None])            # [B, q, k]
    pv, l = _softmax_pv(scores, seen[:, None], v, "bhqk,bkhd->bqhd")
    l = l[..., 0].permute(0, 2, 1)[..., None]                              # [B, q, H, 1]
    return (pv / torch.clamp_min(l, 1e-30)).to(q.dtype)


def mla_cache_attention_plain(q: torch.Tensor, cache: torch.Tensor, key_start: torch.Tensor,
                              key_end: torch.Tensor, value_dim: int,
                              scale: float) -> torch.Tensor:
    """K13's function in PyTorch (it reads ``key_end`` on the host)."""
    n_keys = int(key_end)
    keys = cache[:, :n_keys]
    scores = torch.einsum("bqhd,bkd->bhqk", q.float(), keys.float()) * scale
    seen = torch.arange(n_keys, device=q.device)[None, :] >= key_start.long()[:, None]
    pv, l = _softmax_pv(scores, seen[:, None, None, :], keys[..., :value_dim],
                        "bhqk,bkd->bqhd")
    l = l[..., 0].permute(0, 2, 1)[..., None]
    return (pv / torch.clamp_min(l, 1e-30)).to(q.dtype)


def mla_prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               key_start: torch.Tensor, block_len: int,
                               scale: float) -> torch.Tensor:
    """Launch the prefill kernel (bf16 operands on one card)."""
    b, s, h, dqk = q.shape
    dv = v.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mla_prefill_attention_cuda needs CUDA tensors, got {dev}")
    if (dqk, dv) not in PREFILL_DIMS:
        raise ValueError(f"head dims ({dqk}, {dv}) not in {PREFILL_DIMS}")
    if block_len < 1:
        raise ValueError(f"block_len must be at least 1, got {block_len}")
    check_operand("q", q, (b, s, h, dqk), torch.bfloat16, dev)
    check_operand("k", k, (b, s, h, dqk), torch.bfloat16, dev)
    check_operand("v", v, (b, s, h, dv), torch.bfloat16, dev)
    check_operand("key_start", key_start, (b,), torch.int32, dev)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    PREFILL_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_start.data_ptr(),
                   out.data_ptr(), b, s, h, dqk, dv, block_len, scale,
                   torch.cuda.current_stream(dev).cuda_stream)
    return out


def mla_cache_attention_cuda(q: torch.Tensor, cache: torch.Tensor, key_start: torch.Tensor,
                             key_end: torch.Tensor, value_dim: int,
                             scale: float) -> torch.Tensor:
    """Launch K13 (bf16 operands on one card): its split blocks write f32
    partial outputs and log-sum-exps into scratch, its merge the output."""
    b, bl, h, dq = q.shape
    s = cache.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mla_cache_attention_cuda needs CUDA tensors, got {dev}")
    if (dq, value_dim) not in CACHE_DIMS:
        raise ValueError(f"latent widths ({dq}, {value_dim}) not in {CACHE_DIMS}")
    check_operand("q", q, (b, bl, h, dq), torch.bfloat16, dev)
    check_operand("cache", cache, (b, s, dq), torch.bfloat16, dev)
    check_operand("key_start", key_start, (b,), torch.int32, dev)
    check_operand("key_end", key_end, (1,), torch.int32, dev)
    rows = -(-bl * h // ROW_TILE) * ROW_TILE
    part_o = torch.empty((b, SPLITS, rows, value_dim), dtype=torch.float32, device=dev)
    part_lse = torch.empty((b, SPLITS, rows), dtype=torch.float32, device=dev)
    out = torch.empty((b, bl, h, value_dim), dtype=q.dtype, device=dev)
    CACHE_KERNEL(q.data_ptr(), cache.data_ptr(), key_start.data_ptr(), key_end.data_ptr(),
                 part_o.data_ptr(), part_lse.data_ptr(), out.data_ptr(), b, s, bl * h, dq,
                 value_dim, SPLITS, scale, torch.cuda.current_stream(dev).cuda_stream)
    return out


def mla_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_start: torch.Tensor, block_len: int,
                          scale: float) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return mla_prefill_attention_plain(q, k, v, key_start, block_len, scale)
    return mla_prefill_attention_cuda(q, k, v, key_start, block_len, scale)


def mla_cache_attention(q: torch.Tensor, cache: torch.Tensor, key_start: torch.Tensor,
                        key_end: torch.Tensor, value_dim: int, scale: float) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return mla_cache_attention_plain(q, cache, key_start, key_end, value_dim, scale)
    return mla_cache_attention_cuda(q, cache, key_start, key_end, value_dim, scale)
