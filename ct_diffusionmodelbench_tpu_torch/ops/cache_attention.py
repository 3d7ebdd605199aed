"""K12: one block of queries against an exact KV cache (the SDAR family's
cached step and commit), its CUDA kernel and plain version.

No TPU kernel is replaced: the JAX package has no block-causal family and
no exact cache (its dual cache's rectangular attention is the plain
reference attention).  ``csrc/cache_attention.cu`` has the design: the bl
positions times the query heads of one kv head are packed into one tile of
at most 32 rows, so each key and value of the cache is read once per row
and kv head.

:func:`cache_attention` ``(q, k_cache, v_cache, key_start, key_end)``: q
``[B, bl, H, Dh]`` bf16, rotated; ``k_cache`` / ``v_cache`` ``[B, S, KV,
Dh]`` (one layer of the cache, k rotated); ``key_start`` int32 ``[B]``,
each row's first real key; ``key_end`` int32 ``[1]`` on the same device:
row b attends to keys ``key_start[b] .. key_end - 1`` (every one of them
real: the block's own keys are the last bl, written by the caller before
the call).  The kernel reads ``key_end`` from device memory, so a CUDA
graph of a pass replays at any block.  Scores and the softmax in
f32, P rounded to bf16 for P·V summed in f32, divided by the f32 sum of P,
out in q's dtype.  A CPU tensor takes :func:`cache_attention_plain`, a CUDA
tensor launches the kernel (launch counter ``cache_attention``) or raises.
"""

from __future__ import annotations

import torch

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import FLOAT, INT, PTR, Kernel, Library
from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import HEAD_DIMS, check_operand

MAX_ROWS = 32   # the kernel's packed query rows: bl · (H / KV) at most

LIBRARY = Library("cache_attention.cu")
CACHE_KERNEL = Kernel("cache_attention", LIBRARY, "ctdb_cache_attention",
                      [PTR] * 6 + [INT] * 6 + [FLOAT, PTR])


def cache_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          key_start: torch.Tensor, key_end: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch (it reads ``key_end`` on the host)."""
    b, bl, h, dh = q.shape
    n_keys = int(key_end)
    kv = k_cache.shape[2]
    k = k_cache[:, :n_keys].repeat_interleave(h // kv, dim=2).float()
    v = v_cache[:, :n_keys].repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * dh ** -0.5
    seen = torch.arange(n_keys, device=q.device)[None, :] >= key_start.long()[:, None]
    scores = torch.where(seen[:, None, None, :], scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)                                           # [B, H, bl]
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (pv / l.permute(0, 2, 1)[..., None]).to(q.dtype)


def cache_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         key_start: torch.Tensor, key_end: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/cache_attention.cu`` (bf16 operands on one card)."""
    b, bl, h, dh = q.shape
    _, s, kv, _ = k_cache.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"cache_attention_cuda needs CUDA tensors, got {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if h % kv or bl * (h // kv) > MAX_ROWS:
        raise ValueError(f"{bl} positions x {h} // {kv} heads do not pack into "
                         f"{MAX_ROWS} query rows")
    check_operand("q", q, (b, bl, h, dh), torch.bfloat16, dev)
    check_operand("k_cache", k_cache, (b, s, kv, dh), torch.bfloat16, dev)
    check_operand("v_cache", v_cache, (b, s, kv, dh), torch.bfloat16, dev)
    check_operand("key_start", key_start, (b,), torch.int32, dev)
    check_operand("key_end", key_end, (1,), torch.int32, dev)
    out = torch.empty_like(q)
    CACHE_KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), key_start.data_ptr(),
                 key_end.data_ptr(), out.data_ptr(), b, s, bl, h, kv, dh, dh ** -0.5,
                 torch.cuda.current_stream(dev).cuda_stream)
    return out


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    key_start: torch.Tensor, key_end: torch.Tensor) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return cache_attention_plain(q, k_cache, v_cache, key_start, key_end)
    return cache_attention_cuda(q, k_cache, v_cache, key_start, key_end)
