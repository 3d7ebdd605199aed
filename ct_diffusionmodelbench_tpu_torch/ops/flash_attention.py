"""Bidirectional flash attention: the CUDA kernel and its plain version.

Counterpart of ``ops/flash_attention.py::flash_attention`` (forward only; the
lse output and the backward belong to the training slice).  The kernel is
``csrc/flash_attention.cu``; :func:`flash_attention_plain` computes the same
function in PyTorch.  A CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.

Semantics kept from the reference: q/k arrive unrotated with
``rope=(cos, sin)`` and are rotated in f32 then cast; scores and the softmax
run in f32; probabilities are cast to the value dtype for P·V; query head h
reads kv head h // rep; the [B, S] mask becomes an additive −1e30 bias; keys
are padded to the reference's kv tile (``_tiles``) as zero keys with bias
−1e30, which only matters for a row whose every key is masked.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import (
    FLOAT, INT, PTR, Kernel, Library)

NEG_INF = -1e30
TILE_K = 512  # the reference's default kv tile (ops/flash_attention.py)
HEAD_DIMS = (16, 32, 64, 128)

LIBRARY = Library("flash_attention.cu")
FLASH_KERNEL = Kernel("flash_attention_fwd", LIBRARY, "ctdb_flash_attention_fwd",
                      [PTR] * 7 + [INT] * 6 + [FLOAT, PTR])


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def kv_tile_len(s: int) -> int:
    """Key length after the reference's padding (``_tiles``' sk_pad)."""
    tk = _round_up(s, 128) if s <= 2 * TILE_K else TILE_K
    return _round_up(s, tk)


def mask_bias(mask: Optional[torch.Tensor], b: int, s: int,
              device: torch.device) -> torch.Tensor:
    """[B, S] f32 additive bias: 0 for a real key, −1e30 for padding."""
    if mask is None:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    return torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """The kernel's function in PyTorch: q [B, S, H, Dh], k/v [B, S, KV, Dh]
    → [B, S, H, Dh] in q.dtype."""
    # Imported here: models/__init__ imports the transformer, which imports
    # this module.
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope

    b, s, h, dh = q.shape
    kv = k.shape[2]
    rep = h // kv
    sk = kv_tile_len(s)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    bias = torch.full((b, sk), NEG_INF, dtype=torch.float32, device=q.device)
    bias[:, :s] = mask_bias(mask, b, s, q.device)
    kp = torch.zeros((b, sk, kv, dh), dtype=k.dtype, device=k.device)
    vp = torch.zeros((b, sk, kv, dh), dtype=v.dtype, device=v.device)
    kp[:, :s] = k
    vp[:, :s] = v
    kr = kp.repeat_interleave(rep, dim=2)
    vr = vp.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * dh ** -0.5
    scores = scores + bias[:, None, None, :]
    m = torch.clamp_min(scores.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)                                          # [B, H, Sq]
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    out = pv / torch.clamp_min(l, 1e-30).permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` (bf16 q/k/v on one card)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if h % kv:
        raise ValueError(f"{h} query heads do not group onto {kv} kv heads")
    _check("q", q, (b, s, h, dh), torch.bfloat16, dev)
    _check("k", k, (b, s, kv, dh), torch.bfloat16, dev)
    _check("v", v, (b, s, kv, dh), torch.bfloat16, dev)
    bias = mask_bias(mask, b, s, dev)
    _check("bias", bias, (b, s), torch.float32, dev)
    cos_ptr = sin_ptr = None
    if rope is not None:
        cos, sin = rope
        _check("cos", cos, (b, s, dh // 2), torch.float32, dev)
        _check("sin", sin, (b, s, dh // 2), torch.float32, dev)
        cos_ptr, sin_ptr = cos.data_ptr(), sin.data_ptr()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    FLASH_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 cos_ptr, sin_ptr, out.data_ptr(), b, s, kv_tile_len(s), h, kv,
                 dh, dh ** -0.5, stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """q: [B, S, H, Dh]; k, v: [B, S, KV, Dh]; mask: [B, S] (1 = real);
    ``rope=(cos, sin)`` each [B, S, Dh//2] f32, applied inside.

    CPU tensors take :func:`flash_attention_plain`; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask=mask, rope=rope)
    return flash_attention_cuda(q, k, v, mask=mask, rope=rope)
