"""Bidirectional flash attention: the CUDA kernel, its plain version and
the autograd wrapper.

Counterpart of ``ops/flash_attention.py::flash_attention``.  Two kernels
compute the same function: ``csrc/flash_attention.cu`` (online softmax over
64-key tiles, the reference's ``_flash_kernel``) and
``csrc/flash_attention_direct.cu`` (one direct softmax over all keys, the
reference's ``_flash_kernel_direct``), which a call takes when
``CTDB_FLASH_DIRECT=1`` and its keys fit one kv tile (S <= 1024), as
``_run_forward`` does; the switch is read per call.
:func:`flash_attention_plain` computes the function in PyTorch.  A CPU
tensor takes the plain version, a CUDA tensor launches a kernel or raises.
With ``with_lse`` all three also return the per-row log-sum-exp [B, H, S]
f32 that the backward reads.

When grad is enabled and q, k or v requires it, :func:`flash_attention`
goes through :class:`FlashAttention` (the reference's ``custom_vjp``): its
forward saves lse, its backward re-rotates q/k, runs
``ops/flash_attention_bwd.py::flash_attention_bwd`` and rotates dq/dk back
through the inverse rotation in f32 before the cast.  Bias (mask) and the
RoPE tables get no gradient.

Semantics kept from the reference: q/k arrive unrotated with
``rope=(cos, sin)`` and are rotated in f32 then cast; scores and the softmax
run in f32; probabilities are cast to the value dtype for P·V; query head h
reads kv head h // rep; the [B, S] mask becomes an additive −1e30 bias; keys
are padded to the reference's kv tile (``_tiles``) as zero keys with bias
−1e30, which only matters for a row whose every key is masked.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import (
    FLOAT, INT, PTR, Kernel, Library)

NEG_INF = -1e30
TILE_K = 512  # the reference's default kv tile (ops/flash_attention.py)
HEAD_DIMS = (16, 32, 64, 128)

LIBRARY = Library("flash_attention.cu")
FLASH_KERNEL = Kernel("flash_attention_fwd", LIBRARY, "ctdb_flash_attention_fwd",
                      [PTR] * 8 + [INT] * 6 + [FLOAT, PTR])
LIBRARY_DIRECT = Library("flash_attention_direct.cu")
DIRECT_KERNEL = Kernel("flash_attention_direct", LIBRARY_DIRECT,
                       "ctdb_flash_attention_direct", [PTR] * 8 + [INT] * 6 + [FLOAT, PTR])

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def kv_tile_len(s: int) -> int:
    """Key length after the reference's padding (``_tiles``' sk_pad)."""
    tk = _round_up(s, 128) if s <= 2 * TILE_K else TILE_K
    return _round_up(s, tk)


def direct_mode() -> bool:
    """``CTDB_FLASH_DIRECT``: "1" takes the direct kernel on every call with
    one kv tile; anything else, or unset, leaves it off (the reference's
    ``_direct_mode``)."""
    return os.environ.get("CTDB_FLASH_DIRECT", "auto").strip().lower() == "1"


def single_kv_tile(s: int) -> bool:
    """The keys of a length-``s`` call fit one kv tile (``_tiles``' sk_pad
    == tk)."""
    return s <= 2 * TILE_K


def mask_bias(mask: Optional[torch.Tensor], b: int, s: int,
              device: torch.device) -> torch.Tensor:
    """[B, S] f32 additive bias: 0 for a real key, −1e30 for padding."""
    if mask is None:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    return torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, rope: Rope = None,
                          with_lse: bool = False):
    """The kernel's function in PyTorch: q [B, S, H, Dh], k/v [B, S, KV, Dh]
    → [B, S, H, Dh] in q.dtype (and lse [B, H, S] f32 ``with_lse``)."""
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
    denom = torch.clamp_min(l, 1e-30)
    out = (pv / denom.permute(0, 2, 1)[..., None]).to(q.dtype)
    if with_lse:
        return out, m[..., 0] + torch.log(denom)
    return out


def check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless a kernel operand has this device, dtype, shape and a
    contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, rope: Rope = None,
                         with_lse: bool = False):
    """Launch ``csrc/flash_attention.cu``, or ``csrc/flash_attention_direct.cu``
    under ``CTDB_FLASH_DIRECT=1`` when the keys fit one kv tile (bf16 q/k/v
    on one card); lse is written only ``with_lse``."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if h % kv:
        raise ValueError(f"{h} query heads do not group onto {kv} kv heads")
    check_operand("q", q, (b, s, h, dh), torch.bfloat16, dev)
    check_operand("k", k, (b, s, kv, dh), torch.bfloat16, dev)
    check_operand("v", v, (b, s, kv, dh), torch.bfloat16, dev)
    bias = mask_bias(mask, b, s, dev)
    check_operand("bias", bias, (b, s), torch.float32, dev)
    cos_ptr = sin_ptr = None
    if rope is not None:
        cos, sin = rope
        check_operand("cos", cos, (b, s, dh // 2), torch.float32, dev)
        check_operand("sin", sin, (b, s, dh // 2), torch.float32, dev)
        cos_ptr, sin_ptr = cos.data_ptr(), sin.data_ptr()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
           if with_lse else None)
    kernel = DIRECT_KERNEL if direct_mode() and single_kv_tile(s) else FLASH_KERNEL
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
           cos_ptr, sin_ptr, out.data_ptr(),
           None if lse is None else lse.data_ptr(), b, s, kv_tile_len(s),
           h, kv, dh, dh ** -0.5, stream)
    return (out, lse) if with_lse else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, rope: Rope = None):
    """(out, lse) for the autograd wrapper: the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask=mask, rope=rope, with_lse=True)
    return flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's backward (``_core_bwd`` /
    ``_core_rope_bwd``).  Under ``torch.utils.checkpoint`` the forward runs
    twice; the kernel is deterministic, so the recompute is bit-identical."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cos, sin):
        rope = None if cos is None else (cos, sin)
        out, lse = flash_attention_fwd(q, k, v, mask=mask, rope=rope)
        ctx.save_for_backward(q, k, v, mask, cos, sin, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        # Imported here: models/__init__ imports the transformer, which
        # imports this module, and flash_attention_bwd imports this module.
        from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope
        from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab

        q, k, v, mask, cos, sin, out, lse = ctx.saved_tensors
        b, s = q.shape[:2]
        if cos is not None:
            q = apply_rope(q, cos, sin)  # f32 math, cast to q.dtype
            k = apply_rope(k, cos, sin)
        bias = mask_bias(mask, b, s, q.device)
        dq, dk, dv = fab.flash_attention_bwd(
            q, k, v, bias, out, g.to(q.dtype).contiguous(), lse)
        if cos is not None:
            # RoPE is orthogonal: d(unrotated) = R^T d(rotated), in f32.
            dq = apply_rope(dq, cos, -sin)
            dk = apply_rope(dk, cos, -sin)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, rope: Rope = None) -> torch.Tensor:
    """q: [B, S, H, Dh]; k, v: [B, S, KV, Dh]; mask: [B, S] (1 = real);
    ``rope=(cos, sin)`` each [B, S, Dh//2] f32, applied inside.

    With grad enabled and an input that requires it, the call goes through
    :class:`FlashAttention`; otherwise CPU tensors take
    :func:`flash_attention_plain` and CUDA tensors launch the kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        cos, sin = (None, None) if rope is None else rope
        return FlashAttention.apply(q, k, v, mask, cos, sin)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask=mask, rope=rope)
    return flash_attention_cuda(q, k, v, mask=mask, rope=rope)
