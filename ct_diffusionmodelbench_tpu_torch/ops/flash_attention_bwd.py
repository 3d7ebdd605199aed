"""Bidirectional flash-attention backward: the CUDA kernels and their plain
version.

Counterpart of ``ops/flash_attention_bwd.py::flash_attention_bwd``.  With
``lse`` from the forward and D = rowsum(dO ∘ O), per query head h (kv head
h // rep)::

    p_ij  = exp(q_i·k_j * scale + bias_j - lse_i)
    dv_j  = Σ_i p_ij · do_i
    ds_ij = p_ij · (do_i·v_j − D_i) · scale
    dq_i  = Σ_j ds_ij k_j
    dk_j  = Σ_i ds_ij q_i

with dk/dv summed over the rep query heads of each kv head.  q and k arrive
rotated (the autograd wrapper re-rotates them, as the reference does); p and
ds are cast to the value dtype for the products; results are f32.  D is a
torch reduction here, as the reference computes it outside its kernels.

Keys past S (the reference pads them to its kv tile as zero keys with bias
−1e30) are left out: a zero key adds nothing to dq and its dk/dv are
dropped, so the result equals the reference's on the S real keys, the
all-masked row included (its lse is −1e30, so p = 1 on every key there, as
in the reference).

The kernels are ``csrc/flash_attention_bwd.cu``; a CPU tensor takes
:func:`flash_attention_bwd_plain`, a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import (
    FLOAT, INT, PTR, Kernel, Library)
from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import HEAD_DIMS, check_operand

LIBRARY = Library("flash_attention_bwd.cu")
DQ_KERNEL = Kernel("flash_attention_bwd_dq", LIBRARY,
                   "ctdb_flash_attention_bwd_dq", [PTR] * 8 + [INT] * 5 + [FLOAT, PTR])
DKV_KERNEL = Kernel("flash_attention_bwd_dkv", LIBRARY,
                    "ctdb_flash_attention_bwd_dkv", [PTR] * 9 + [INT] * 5 + [FLOAT, PTR])

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ O) in f32: [B, S, H, Dh] pair → [B, H, S]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor) -> Grads:
    """The kernels' function in PyTorch, from the formulas above.

    q, o, do [B, S, H, Dh]; k, v [B, S, KV, Dh]; bias [B, S] f32 (0 or
    −1e30 per key); lse [B, H, S] f32 → dq [B, S, H, Dh], dk, dv
    [B, S, KV, Dh], all f32."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = dh ** -0.5
    kr = k.repeat_interleave(rep, dim=2).float()
    vr = v.repeat_interleave(rep, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    scores = scores + bias[:, None, None, :]
    p = torch.exp(scores - lse[..., None])                      # [B, H, Sq, Sk]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    ds = p * (dp - row_dot(o, do)[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dq, dk.reshape(b, s, kv, rep, dh).sum(dim=3),
            dv.reshape(b, s, kv, rep, dh).sum(dim=3))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor) -> Grads:
    """Launch the dq and dkv kernels of ``csrc/flash_attention_bwd.cu``
    (bf16 q/k/v/o/do on one card)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if h % kv:
        raise ValueError(f"{h} query heads do not group onto {kv} kv heads")
    for name, t in (("q", q), ("o", o), ("do", do)):
        check_operand(name, t, (b, s, h, dh), torch.bfloat16, dev)
    for name, t in (("k", k), ("v", v)):
        check_operand(name, t, (b, s, kv, dh), torch.bfloat16, dev)
    check_operand("bias", bias, (b, s), torch.float32, dev)
    check_operand("lse", lse, (b, h, s), torch.float32, dev)
    dsum = row_dot(o, do)
    dq = torch.empty((b, s, h, dh), dtype=torch.float32, device=dev)
    dk = torch.empty((b, s, kv, dh), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
              do.data_ptr(), lse.data_ptr(), dsum.data_ptr())
    DQ_KERNEL(*common, dq.data_ptr(), b, s, h, kv, dh, dh ** -0.5, stream)
    DKV_KERNEL(*common, dk.data_ptr(), dv.data_ptr(), b, s, h, kv, dh,
               dh ** -0.5, stream)
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor) -> Grads:
    """(dq, dk, dv) in f32.  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the kernels."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, o, do, lse)
    return flash_attention_bwd_cuda(q, k, v, bias, o, do, lse)
