"""Bidirectional, cache-less multi-head attention.

Counterpart of ``ops/attention.py``: the reference implementation (the
numerics oracle) and the dispatcher.  Shapes follow the GQA convention
q [B, S, H, Dh], k/v [B, S, KV, Dh]; ``mask`` [B, S] with 1 = real token.

Dispatch: ``causal`` always takes the reference; otherwise ``impl="auto"``
takes the flash kernel on a CUDA tensor at every shape and the reference on
the CPU.  ``impl="flash"`` forces the flash path (its plain version on CPU).
``block_len`` > 0 (the SDAR family) makes it block-causal: query i sees the
keys of its own block and every earlier one, blocks of ``block_len``
positions from the first (padded) position; the flash path then launches
the flash kernel's block-causal mode.  A split sequence refuses it.

Under a ``parallel/`` mesh whose scope holds the whole sequence the
dispatch is the same: attention is head- and row-local, so the kernel runs
on whatever heads and rows the rank holds, with no collective.  The
reference wraps its kernel in ``shard_map`` (``_flash_sharded``) and falls
back to its reference path where the heads or rows do not divide the mesh;
the port has no such limit.

Where the scope splits the sequence over ``seq`` (each rank holds S/sp
positions of q, k and v), non-causal ``impl="auto"`` takes the ring
(``ops/ring_attention.py``) on the rotated q / k, as the reference's
dispatch does.  An explicit ``impl`` wins, as in the reference, and so does
``causal``: q, k, v and the mask are then gathered over ``seq`` (the
gather's backward sums the ranks' cotangents), the impl runs on the whole
sequence and the rank keeps its rows, which is what GSPMD makes of the
reference's dense attention on a sharded sequence.  Where the sequence
does not divide by ``seq`` the callers keep it whole on every seq rank
(``parallel/sharding.py``, ``train/trainer.py``), and the flash kernel runs
over all of it: the reference's dense fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.ops import ring_attention as ring
from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import flash_attention
from ct_diffusionmodelbench_tpu_torch.parallel.comm import gather_from_seq
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import current_scope

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False, block_len: int = 0) -> torch.Tensor:
    """Softmax attention in f32, output in q.dtype; block-causal over
    ``block_len`` positions where it is above 0 (a hidden key scores
    2 · NEG_INF, below a padding key, as the flash kernel's mode)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        bias = torch.where(mask[:, None, None, :].bool(), 0.0, NEG_INF)
        logits = logits + bias
    if causal:
        s = q.shape[1]
        tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = torch.where(tri[None, None], logits, NEG_INF)
    if block_len:
        from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import block_visible

        seen = block_visible(q.shape[1], k.shape[1], block_len, q.device)
        logits = torch.where(seen[None, None], logits, 2 * NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, impl: str = "auto",
              causal: bool = False,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              block_len: int = 0) -> torch.Tensor:
    """``rope=(cos, sin)``: q/k arrive unrotated; the flash path rotates
    inside the kernel, the reference path and the ring rotate first.
    ``block_len`` > 0: block-causal attention."""
    scope = current_scope()
    if scope is not None and scope.positions is not None:
        if block_len:
            raise NotImplementedError("block-causal attention over a split sequence")
        return _seq_split_attention(q, k, v, mask, impl, causal, rope, scope)
    if causal:
        impl = "reference"
    elif impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        return flash_attention(q, k, v, mask=mask, rope=rope, block_len=block_len)
    if impl == "reference":
        if rope is not None:
            # Imported here: models/__init__ imports the transformer, which
            # imports this module.
            from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope

            q = apply_rope(q, rope[0], rope[1])
            k = apply_rope(k, rope[0], rope[1])
        return attention_reference(q, k, v, mask=mask, causal=causal,
                                   block_len=block_len)
    raise ValueError(f"unknown attention impl {impl!r}")


def _seq_split_attention(q, k, v, mask, impl, causal, rope, scope):
    """Attention of this rank's slice of a sequence split over ``seq``."""
    if rope is not None:
        from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope

        q = apply_rope(q, rope[0], rope[1])
        k = apply_rope(k, rope[0], rope[1])
    mesh = scope.mesh
    if not causal and impl == "auto":
        return ring.ring_attention(q, k, v, mask=mask, mesh=mesh)
    whole = [gather_from_seq(t, mesh) for t in (q, k, v)]
    mask = None if mask is None else gather_from_seq(mask, mesh)
    if causal:
        out = attention_reference(*whole, mask=mask, causal=True)
    elif impl == "flash":
        out = flash_attention(*whole, mask=mask)
    elif impl == "reference":
        out = attention_reference(*whole, mask=mask)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return out[:, scope.positions]
