"""Plain float32 forward of SDAR-30B-A3B (a Qwen3-MoE decoder decoded by
block diffusion) for the benchmark's comparison.

Written from the published description (JetLM/SDAR-30B-A3B-Chat's
``config.json``, model_type ``sdar_moe``, and the SDAR paper,
arXiv:2510.06303): pre-norm blocks with RMSNorm; GQA attention whose q and
k take a per-head RMSNorm over the head dimension before rotate-half RoPE
(Qwen3's, named by no config key); a softmax router over 128 SwiGLU
experts, top-8, the chosen probabilities renormalized (``norm_topk_prob``),
no shared expert; an untied LM head whose logits are unshifted (position i
predicts token i).  Attention is block-causal: a query sees every key of
its own block, both ways, and of every earlier block.  It imports nothing
of the measured program: its weights are the benchmark's own draw
(``portbench/harness/model.py``), and the products, norms, rotation and
experts are ``portbench/reference/llada.py``'s.

A full forward over the sequence under the block-causal mask, layer by
layer, with no cache: every tensor float32, every product with TF32 off
(:func:`portbench.reference.llada.strict_f32`), each layer's weights cast
up when the layer runs.  :func:`pack` lays several states of one request
into one row (the longest prefix once, each state's last block beside it,
each query seeing exactly its own state's keys at its own positions), so
one forward serves them all; every logit is still that of the state's
full forward, as block-causal attention makes a position's hidden state
depend on no later block.

Departures from the published description, each without effect on a real
token's logits:

- Blocks are aligned to the padded row, from its first position; SDAR
  aligns them from the row's first real token and joins the prompt's last
  partial block to the first generated one.  The benchmark's prompts are
  padded to a multiple of the block length, so the generated blocks start
  right after the prompt either way; the prompt's own blocks differ.
- Positions restart at each row's first real token and padded keys are
  never seen, as in the program; a padded query row that would then see no
  key at all sees itself (its output is never read), so no row's softmax is
  empty.
- ``cast`` (default none) rounds both operands of every linear product: the
  fp8 control of ``portbench/reference/control.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.reference.llada import (
    Cast, experts, layer_weights, linear, positions, rms_norm, rotate, strict_f32)

__all__ = ["strict_f32", "visible", "pack", "attention", "block", "final_hidden",
           "block_logits"]


def visible(mask: torch.Tensor, block_length: int) -> torch.Tensor:
    """bool [R, S, S] (query, key): the key is real and in the query's block
    or an earlier one, or it is the query itself."""
    S = mask.shape[1]
    blk = torch.arange(S, device=mask.device) // block_length
    causal = blk[None, :] <= blk[:, None]
    eye = torch.eye(S, dtype=torch.bool, device=mask.device)
    return (causal[None] & mask.bool()[:, None, :]) | eye[None]


def pack(ids: torch.Tensor, mask: torch.Tensor, blocks, block_length: int):
    """One row for several states that share the prefix ``ids`` [S0] under
    ``mask`` [S0] (the padded prompt and the blocks committed after it):
    each of ``blocks``, a list of (start, block ids [bl]) with start ≤ S0, is
    the state ``ids[:start]`` followed by that block.  Returns (row ids
    [S0 + n·bl], positions [S0 + n·bl], seen [S0 + n·bl, S0 + n·bl], each
    block's first index in the row): the prefix sees as :func:`visible`
    makes it, a block's queries see the prefix's real keys before its start
    and its own keys, at the positions they hold in their state."""
    S0, bl, n = ids.shape[0], block_length, len(blocks)
    S = S0 + n * bl
    dev = ids.device
    row = torch.cat([ids] + [b.to(ids.dtype) for _, b in blocks])
    pos = torch.zeros(S, dtype=torch.long, device=dev)
    pos[:S0] = positions(mask[None])[0]
    seen = torch.zeros((S, S), dtype=torch.bool, device=dev)
    seen[:S0, :S0] = visible(mask[None], bl)[0]
    real = mask.bool()
    offsets = []
    for j, (start, _) in enumerate(blocks):
        lo = S0 + j * bl
        offsets.append(lo)
        pos[lo:lo + bl] = int(real[:start].sum()) + torch.arange(bl, device=dev)
        seen[lo:lo + bl, :start] = real[:start]
        seen[lo:lo + bl, lo:lo + bl] = True
    return row, pos, seen, offsets


def attention(q, k, v, seen: torch.Tensor) -> torch.Tensor:
    """Softmax attention over the keys ``seen`` [R, S, S] marks; kv head j
    serves query heads j·rep .. j·rep + rep − 1.  q [R, S, H, Dh]; k, v
    [R, S, KV, Dh]."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("rqhd,rkhd->rhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~seen[:, None], float("-inf"))
    return torch.einsum("rhqk,rkhd->rqhd", torch.softmax(scores, dim=-1), v)


def block(x: torch.Tensor, lw: Dict[str, torch.Tensor], s: Dict, seen, pos,
          cast: Cast = None) -> torch.Tensor:
    """One layer: x [R, S, D] → x."""
    R, S, D = x.shape
    H, KV, Dh = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    h = rms_norm(x, lw["attn_norm"], s["norm_eps"])
    q = linear(h, lw["wq"], cast).view(R, S, H, Dh)
    k = linear(h, lw["wk"], cast).view(R, S, KV, Dh)
    v = linear(h, lw["wv"], cast).view(R, S, KV, Dh)
    q = rotate(rms_norm(q, lw["q_norm"], s["norm_eps"]), pos, s["rope_theta"])
    k = rotate(rms_norm(k, lw["k_norm"], s["norm_eps"]), pos, s["rope_theta"])
    x = x + linear(attention(q, k, v, seen).reshape(R, S, H * Dh), lw["wo"], cast)
    h = rms_norm(x, lw["ffn_norm"], s["norm_eps"])
    y, _, _ = experts(h.reshape(R * S, D), lw, s, cast)
    return x + y.view(R, S, D)


@torch.no_grad()
def final_hidden(weights: dict, s: Dict, ids: torch.Tensor, mask: torch.Tensor,
                 cast: Cast = None, seen: Optional[torch.Tensor] = None,
                 pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-norm hidden states [R, S, D] of rows ``ids`` [R, S] under
    ``mask`` [R, S] (1 = real token), blocks of ``s["block_length"]``; rows
    of :func:`pack` give their own ``seen`` [R, S, S] and ``pos`` [R, S]
    (``mask`` is then not read)."""
    x = weights["embed"][ids.clamp(0, s["vocab_size"] - 1)].float()
    pos = positions(mask) if pos is None else pos
    seen = visible(mask, s["block_length"]) if seen is None else seen
    for li in range(s["num_layers"]):
        x = block(x, layer_weights(weights, li), s, seen, pos, cast)
    return rms_norm(x, weights["final_norm"].float(), s["norm_eps"])


@torch.no_grad()
def block_logits(weights: dict, s: Dict, ids: torch.Tensor, mask: torch.Tensor,
                 start: int, length: int, cast: Cast = None) -> torch.Tensor:
    """f32 logits [R, length, V] of positions ``start .. start + length``."""
    x = final_hidden(weights, s, ids, mask, cast)[:, start:start + length]
    return linear(x, weights["lm_head"].float(), cast)
