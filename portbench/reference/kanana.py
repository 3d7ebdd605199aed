"""Plain float32 forward of kanana-2-30B-A3B (DeepSeek-V3's layers) decoded
by block diffusion, for the benchmark's comparison.

Written from the published description: kakaocorp/kanana-2-30b-a3b-
instruct-2601's ``config.json`` (model_type ``deepseek_v3``) and
DeepSeek-V3's layer equations (arXiv:2412.19437, and the ``deepseek_v3``
modelling code that reads that config).  Pre-norm blocks with RMSNorm;
multi-head latent attention with no low-rank q: q = h Wq per head split
into ``qk_nope_head_dim`` and ``qk_rope_head_dim`` dims; h Wkv_a gives the
latent c (RMSNorm'd by ``kv_a_layernorm``) and one rope key shared by every
head; c Wkv_b gives each head's nope key and value; the rope dims rotate
in interleaved pairs (2i, 2i + 1) at frequency theta^(-2i / P)
(``rope_interleave``); scores scaled by (nope + rope)^-½; the first
``first_k_dense_replace`` layers a dense SwiGLU, the rest a sigmoid router
(``noaux_tc`` with one group: the top-k of the sigmoid scores plus the
``e_score_correction_bias``, the weights the chosen unbiased scores
renormalized by their sum + 1e-20 and times ``routed_scaling_factor``) over
SwiGLU experts, plus the shared experts as one SwiGLU of ``n_shared_experts``
expert widths; an untied LM head.  It imports nothing of the measured
program: its weights are the benchmark's own draw, in the published
(interleaved) column order (``portbench/harness/mla_check.py``), and its
products and norms are ``portbench/reference/llada.py``'s.

A full forward over the sequence, layer by layer, with no cache, no
absorption (every key and value is up-projected from c) and no batching of
requests: every tensor float32, every product with TF32 off
(:func:`portbench.reference.llada.strict_f32`), each layer's weights cast
up when it runs.  Attention runs in chunks of :data:`CHUNK` queries, so a
32k-position row fits on the card.  :func:`pack` lays several states of
one request into one row, as ``reference/sdar.py::pack`` does, with the
keys each query sees given as two ranges instead of a matrix.

Departures from the published description:

- The model is published as an autoregressive decoder; here its attention
  is block-causal (SDAR's recipe): a query sees every key of its own block
  of ``block_length`` positions, both ways, and of every earlier block.
  Blocks are aligned to the padded row from its first position; the
  benchmark's prompts are padded to a multiple of the block length, so the
  generated blocks start right after the prompt either way.
- Positions restart at each row's first real token and padded keys are
  never seen, as in the program; a padded query that would then see no key
  sees itself (its output is never read), so no row's softmax is empty.
- Logits are unshifted: position i predicts token i (SDAR's, not the
  published next-token head).
- ``cast`` (default none) rounds both operands of every linear product: the
  fp8 control of ``portbench/reference/control.py``.
- ``route`` (default none, :class:`Route`) pins each position's experts in
  each expert layer to given ones (the program's, for the benchmark's
  comparison); the weights stay the forward's own scores of those experts,
  renormalized and scaled, and the top-k its own scores would choose is
  kept beside them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.llada import Cast, linear, positions, rms_norm, strict_f32

__all__ = ["strict_f32", "pack", "prefix_ranges", "final_hidden", "layer_weights", "Route"]

CHUNK = 512          # query positions an attention chunk computes at once
DENSE = ("w_gate", "w_up", "w_down")
MOE = ("router", "e_bias", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")


@dataclass
class Route:
    """Routes of one row's forward: ``pinned`` int64 [L - k, S, K], the
    experts each position takes in each expert layer (k =
    ``first_k_dense_replace``; None: its own), and ``own``, filled a layer
    at a time by the forward: the top-k [S, K] its own scores chose there."""
    pinned: Optional[torch.Tensor] = None
    own: List[torch.Tensor] = field(default_factory=list)


def layer_weights(weights: dict, s: Dict, li: int) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights in f32: the dense FFN's of the first
    ``first_k_dense_replace`` layers, the MoE stacks' entry li - k after."""
    k = s["first_k_dense_replace"]
    out = {}
    for name, v in weights["blocks"].items():
        if name in DENSE:
            if li < k:
                out[name] = v[li].float()
        elif name in MOE:
            if li >= k:
                out[name] = v[li - k].float()
        else:
            out[name] = v[li].float()
    return out


def rotate_interleaved(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on interleaved pairs (2i, 2i + 1), pair i at angle pos ·
    theta^(-2i / P).  x [R, S, H, P]; pos [R, S]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[..., None] * inv
    cos = torch.cos(ang).float()[:, :, None]
    sin = torch.sin(ang).float()[:, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def prefix_ranges(mask: torch.Tensor, block_length: int) -> torch.Tensor:
    """int64 [R, S, 4]: the keys query i sees, as two ranges [lo, hi): the
    real keys up to its block's end, and itself."""
    R, S = mask.shape
    dev = mask.device
    first = S - mask.long().sum(dim=-1)                                   # [R]
    i = torch.arange(S, device=dev)
    end = (i // block_length + 1) * block_length
    out = torch.empty((R, S, 4), dtype=torch.long, device=dev)
    out[..., 0] = first[:, None]
    out[..., 1] = end[None]
    out[..., 2] = i[None]
    out[..., 3] = i[None] + 1
    return out


def pack(ids: torch.Tensor, mask: torch.Tensor, blocks, block_length: int):
    """One row for several states that share the prefix ``ids`` [S0] under
    ``mask`` [S0] (the padded prompt and the blocks committed after it):
    each of ``blocks``, a list of (start, block ids [bl]) with start ≤ S0, is
    the state ``ids[:start]`` followed by that block.  Returns (row ids,
    positions, ranges [S0 + n·bl, 4] (:func:`prefix_ranges`' form), each
    block's first index in the row): a block's queries see the prefix's
    real keys before its start and its own keys, at the positions they hold
    in their state."""
    S0, bl = ids.shape[0], block_length
    dev = ids.device
    row = torch.cat([ids] + [b.to(ids.dtype) for _, b in blocks])
    S = row.shape[0]
    pos = torch.zeros(S, dtype=torch.long, device=dev)
    pos[:S0] = positions(mask[None])[0]
    ranges = torch.zeros((S, 4), dtype=torch.long, device=dev)
    ranges[:S0] = prefix_ranges(mask[None], bl)[0]
    first = S0 - int(mask.long().sum())
    offsets = []
    for j, (start, _) in enumerate(blocks):
        lo = S0 + j * bl
        offsets.append(lo)
        pos[lo:lo + bl] = (start - first) + torch.arange(bl, device=dev)
        ranges[lo:lo + bl] = torch.tensor([first, start, lo, lo + bl], device=dev)
    return row, pos, ranges, offsets


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ranges: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Softmax attention, query chunk by query chunk, over the keys each
    query's ``ranges`` [R, S, 4] names.  q, k [R, S, H, Dqk]; v [R, S, H,
    Dv]."""
    R, S = q.shape[:2]
    out = torch.empty((*q.shape[:3], v.shape[-1]), dtype=q.dtype, device=q.device)
    for c0 in range(0, S, CHUNK):
        c1 = min(S, c0 + CHUNK)
        rg = ranges[:, c0:c1, None, :]                                      # [R, C, 1, 4]
        # Only the keys some query of the chunk sees: the rest add nothing.
        lo = int(torch.minimum(rg[..., 0], rg[..., 2]).min())
        hi = min(S, int(torch.maximum(rg[..., 1], rg[..., 3]).max()))
        keys = torch.arange(lo, hi, device=q.device)
        seen = (((keys >= rg[..., 0]) & (keys < rg[..., 1]))
                | ((keys >= rg[..., 2]) & (keys < rg[..., 3])))             # [R, C, K]
        scores = torch.einsum("rqhd,rkhd->rhqk", q[:, c0:c1], k[:, lo:hi]) * scale
        scores = scores.masked_fill(~seen[:, None], float("-inf"))
        out[:, c0:c1] = torch.einsum("rhqk,rkhd->rqhd", torch.softmax(scores, dim=-1),
                                     v[:, lo:hi])
    return out


def mla(h: torch.Tensor, lw: Dict[str, torch.Tensor], s: Dict, pos, ranges,
        cast: Cast = None) -> torch.Tensor:
    """The attention half's output before ``wo``: [R, S, H·V]."""
    R, S, _ = h.shape
    H, N, P, V, r = (s["num_heads"], s["qk_nope_head_dim"], s["qk_rope_head_dim"],
                     s["v_head_dim"], s["kv_lora_rank"])
    q = linear(h, lw["wq"], cast).view(R, S, H, N + P)
    lat = linear(h, lw["wkv_a"], cast)
    c = rms_norm(lat[..., :r], lw["kv_norm"], s["norm_eps"])
    k_pe = rotate_interleaved(lat[:, :, None, r:], pos, s["rope_theta"])
    kv = linear(c, lw["wkv_b"], cast).view(R, S, H, N + V)
    q = torch.cat([q[..., :N], rotate_interleaved(q[..., N:], pos, s["rope_theta"])], dim=-1)
    k = torch.cat([kv[..., :N], k_pe.expand(R, S, H, P)], dim=-1)
    out = attention(q, k, kv[..., N:], ranges, (N + P) ** -0.5)
    return out.reshape(R, S, H * V)


def swiglu(x, w_gate, w_up, w_down, cast: Cast = None) -> torch.Tensor:
    return linear(F.silu(linear(x, w_gate, cast)) * linear(x, w_up, cast), w_down, cast)


def moe(x: torch.Tensor, lw: Dict[str, torch.Tensor], s: Dict, cast: Cast = None,
        pinned: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sigmoid-routed experts and the shared one.  x [N, D] → ([N, D],
    the experts its own scores choose [N, K]); ``pinned`` [N, K]: the
    experts taken instead."""
    scores = torch.sigmoid(linear(x, lw["router"], cast))
    choice = scores + lw["e_bias"]
    order = torch.sort(choice, dim=-1, descending=True, stable=True)[1]
    own = order[:, :s["num_experts_per_tok"]]
    top_i = own if pinned is None else pinned
    top_w = scores.gather(-1, top_i)
    if s["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    top_w = top_w * s["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(s["num_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], lw["we_gate"][e], lw["we_up"][e], lw["we_down"][e], cast)
            out.index_add_(0, tok, y * top_w[tok, slot, None])
    return out + swiglu(x, lw["ws_gate"], lw["ws_up"], lw["ws_down"], cast), own


def block(x: torch.Tensor, lw: Dict[str, torch.Tensor], s: Dict, pos, ranges,
          cast: Cast = None, route: Optional[Route] = None,
          li: int = 0) -> torch.Tensor:
    """Layer ``li``: x [R, S, D] → x; ``route`` (one row): its pins."""
    R, S, D = x.shape
    h = rms_norm(x, lw["attn_norm"], s["norm_eps"])
    x = x + linear(mla(h, lw, s, pos, ranges, cast), lw["wo"], cast)
    h = rms_norm(x, lw["ffn_norm"], s["norm_eps"])
    if "router" in lw:
        pinned = (None if route is None or route.pinned is None
                  else route.pinned[li - s["first_k_dense_replace"]])
        y, own = moe(h.reshape(R * S, D), lw, s, cast, pinned)
        y = y.view(R, S, D)
        if route is not None:
            route.own.append(own)
    else:
        y = swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], cast)
    return x + y


@torch.no_grad()
def final_hidden(weights: dict, s: Dict, ids: torch.Tensor, mask: Optional[torch.Tensor],
                 cast: Cast = None, ranges: Optional[torch.Tensor] = None,
                 pos: Optional[torch.Tensor] = None,
                 route: Optional[Route] = None) -> torch.Tensor:
    """Final-norm hidden states [R, S, D] of rows ``ids`` [R, S] under
    ``mask`` [R, S] (1 = real token), blocks of ``s["block_length"]``; rows
    of :func:`pack` give their own ``ranges`` [R, S, 4] and ``pos`` [R, S]
    (``mask`` is then not read).  ``route``: one row's pinned experts."""
    if route is not None and ids.shape[0] != 1:
        raise ValueError("pinned routes are one row's")
    x = weights["embed"][ids.clamp(0, s["vocab_size"] - 1)].float()
    pos = positions(mask) if pos is None else pos
    ranges = prefix_ranges(mask, s["block_length"]) if ranges is None else ranges
    for li in range(s["num_layers"]):
        x = block(x, layer_weights(weights, s, li), s, pos, ranges, cast, route, li)
    return rms_norm(x, weights["final_norm"].float(), s["norm_eps"])


@torch.no_grad()
def logits(weights: dict, s: Dict, ids: torch.Tensor, mask: torch.Tensor,
           cast: Cast = None) -> torch.Tensor:
    """f32 logits [R, S, V] of every position."""
    return linear(final_hidden(weights, s, ids, mask, cast), weights["lm_head"].float(), cast)

