"""Plain float32 forward of the LLaDA family (dense and mixture of experts).

Written from the published model descriptions (LLaDA-8B: a LLaMA-style
bidirectional transformer; LLaDA-MoE: the same with a softmax top-k router
over SwiGLU experts, renormalized top-k probabilities and one shared
expert, and per-head RMSNorm on q and k) for the benchmark's comparison.
It imports nothing of the measured program and takes none of its state:
its weights are the benchmark's own draw (``portbench/harness/model.py``).

Every tensor is float32 and every product runs with TF32 off (set by
:func:`strict_f32`).  Layer by layer, each layer's weights are cast up from
their stored dtype when the layer runs, so only one layer's float32 copy is
live.  Positions restart at each row's first real token (left padding);
padded keys are left out of every attention.

``cast`` (default none) rounds both operands of every linear product before
it: the control of ``portbench/reference/control.py`` passes an fp8
rounding there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Cast = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


def strict_f32() -> None:
    """float32 products in float32: no TF32, no reduced-precision sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(x: torch.Tensor, w: torch.Tensor, cast: Cast = None) -> torch.Tensor:
    """x [..., K] @ w [K, M] in f32; ``cast`` rounds x along K per row and
    w along K per column."""
    if cast is not None:
        x, w = cast(x, -1), cast(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * gain


def positions(mask: torch.Tensor) -> torch.Tensor:
    """Position of each token: 0 at a row's first real token; pads take 0."""
    return (torch.cumsum(mask.long(), dim=-1) - 1).clamp_min(0)


def rotate(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the two halves of each head rotated together (HF
    LLaMA).  x [R, S, H, Dh]; pos [R, S]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[..., None] * inv                           # [R, S, half]
    cos = torch.cos(ang).float()[:, :, None]
    sin = torch.sin(ang).float()[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional softmax attention; kv head j serves query heads
    j·rep .. j·rep + rep − 1.  q [R, S, H, Dh]; k, v [R, S, KV, Dh]."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("rqhd,rkhd->rhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))
    return torch.einsum("rhqk,rkhd->rqhd", torch.softmax(scores, dim=-1), v)


def swiglu(x, w_gate, w_up, w_down, cast: Cast = None) -> torch.Tensor:
    return linear(F.silu(linear(x, w_gate, cast)) * linear(x, w_up, cast), w_down, cast)


def experts(x: torch.Tensor, lw: Dict[str, torch.Tensor], s: Dict, cast: Cast = None):
    """The routed experts and the shared one.  x [N, D] →
    ([N, D], router probabilities [N, E], chosen experts [N, K])."""
    probs = torch.softmax(linear(x, lw["router"], cast), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = s["num_experts_per_tok"]
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    if s["norm_topk_prob"]:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(s["num_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], lw["we_gate"][e], lw["we_up"][e], lw["we_down"][e], cast)
            out.index_add_(0, tok, y * top_p[tok, slot, None])
    if s["num_shared_experts"]:
        out = out + swiglu(x, lw["ws_gate"], lw["ws_up"], lw["ws_down"], cast)
    return out, probs, top_i


def layer_weights(weights: dict, li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li].float() for k, v in weights["blocks"].items()}


def block(x: torch.Tensor, lw: Dict[str, torch.Tensor], s: Dict, mask, pos,
          cast: Cast = None):
    """One layer: x [R, S, D] → (x, the layer's load-balancing loss or 0)."""
    R, S, D = x.shape
    H, KV, Dh = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    h = rms_norm(x, lw["attn_norm"], s["norm_eps"])
    q = linear(h, lw["wq"], cast)
    k = linear(h, lw["wk"], cast)
    v = linear(h, lw["wv"], cast)
    if s["attention_bias"]:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q, k, v = q.view(R, S, H, Dh), k.view(R, S, KV, Dh), v.view(R, S, KV, Dh)
    if s["qk_norm"]:
        q = rms_norm(q, lw["q_norm"], s["norm_eps"])
        k = rms_norm(k, lw["k_norm"], s["norm_eps"])
    q, k = rotate(q, pos, s["rope_theta"]), rotate(k, pos, s["rope_theta"])
    x = x + linear(attention(q, k, v, mask).reshape(R, S, H * Dh), lw["wo"], cast)
    h = rms_norm(x, lw["ffn_norm"], s["norm_eps"])
    if s["num_experts"]:
        y, probs, top_i = experts(h.reshape(R * S, D), lw, s, cast)
        return x + y.view(R, S, D), balance_loss(probs, top_i, s["num_experts"])
    return (x + swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], cast),
            torch.zeros((), device=x.device))


def balance_loss(probs: torch.Tensor, top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-transformer load balancing: E · Σ_e (share of the routing
    slots that chose e) · (mean router probability of e)."""
    counts = torch.bincount(top_i.reshape(-1), minlength=n_experts).float()
    return n_experts * torch.sum(counts / counts.sum() * probs.mean(dim=0))


@torch.no_grad()
def final_hidden(weights: dict, s: Dict, ids: torch.Tensor, mask: torch.Tensor,
                 cast: Cast = None) -> torch.Tensor:
    """Final-norm hidden states [R, S, D] of rows ``ids`` [R, S] under
    ``mask`` [R, S] (1 = real token)."""
    x = weights["embed"][ids.clamp(0, s["vocab_size"] - 1)].float()
    pos = positions(mask)
    for li in range(s["num_layers"]):
        x, _ = block(x, layer_weights(weights, li), s, mask, pos, cast)
    return rms_norm(x, weights["final_norm"].float(), s["norm_eps"])


@torch.no_grad()
def block_logits(weights: dict, s: Dict, ids: torch.Tensor, mask: torch.Tensor,
                 start: int, length: int, cast: Cast = None) -> torch.Tensor:
    """f32 logits [R, length, V] of positions ``start .. start + length``."""
    x = final_hidden(weights, s, ids, mask, cast)[:, start:start + length]
    return linear(x, weights["lm_head"].float(), cast)
