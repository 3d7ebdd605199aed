"""Plain float32 masked-diffusion SFT step of the LLaDA family.

Written from the training recipe the port's trainer follows (LLaDA's SFT
objective; optax's clip-by-global-norm then AdamW; the blockwise int8
moments of the reference package's ``adamw_lowp``), for the benchmark's
comparison.  Imports nothing of the measured program.

One step over ``A`` micro-batches: per micro-batch the diffusion noise
(``t`` a row, ``u`` a token, given by the caller so both sides draw alike)
masks the answer's tokens where ``u < (1 − ε)·t + ε``; the loss is the
cross-entropy of the masked answer tokens, each weighted by one over its
masking probability and over its row's answer length, summed over the
batch's rows and divided by their count, plus the load-balancing loss of a
mixture of experts (its mean over the layers, times ``aux_coef``).  The
gradient is the micro-batches' mean, in float32.  The backward runs layer
by layer from the layers' saved inputs (each layer recomputed with its
float32 weights as leaves), so one layer's float32 weights and their
gradients are live at a time beside the float32 gradient sums.

The update: the gradient scaled by min(1, max_norm / ‖g‖), then AdamW with
its moments in float32 or in blockwise int8 (scale absmax/127 per block of
256 along the last dimension, 128 where only that divides it, else over the
flattened leaf; the second moment's rounding, half a step of its previous
block, enters the denominator), weight decay off for norm gains and
biases, and the parameters kept in their stored dtype (bf16 on the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import llada as ref

EPS_MASK = 1e-3
NO_DECAY = ("norm", "bias", "bq", "bk", "bv")
BLOCK = 256


def flat(weights: dict) -> Dict[str, torch.Tensor]:
    out = {k: v for k, v in weights.items() if k != "blocks"}
    out.update({f"blocks/{k}": v for k, v in weights["blocks"].items()})
    return out


def straight_through(cast: Optional[Callable]) -> Optional[Callable]:
    """A cast whose forward rounds and whose gradient passes through."""
    if cast is None:
        return None
    return lambda x, axis: x + (cast(x.detach(), axis) - x).detach()


def _layer_leaves(weights: dict, li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li].float().requires_grad_(True) for k, v in weights["blocks"].items()}


def micro_batch(weights: dict, s: Dict, ids: torch.Tensor, plen: torch.Tensor,
                t: torch.Tensor, u: torch.Tensor, acc: Dict[str, torch.Tensor],
                aux_coef: float, cast: Optional[Callable] = None) -> float:
    """Adds one micro-batch's gradient to ``acc`` (flat names, float32) and
    returns its loss.  ids [B, L]; plen, t [B]; u [B, L]."""
    cast = straight_through(cast)
    B, L = ids.shape
    dev = ids.device
    mask_id, nl = s["mask_token_id"], s["num_layers"]
    p_mask = ((1.0 - EPS_MASK) * t + EPS_MASK)[:, None].expand(B, L)
    noisy = torch.where(u < p_mask, mask_id, ids)
    prompt = torch.arange(L, device=dev)[None, :] < plen[:, None]
    noisy = torch.where(prompt, ids, noisy)
    answer = (L - plen).clamp_min(1).float()
    masked = ((noisy == mask_id) & (ids != mask_id)).float()
    if masked.sum() == 0:
        return 0.0
    ones = torch.ones_like(ids)
    pos = ref.positions(ones)

    xs: List[torch.Tensor] = [weights["embed"][noisy.clamp(0, s["vocab_size"] - 1)].float()]
    aux = []
    with torch.no_grad():
        for li in range(nl):
            lw = {k: v[li].float() for k, v in weights["blocks"].items()}
            x, a = ref.block(xs[-1], lw, s, ones, pos, cast)
            xs.append(x)
            aux.append(float(a))

    x = xs[-1].detach().requires_grad_(True)
    norm_w = weights["final_norm"].float().requires_grad_(True)
    head = weights["lm_head"].float().requires_grad_(True)
    logits = ref.linear(ref.rms_norm(x, norm_w, s["norm_eps"]), head, cast)
    lse = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, ids[..., None])[..., 0]
    token = torch.nan_to_num(lse - target, nan=0.0, posinf=10.0, neginf=0.0)
    ce = torch.sum(token / p_mask / answer[:, None] * masked) / B
    gx, g_norm, g_head = torch.autograd.grad(ce, [x, norm_w, head])
    acc["final_norm"] += g_norm
    acc["lm_head"] += g_head
    del logits, lse, target, token, g_head
    aux_w = aux_coef / nl if s["num_experts"] else 0.0
    for li in reversed(range(nl)):
        xin = xs[li].detach().requires_grad_(True)
        lw = _layer_leaves(weights, li)
        out, a = ref.block(xin, lw, s, ones, pos, cast)
        outs, grads_out = [out], [gx]
        if aux_w:
            outs.append(a)
            grads_out.append(torch.full_like(a, aux_w))
        names = list(lw)
        grads = torch.autograd.grad(outs, [xin] + [lw[k] for k in names], grads_out,
                                    allow_unused=True)
        gx = grads[0]
        for k, g in zip(names, grads[1:]):
            if g is not None:
                acc[f"blocks/{k}"][li] += g
        del out, lw, grads
    acc["embed"].index_add_(0, noisy.reshape(-1).clamp(0, s["vocab_size"] - 1),
                            gx.reshape(-1, gx.shape[-1]))
    return float(ce.detach()) + aux_coef * (sum(aux) / nl if s["num_experts"] else 0.0)


CHUNK = 1 << 24   # elements at a time: no leaf-sized float32 temporaries


def sq_sum(x: torch.Tensor) -> float:
    """Σ x² in float64, a chunk at a time."""
    f = x.reshape(-1)
    return sum(float(torch.sum(f[lo:lo + CHUNK].double() ** 2))
               for lo in range(0, f.numel(), CHUNK))


@dataclass
class Moment:
    """A first or second moment of ``n`` elements: float32 ``value``, or
    int8 ``q`` [blocks, block] with a float32 ``scale`` a block, over the
    flattened leaf padded with zeros to whole blocks."""
    n: int
    value: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None

    @property
    def block(self) -> int:
        return self.q.shape[1] if self.q is not None else 1

    def read(self, lo: int, hi: int):
        """(values, half a step of their blocks or 0) of flattened
        elements lo .. hi, whole blocks, as float32."""
        if self.q is None:
            return self.value[lo:hi], 0.0
        b = self.block
        q, sc = self.q[lo // b:hi // b], self.scale[lo // b:hi // b]
        half = torch.where((q != 0).any(dim=-1), 0.5 * sc, torch.zeros_like(sc))
        return ((q.float() * sc[:, None]).reshape(-1),
                half[:, None].expand(q.shape).reshape(-1))

    def write(self, lo: int, x: torch.Tensor) -> None:
        if self.q is None:
            self.value[lo:lo + x.numel()] = x
            return
        b = self.block
        q, sc = _quantize_blocks(x.reshape(-1, b))
        self.q[lo // b:lo // b + q.shape[0]] = q
        self.scale[lo // b:lo // b + q.shape[0]] = sc

    def norm(self) -> float:
        total = 0.0
        for lo in range(0, self.padded, CHUNK // self.block * self.block):
            v, _ = self.read(lo, min(lo + CHUNK // self.block * self.block, self.padded))
            total += float(torch.sum(v.double() ** 2))
        return math.sqrt(total)

    @property
    def padded(self) -> int:
        return self.q.numel() if self.q is not None else self.n


def block_size(shape) -> int:
    """256 along the last dimension where it divides, else 128, else the
    flattened leaf in blocks of 256."""
    if len(shape) >= 2:
        for b in (BLOCK, 128):
            if shape[-1] % b == 0:
                return b
    return BLOCK


def _quantize_blocks(v: torch.Tensor):
    """(q int8, scale) of float32 blocks [n, block]: scale absmax/127 (1
    for an all-zero block), q rounded half to even."""
    amax = v.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(v / scale[:, None]), -127, 127).to(torch.int8), scale


def zeros(p: torch.Tensor, int8: bool) -> Moment:
    n = p.numel()
    if not int8:
        return Moment(n=n, value=torch.zeros(n, dtype=torch.float32, device=p.device))
    b = block_size(p.shape)
    nb = -(-n // b)
    return Moment(n=n, q=torch.zeros((nb, b), dtype=torch.int8, device=p.device),
                  scale=torch.ones(nb, dtype=torch.float32, device=p.device))


@dataclass
class Adam:
    lr: Callable[[int], float]
    int8: bool
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    count: int = 0


def warmup_cosine(peak: float, warmup: int, total: int) -> Callable[[int], float]:
    """0 → peak linearly over ``warmup`` steps, then a cosine to 0 at
    ``total``; read at the step's count before it is taken."""
    def lr(c: int) -> float:
        if c < warmup:
            return peak * c / warmup
        k = min(c - warmup, total - warmup)
        return peak * 0.5 * (1.0 + math.cos(math.pi * k / (total - warmup)))
    return lr


@torch.no_grad()
def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           mu: Dict[str, Moment], nu: Dict[str, Moment], opt: Adam) -> float:
    """Clip and AdamW, in place, a chunk of whole blocks at a time; returns
    the gradient's global norm."""
    norm = math.sqrt(sum(sq_sum(g) for g in grads.values()))
    scale = min(1.0, opt.max_grad_norm / max(norm, 1e-16))
    c = opt.count + 1
    c1, c2 = 1.0 - opt.b1 ** c, 1.0 - opt.b2 ** c
    lr = opt.lr(opt.count)
    for k, p in params.items():
        m_, v_ = mu[k], nu[k]
        decay = opt.weight_decay if not any(t in k for t in NO_DECAY) else 0.0
        p1, g1, n = p.reshape(-1), grads[k].reshape(-1), p.numel()
        step = CHUNK // m_.block * m_.block
        for lo in range(0, m_.padded, step):
            hi = min(lo + step, m_.padded)
            end = min(hi, n)
            g = F.pad(g1[lo:end] * scale, (0, hi - end))
            m_prev, _ = m_.read(lo, hi)
            v_prev, v_err = v_.read(lo, hi)
            m = opt.b1 * m_prev + (1.0 - opt.b1) * g
            v = opt.b2 * v_prev + (1.0 - opt.b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2 + opt.b2 * v_err / c2) + opt.eps)
            m_.write(lo, m)
            v_.write(lo, v)
            pf = p1[lo:end].float()
            u = u[:end - lo] + decay * pf
            p1[lo:end] = (pf - lr * u).to(p.dtype)
    opt.count = c
    return norm


def step(weights: dict, s: Dict, feed: Tuple, mu, nu, opt: Adam, aux_coef: float,
         cast: Optional[Callable] = None) -> float:
    """One optimizer step over the micro-batches of ``feed`` = (ids [A, B,
    L], prompt lengths [A, B], t [A, B], u [A, B, L]); returns its loss,
    the micro-batches' mean."""
    ids, plens, t, u = feed
    params = flat(weights)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    a = ids.shape[0]
    loss = sum(micro_batch(weights, s, ids[i], plens[i], t[i], u[i], acc, aux_coef, cast)
               for i in range(a)) / a
    for g in acc.values():
        g.div_(a)
    update(params, acc, mu, nu, opt)
    return loss
