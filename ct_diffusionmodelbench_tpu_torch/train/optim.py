"""Learning-rate schedules, global-norm clipping and AdamW with optax's
arithmetic, with f32 or low-precision moments.

Counterpart of ``train/trainer.py::make_optimizer`` and ``train/optim.py``:
``optax.chain(clip, adamw)`` where the clip is optax's
``clip_by_global_norm`` for f32 gradient accumulation and
:func:`clip_by_global_norm_f32` for bf16, and ``adamw`` is optax's
(:class:`AdamW`, f32 moments) or ``adamw_lowp`` (:class:`AdamWLowp`, bf16
or blockwise-int8 moments).  ``torch.optim.AdamW`` is not used: it decays
the weights before the Adam step, where optax adds the decay term to the
Adam update.  Per leaf, in optax's order (:class:`AdamW`):

    g     ← (g / ‖g‖) · max_norm        unless ‖g‖ < max_norm
    m     ← (1 − b1) g + b1 m           (f32)
    v     ← (1 − b2) g² + b2 v          (f32)
    u     ← (m / (1 − b1^c)) / (√(v / (1 − b2^c)) + eps),   c = count + 1
    u     ← u + wd · p                   (decayed leaves; wd · p in p's dtype)
    p     ← p.dtype(f32(p) − lr(count) · u)

The schedule is read at the count *before* the increment, so the first step
of a warm-up from 0 runs at lr 0.  Moments are f32 whatever the parameter
dtype (optax's bf16 zeros turn f32 on the first update).  Everything updates
in place: a parameter tensor keeps its storage.

:class:`AdamWLowp` runs the reference's ``scale_by_adam_lowp`` arithmetic:
the moments decoded to f32, ``m ← b1 m + (1 − b1) g``, ``v ← b2 v + ((1 −
b2) g) g``, ``u ← m̂ / (√(v̂ + b2·v_err / c2) + eps)`` where ``v_err`` is the
previous int8 ν's per-block half step (0 for all-zero blocks and for bf16
state), the moments encoded back; ``u`` cast to the update dtype, then the
decay and learning-rate stages keep that dtype when it is bf16.  int8
moments are :class:`Quantized` in the reference's two layouts.  The update
runs leaf by leaf in chunks of whole quantization blocks
(:data:`CHUNK_ELEMS`), so no f32 temporary larger than a chunk exists;
blocks lie along the flattened leaf, so the result does not depend on the
chunk size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Tuple, Union

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.parallel.comm import all_reduce_

Schedule = Callable[[int], float]
NO_DECAY = ("norm", "bias", "bq", "bk", "bv")  # leaf-name fragments
QUANT_BLOCK = 256
# Elements of a leaf per step of the chunked moment update: 16 M (64 MB per
# f32 temporary).  The reference's CHUNK_ROWS is a TPU memory tuning; this
# is the port's own.
CHUNK_ELEMS = 1 << 24
STATE_DTYPES = ("float32", "bfloat16", "int8")
UPDATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x: float) -> float:
    return float(np.float32(x))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``transition_steps``, then end."""
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return _f32(init_value)
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return _f32((init_value - end_value) * frac + end_value)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1)."""
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        c = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return _f32(peak_value * ((1.0 - alpha) * decay + alpha))
    return schedule


def flatten_params(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict → {"blocks/wq": tensor, ...} in sorted key order (the
    order of ``jax.tree.leaves`` on the same dict)."""
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(tree):
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            out.update(flatten_params(tree[key], name))
        else:
            out[name] = tree[key]
    return out


def unflatten_params(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def decays(name: str) -> bool:
    """HF AdamW's mask: no weight decay for norm scales and biases."""
    return not any(t in name for t in NO_DECAY)


def _sum_sq(t: torch.Tensor) -> torch.Tensor:
    """Σ x² in f32, in chunks of :data:`CHUNK_ELEMS` so no leaf-sized f32
    square exists (a bf16 expert stack's would be 8.5 GB at full size)."""
    flat = t.reshape(-1)
    return sum(torch.sum(torch.square(flat[lo:lo + CHUNK_ELEMS].float()))
               for lo in range(0, flat.numel(), CHUNK_ELEMS))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32 (:func:`_sum_sq` per leaf)."""
    return torch.sqrt(sum(_sum_sq(t) for t in tensors))


def sharded_global_norm(grads: Dict[str, torch.Tensor], sharded: Iterable[str],
                        mesh, staged: Iterable[str] = ()) -> torch.Tensor:
    """The global norm of a tree whose ``sharded`` leaves each model rank
    holds a slice of (``parallel/``): their squares are summed over the
    model group, the replicated leaves' (equal on every rank) counted once;
    f32 throughout.  ``staged`` leaves (a pipeline's layer stacks) each
    stage holds its own layers of: their squares, model-summed where they
    are also ``sharded``, are summed over the stage group.  Every rank of
    the groups gets the same norm, so the clip that follows is the same
    everywhere."""
    sharded, staged = set(sharded), set(staged) if mesh.stage > 1 else set()
    dev = next(iter(grads.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    part = zero + sum(_sum_sq(g) for k, g in grads.items() if k in sharded)
    if mesh.model > 1:
        all_reduce_(part, mesh.model_group, mesh)
    if staged:
        part = part + sum(_sum_sq(g) for k, g in grads.items()
                          if k in staged and k not in sharded)
        all_reduce_(part, mesh.stage_group, mesh)
    whole = zero + sum(_sum_sq(g) for k, g in grads.items()
                       if k not in sharded and k not in staged)
    return torch.sqrt(whole + part)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor,
                        max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: g / ‖g‖ · max_norm
    unless ‖g‖ < max_norm."""
    if not bool(grad_norm < max_norm):
        for g in grads.values():
            g.div_(grad_norm.to(g.dtype)).mul_(max_norm)


def clip_by_global_norm_f32(grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor,
                            max_norm: float) -> None:
    """The reference's ``clip_by_global_norm_f32``, in place: each leaf
    times min(1, max_norm / max(‖g‖, 1e-16)) in f32, cast back to its dtype
    (``grad_norm`` is ‖g‖ summed in f32, :func:`global_norm`)."""
    norm = torch.clamp_min(grad_norm.float(), 1e-16)
    scale = float(torch.clamp(torch.full_like(norm, max_norm) / norm, max=1.0))
    if scale != 1.0:
        for g in grads.values():
            g.mul_(scale)   # the f32 scale on f32 opmath, rounded to g's dtype


@dataclass
class Quantized:
    """Blockwise int8 tensor in one of the reference's two layouts: rowwise,
    ``q`` int8 in the leaf's own shape and ``scale`` f32 ``shape[:-1] +
    (G,)`` over minor-axis blocks of 256 (128 where only that divides the
    minor dim, e.g. Fm 896); or flat, ``q`` [Nb, 256] over the flattened,
    zero-padded leaf and ``scale`` [Nb, 1].  ``shape`` is the leaf's (the
    reference keeps it as the zero-size ``meta`` array)."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def rowwise(self) -> bool:
        return tuple(self.q.shape) == tuple(self.shape)

    @property
    def block(self) -> int:
        return self.q.shape[-1] // self.scale.shape[-1] if self.rowwise else self.q.shape[-1]


def _row_block(shape, block: int = QUANT_BLOCK):
    """Largest of (block, 128) dividing the minor dim of a >= 2-D shape, or
    None (the flat layout)."""
    if len(shape) < 2:
        return None
    return next((b for b in (block, 128) if shape[-1] % b == 0), None)


def _quant_blocks(x: torch.Tensor):
    """(q int8, scale f32 [..., 1]) of f32 blocks along x's last dim: scale
    absmax / 127 (1 for all-zero blocks; the product with the f32
    reciprocal, as XLA evaluates the reference's division), q = round half
    to even of x / scale."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * (1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor, block: int = QUANT_BLOCK) -> Quantized:
    """The reference's ``quantize_int8``: rowwise where a block divides the
    minor dim, else flat."""
    shape = tuple(x.shape)
    rb = _row_block(shape, block)
    if rb is not None:
        q, scale = _quant_blocks(x.float().reshape(shape[:-1] + (shape[-1] // rb, rb)))
        return Quantized(q.reshape(shape), scale[..., 0], shape)
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    q, scale = _quant_blocks(flat.reshape(-1, block))
    return Quantized(q, scale, shape)


def _blocks(t: Quantized):
    """(q [Nb, B], scale [Nb, 1]) views of either layout, in the flattened
    leaf's block order."""
    b = t.block
    return t.q.reshape(-1, b), t.scale.reshape(-1, 1)


def dequantize_int8(t: Quantized) -> torch.Tensor:
    q, scale = _blocks(t)
    n = math.prod(t.shape)
    return (q.float() * scale).reshape(-1)[:n].reshape(t.shape)


def _block_err(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-block dequantization error [Nb, 1]: half a step, but 0 for
    all-zero blocks (their scale is the division guard)."""
    return torch.where((q != 0).any(dim=-1, keepdim=True), 0.5 * scale, 0.0)


def dequantize_err(t: Quantized) -> torch.Tensor:
    """Per-element error bound of ``t`` in the leaf's shape."""
    q, scale = _blocks(t)
    n = math.prod(t.shape)
    return _block_err(q, scale).expand(q.shape).reshape(-1)[:n].reshape(t.shape)


def zeros_int8(shape, device) -> Quantized:
    """``quantize_int8`` of zeros without an f32 staging copy."""
    shape = tuple(shape)
    rb = _row_block(shape)
    if rb is not None:
        return Quantized(torch.zeros(shape, dtype=torch.int8, device=device),
                         torch.ones(shape[:-1] + (shape[-1] // rb,),
                                    dtype=torch.float32, device=device), shape)
    nb = -(-math.prod(shape) // QUANT_BLOCK)
    return Quantized(torch.zeros((nb, QUANT_BLOCK), dtype=torch.int8, device=device),
                     torch.ones((nb, 1), dtype=torch.float32, device=device), shape)


Moment = Union[torch.Tensor, Quantized]


@dataclass
class AdamWState:
    count: int
    mu: Dict[str, Moment]
    nu: Dict[str, Moment]


class AdamW:
    """The clip (optax's, or :func:`clip_by_global_norm_f32` with
    ``clip_f32``) then optax's ``adamw``, in place on flat parameter dicts
    (see the module docstring for the arithmetic)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, clip_f32: bool = False):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.clip = clip_by_global_norm_f32 if clip_f32 else clip_by_global_norm

    def _bias_corrections(self, count: int):
        return tuple(_f32(np.float32(1.0) - np.power(np.float32(b), np.float32(count)))
                     for b in (self.b1, self.b2))

    def init(self, params: dict) -> AdamWState:
        flat = flatten_params(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return AdamWState(count=0, mu={k: zeros(p) for k, p in flat.items()},
                          nu={k: zeros(p) for k, p in flat.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor],
               grad_norm: torch.Tensor) -> AdamWState:
        """Apply one step to the flat ``params`` in place.  ``grads`` are
        clipped in place; ``grad_norm`` is their global norm in f32."""
        self.clip(grads, grad_norm, self.max_grad_norm)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        bc1, bc2 = self._bias_corrections(count)
        step = -self.schedule(state.count)
        for name, p in params.items():
            g = grads[name]
            m, v = state.mu[name], state.nu[name]
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1.0 - b2))
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay and decays(name):
                u.add_(p * self.weight_decay)
            p.copy_(u.mul_(step).add_(p))
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


class AdamWLowp(AdamW):
    """The clip then the reference's ``adamw_lowp``: moments stored in
    ``state_dtype`` (float32, bfloat16 or int8), the Adam arithmetic in f32,
    the update emitted in ``update_dtype`` (float32 or bfloat16) and kept in
    it through the decay and learning-rate stages; chunked leaf by leaf
    (module docstring)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, clip_f32: bool = False,
                 state_dtype: str = "float32", update_dtype: str = "float32"):
        if state_dtype not in STATE_DTYPES:
            raise ValueError(f"unknown optimizer state dtype {state_dtype!r}")
        if update_dtype not in UPDATE_DTYPES:
            raise ValueError(f"unknown optimizer update dtype {update_dtype!r}")
        super().__init__(schedule, b1, b2, eps, weight_decay, max_grad_norm, clip_f32)
        self.state_dtype = state_dtype
        self.update_dtype = UPDATE_DTYPES[update_dtype]

    def init(self, params: dict) -> AdamWState:
        def zeros(p):
            if self.state_dtype == "int8":
                return zeros_int8(p.shape, p.device)
            return torch.zeros(p.shape, dtype=getattr(torch, self.state_dtype),
                               device=p.device)
        flat = flatten_params(params)
        return AdamWState(count=0, mu={k: zeros(p) for k, p in flat.items()},
                          nu={k: zeros(p) for k, p in flat.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor],
               grad_norm: torch.Tensor) -> AdamWState:
        self.clip(grads, grad_norm, self.max_grad_norm)
        count = state.count + 1
        c1, c2 = self._bias_corrections(count)
        step = -self.schedule(state.count)
        for name, p in params.items():
            self._leaf(p, grads[name], state.mu[name], state.nu[name], c1, c2, step,
                       self.weight_decay if decays(name) else 0.0)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)

    def _leaf(self, p, g, mu, nu, c1, c2, step, wd):
        b1, b2 = self.b1, self.b2
        n = p.numel()
        p1, g1 = p.reshape(-1), g.reshape(-1)
        if isinstance(mu, Quantized):
            block = mu.block
            (qm, sm), (qn, sn) = _blocks(mu), _blocks(nu)
            total = qm.numel()            # n, or n padded to whole blocks
        else:
            block, total = 1, n
            m1, n1 = mu.reshape(-1), nu.reshape(-1)
        chunk = max(block, CHUNK_ELEMS // block * block)
        for lo in range(0, total, chunk):
            hi = min(lo + chunk, total)
            end = min(hi, n)
            g32 = g1[lo:end].float()
            if isinstance(mu, Quantized):
                if hi > end:   # the flat layout's zero-padded last block
                    g32 = torch.nn.functional.pad(g32, (0, hi - end))
                g32 = g32.reshape(-1, block)
                b_lo, b_hi = lo // block, hi // block
                m_prev = qm[b_lo:b_hi].float() * sm[b_lo:b_hi]
                v_prev = qn[b_lo:b_hi].float() * sn[b_lo:b_hi]
                v_err = _block_err(qn[b_lo:b_hi], sn[b_lo:b_hi])
            else:
                m_prev, v_prev, v_err = m1[lo:hi].float(), n1[lo:hi].float(), 0.0
            m = b1 * m_prev + (1.0 - b1) * g32
            v = b2 * v_prev + (1.0 - b2) * g32 * g32
            del m_prev, v_prev
            u = (m / c1) / (torch.sqrt(v / c2 + (b2 * v_err) / c2) + self.eps)
            if isinstance(mu, Quantized):
                qm[b_lo:b_hi], sm[b_lo:b_hi] = _quant_blocks(m)
                qn[b_lo:b_hi], sn[b_lo:b_hi] = _quant_blocks(v)
            else:
                m1[lo:hi], n1[lo:hi] = m, v
            del m, v
            u = u.reshape(-1)[:end - lo].to(self.update_dtype)
            pc = p1[lo:end]
            if self.update_dtype == torch.float32:   # optax's decay and lr stages
                if wd:
                    u = u + pc * wd
                u = u * step
            else:                                     # the keep-dtype stages
                if wd:
                    u = (u.float() + wd * pc.float()).to(self.update_dtype)
                u = (u.float() * step).to(self.update_dtype)
            pc.copy_(pc + u)


# ---------------------------------------------------------------------------
# optimizer state under the reference's key names
# ---------------------------------------------------------------------------
# The reference saves its optax chain state ``(clip state, (adam state,
# decay state, lr state))`` flattened by ``jax.tree_util.keystr``:
# ``[1][0].count``, ``[1][0].mu['blocks']['wq']`` (with ``.q``, ``.scale``
# and ``.meta`` for int8 moments), ``[1][0].nu[...]`` and ``[1][2].count``.

def _keypath(name: str) -> str:
    return "".join(f"['{part}']" for part in name.split("/"))


def state_tensors(state: AdamWState) -> Dict[str, torch.Tensor]:
    """The state as {reference key: tensor}."""
    count = torch.tensor(state.count, dtype=torch.int32)
    out = {"[1][0].count": count}
    for part in ("mu", "nu"):
        for name, t in getattr(state, part).items():
            key = f"[1][0].{part}{_keypath(name)}"
            if isinstance(t, Quantized):
                out[key + ".q"] = t.q
                out[key + ".scale"] = t.scale
                out[key + ".meta"] = torch.zeros((0,) + tuple(t.shape))
            else:
                out[key] = t
    out["[1][2].count"] = count.clone()
    return out


def load_state_tensors(state: AdamWState, flat: Dict[str, torch.Tensor]) -> AdamWState:
    """``state`` with every tensor overwritten in place from ``flat``
    (reference keys), cast to the state's dtypes; shapes and int8 layouts
    must match."""
    def put(dst: torch.Tensor, key: str):
        src = flat[key]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: saved shape {tuple(src.shape)}, state has "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))

    for part in ("mu", "nu"):
        for name, t in getattr(state, part).items():
            key = f"[1][0].{part}{_keypath(name)}"
            if isinstance(t, Quantized):
                if tuple(flat[key + ".meta"].shape[1:]) != tuple(t.shape):
                    raise ValueError(f"{key}: saved for shape "
                                     f"{tuple(flat[key + '.meta'].shape[1:])}")
                put(t.q, key + ".q")
                put(t.scale, key + ".scale")
            else:
                put(t, key)
    return AdamWState(count=int(flat["[1][0].count"]), mu=state.mu, nu=state.nu)
