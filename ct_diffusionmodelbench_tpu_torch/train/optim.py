"""Learning-rate schedules, global-norm clipping and AdamW with optax's
arithmetic.

Counterpart of the f32 path of ``train/trainer.py::make_optimizer``:
``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2, eps,
weight_decay, mask=decay_mask))``.  ``torch.optim.AdamW`` is not used: it
decays the weights before the Adam step, where optax adds the decay term to
the Adam update.  Per leaf, in optax's order:

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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable

import numpy as np
import torch

Schedule = Callable[[int], float]
NO_DECAY = ("norm", "bias", "bq", "bk", "bv")  # leaf-name fragments


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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """``clip_by_global_norm`` then optax's ``adamw``, in place on flat
    parameter dicts (see the module docstring for the arithmetic)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

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
        """Apply one step to the flat ``params`` in place.  ``grads`` are f32
        and are clipped in place; ``grad_norm`` is their global norm."""
        if not bool(grad_norm < self.max_grad_norm):
            for g in grads.values():
                g.div_(grad_norm).mul_(self.max_grad_norm)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        bc1 = _f32(np.float32(1.0) - np.power(np.float32(b1), np.float32(count)))
        bc2 = _f32(np.float32(1.0) - np.power(np.float32(b2), np.float32(count)))
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
