"""The training cells' comparison with the plain reference.

Three numbers, each the worst over its parts:

- ``loss_gap``: each of the first steps' loss against the reference's,
  |program − reference| / |reference|.
- ``grad_gap``: each leaf's norm of the first gradient as the optimizer
  got it (clipped), worked out from the first moment after one step (over
  1 − β1), against the reference's: |program − reference| over the larger
  of the reference's norm of that leaf and of the median leaf.
- ``change_gap``: the same of each leaf's norm of the parameters' change
  over the first steps.  Leaves whose first gradient in the reference is
  under a thousandth of the median leaf's are left out: Adam moves them by
  round-off alone.

Norms are float32 sums of squares in float64.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from portbench.harness import model
from portbench.reference import train as ref_train

B1 = 0.9
NEGLIGIBLE = 1e-3


def _norm(x: torch.Tensor) -> float:
    return math.sqrt(ref_train.sq_sum(x))


def _moment_norm(m) -> float:
    """Norm of a moment: a tensor, or a blockwise int8 one with ``q`` and
    ``scale`` (blocks contiguous along the flattened leaf; padding is
    zero), a chunk of blocks at a time."""
    if not hasattr(m, "q"):
        return _norm(m)
    sc = m.scale.reshape(-1).float()
    q = m.q.reshape(sc.numel(), -1)
    rows = max(1, ref_train.CHUNK // q.shape[1])
    return math.sqrt(sum(float(torch.sum((q[lo:lo + rows].float()
                                          * sc[lo:lo + rows, None]).double() ** 2))
                         for lo in range(0, sc.numel(), rows)))


def moment_norms(mu: Dict, one_minus_b1: float) -> Dict[str, float]:
    """{leaf: norm of the gradient that made this first moment}."""
    return {k: _moment_norm(m) / one_minus_b1 for k, m in mu.items()}


@torch.no_grad()
def change_norms(params: dict, s: Dict, seed: int, device) -> Dict[str, float]:
    """{leaf: norm of (params now − params as drawn from the seed)}, the
    drawn leaves made again one at a time."""
    now = ref_train.flat(params)
    out = {}
    for name, p0 in model.iter_weights(s, seed, device):
        a, b, c = now[name].reshape(-1), p0.reshape(-1), ref_train.CHUNK
        out[name] = math.sqrt(sum(float(torch.sum((a[lo:lo + c].double()
                                                   - b[lo:lo + c].double()) ** 2))
                                  for lo in range(0, a.numel(), c)))
    return out


def reference_readings(run, s: Dict, feed, cast=None) -> Dict:
    """The reference's losses, first-gradient norms and change norms over
    the mix's first steps, on a fresh draw of the weights."""
    mix = run.mix
    ref_train.ref.strict_f32()
    weights = model.draw_weights(s, run.seed, run.device)
    params = ref_train.flat(weights)
    int8 = mix["optimizer_state_dtype"] == "int8"
    mu = {k: ref_train.zeros(p, int8) for k, p in params.items()}
    nu = {k: ref_train.zeros(p, int8) for k, p in params.items()}
    opt = ref_train.Adam(
        lr=ref_train.warmup_cosine(mix["learning_rate"], mix["warmup_steps"],
                                   max(mix["total_steps"], mix["warmup_steps"] + 1)),
        int8=int8, weight_decay=mix["weight_decay"], max_grad_norm=mix["max_grad_norm"])
    losses, first = [], {}
    for i in range(mix["check"]["steps"]):
        losses.append(ref_train.step(weights, s, feed.reference(i), mu, nu, opt,
                                     mix["aux_loss_coef"], cast))
        if i == 0:
            first = {k: m.norm() / (1.0 - B1) for k, m in mu.items()}
    del mu, nu
    change = change_norms(weights, s, run.seed, run.device)
    return {"losses": losses, "first": first, "change": change}


def leaf_gap(mine: Dict[str, float], theirs: Dict[str, float], leaves) -> float:
    med = statistics.median(theirs[k] for k in theirs)
    return max((abs(mine[k] - theirs[k]) / max(theirs[k], med, 1e-30) for k in leaves),
               default=0.0)


def compare(program: Dict, reference: Dict) -> Dict[str, float]:
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(program["losses"], reference["losses"]))
    first = reference["first"]
    med = statistics.median(first.values())
    moving = [k for k in first if first[k] >= NEGLIGIBLE * med]
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(program["first"], first, first),
            "change_gap": leaf_gap(program["change"], reference["change"], moving)}
