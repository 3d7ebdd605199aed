"""The decode cells' comparison with the plain reference.

A masked-diffusion decode commits a few tokens a step: at each step the
sampler runs the model over the whole sequence, takes each masked
position's greedy token and its probability, and unmasks the most
confident positions of the current block.  Which positions it takes turns
on near-ties of those probabilities, so a reference that re-ran the decode
would part from the program's path at the first tie it broke the other way,
and every later step would be judged against a context the program never
saw.  So the comparison follows the program's own path: the sequence as it
stood before each step (recorded where the sampler hands it to the model),
and judges each step's transition against the reference run on that same
sequence.  Its parts:

- ``structure`` (exact, limit 0): the first state is the padded prompt
  followed by masks; each step unmasks exactly the count the schedule
  gives (with a ``parallel_threshold``, at least one and at most
  ``block_length`` steps a block), inside its block, and changes nothing
  else; the last step gives the output returned; no mask is left.  Every step of each sampled request
  is checked, and every completed request's output is checked for masks.
- ``token_gap``: for each committed token, the reference's best logit at
  that position minus the reference's logit of the committed token (with
  ``avoid_eos``, the best of the tokens other than EOS, as the sampler).
- ``order_gap``: how far the least confident committed position (by the
  reference's probability of the committed token) lies below the most
  confident position the step left masked (by the reference's best
  probability), in log probability; 0 where the order agrees.

Both gaps are the widest over a sample of steps of a sample of requests
drawn from the seed, with the longest request always in it; their means
over the sample are steadier (:func:`stats`).  A cell's limits file names
the numbers it holds to limits, each with its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import llada as ref


@dataclass
class Trajectory:
    prompt: torch.Tensor     # [P] padded prompt ids
    mask: torch.Tensor       # [P] 1 = real token
    states: List[torch.Tensor]   # the sequence [S] before each step
    final: torch.Tensor      # [S] the output returned


def schedule(n_masked: int, steps: int) -> List[int]:
    """Tokens unmasked at each step of a block: n // steps each, the first
    n % steps steps one more."""
    base, extra = divmod(n_masked, steps)
    return [base + (i < extra) for i in range(steps)]


def structure_faults(t: Trajectory, mix: dict, mask_id: int) -> int:
    """The count of the trajectory's departures from the sampler's rules."""
    gen = mix["generate"]
    steps, bl = gen["steps"], gen["block_length"]
    n_blocks = gen["gen_length"] // bl
    threshold = gen.get("parallel_threshold") is not None
    spb = steps // n_blocks
    P = t.prompt.shape[0]
    faults = int(len(t.states) > n_blocks * bl if threshold else len(t.states) != steps)
    if not t.states:
        return faults + 1
    start = torch.cat([t.prompt, torch.full((gen["gen_length"],), mask_id,
                                            dtype=t.prompt.dtype, device=t.prompt.device)])
    faults += int(not torch.equal(t.states[0].to(start.device), start))
    seq = t.states + [t.final]
    counts: List[int] = []
    for i in range(len(t.states) if threshold else min(len(t.states), steps)):
        cur, nxt = seq[i], seq[i + 1].to(seq[i].device)
        lo = block_start(t, i, mix, mask_id)
        hi = lo + bl
        if not threshold and (i % spb) == 0:
            counts = schedule(int((cur[lo:hi] == mask_id).sum()), spb)
        changed = torch.nonzero(cur != nxt).flatten()
        inside = bool(((changed >= lo) & (changed < hi)).all())
        was_masked = bool((cur[changed] == mask_id).all())
        unmasked = bool((nxt[changed] != mask_id).all())
        count = changed.numel() >= 1 if threshold else changed.numel() == counts[i % spb]
        faults += int(not (inside and was_masked and unmasked and count))
    faults += int((t.final[P:] == mask_id).any())
    return faults


def block_start(t: Trajectory, i: int, mix: dict, mask_id: int) -> int:
    """The first position of the block that step i works on: the
    schedule's block, or with a ``parallel_threshold`` the first block that
    still holds a mask."""
    gen = mix["generate"]
    bl, P = gen["block_length"], t.prompt.shape[0]
    if gen.get("parallel_threshold") is None:
        return P + (i // (gen["steps"] // (gen["gen_length"] // bl))) * bl
    masked = torch.nonzero(t.states[i][P:] == mask_id).flatten()
    return P + (int(masked[0]) // bl) * bl if masked.numel() else P


def _step_items(t: Trajectory, i: int, mix: dict, mask_id: int):
    """(sequence before step i, after it, block start) of trajectory t."""
    nxt = t.states[i + 1] if i + 1 < len(t.states) else t.final
    return t.states[i], nxt, block_start(t, i, mix, mask_id)


def gaps(logits: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor, mask_id: int,
         chosen: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """A step's gaps under reference logits [bl, V] of its block.
    ``cur``/``nxt``: the block's tokens before and after the step; where
    ``chosen`` (bool [bl]) is given, the committed positions are those and
    their tokens are ``nxt`` there.  Besides the two widest gaps, the sum
    of the token gaps (``gap_sum``), the tokens committed (``n``) and those
    that are not the reference's greedy token (``flips``)."""
    masked = cur == mask_id
    committed = (cur != nxt) if chosen is None else chosen
    lsm = torch.log_softmax(logits, dim=-1)
    tok = nxt.long().clamp(0, logits.shape[-1] - 1)
    mine = logits.gather(-1, tok[:, None])[:, 0]
    best = logits.max(dim=-1).values
    out = {"token_gap": 0.0, "order_gap": 0.0, "gap_sum": 0.0, "n": 0, "flips": 0}
    if committed.any():
        gap = (best - mine)[committed]
        out.update(token_gap=float(gap.max()), gap_sum=float(gap.sum()),
                   n=int(committed.sum()),
                   flips=int((logits.argmax(dim=-1) != tok)[committed].sum()))
        left = masked & ~committed
        if left.any():
            conf = lsm.gather(-1, tok[:, None])[:, 0]
            out["order_gap"] = max(0.0, float(lsm.max(dim=-1).values[left].max()
                                              - conf[committed].min()))
    return out


def sample(trajs: List[Trajectory], lengths: List[int], mix: dict,
           rng: np.random.Generator):
    """(request, step) pairs to judge: ``check.requests`` requests, the
    longest always among them, ``check.steps_per_request`` steps of each."""
    check = mix["check"]
    n = min(check["requests"], len(trajs))
    longest = int(np.argmax(lengths))
    rest = [i for i in rng.permutation(len(trajs)) if i != longest][:n - 1]
    pairs = []
    for r in [longest] + [int(i) for i in rest]:
        k = min(check["steps_per_request"], len(trajs[r].states))
        pairs += [(r, int(i)) for i in np.sort(rng.choice(len(trajs[r].states), k,
                                                          replace=False))]
    return pairs


def judge(trajs: List[Trajectory], pairs, weights: dict, s: Dict, mix: dict,
          control=None):
    """(the widest gaps over ``pairs``, {request: its widest gaps}) under
    the float32 reference, in chunks of ``check.rows_per_forward``
    sequences.  ``control`` (a cast, ``portbench/reference/control.py``):
    also the gaps of the tokens and positions that the reference computed
    under that cast would commit, under ``control_*`` names."""
    gen = mix["generate"]
    mask_id, bl = s["mask_token_id"], gen["block_length"]
    eos = s["eos_token_id"] if gen.get("avoid_eos") else None
    chunk = mix["check"]["rows_per_forward"]
    sides = ("", "control_") if control is not None else ("",)
    totals = {side: _zero() for side in sides}
    per_request = {r: _zero() for r, _ in pairs}
    for c in range(0, len(pairs), chunk):
        part = pairs[c:c + chunk]
        items = [_step_items(trajs[r], i, mix, mask_id) for r, i in part]
        dev = items[0][0].device
        full_mask = torch.stack([torch.cat([trajs[r].mask.to(dev),
                                            torch.ones(gen["gen_length"], dtype=trajs[r].mask.dtype,
                                                       device=dev)]) for r, _ in part])
        ids = torch.stack([cur for cur, _, _ in items])
        hidden = ref.final_hidden(weights, s, ids, full_mask)
        hidden_c = (ref.final_hidden(weights, s, ids, full_mask, control)
                    if control is not None else None)
        head = weights["lm_head"].float()
        for row, (cur, nxt, lo) in enumerate(items):
            logits = _no_eos(ref.linear(hidden[row, lo:lo + bl], head), eos)
            blk, nb = cur[lo:lo + bl], nxt[lo:lo + bl].to(dev)
            g = {"": gaps(logits, blk, nb, mask_id)}
            if control is not None:
                g["control_"] = _control_gaps(
                    logits, _no_eos(ref.linear(hidden_c[row, lo:lo + bl], head, control), eos),
                    blk, nb, mask_id)
            _fold(per_request[part[row][0]], g[""])
            for side in sides:
                _fold(totals[side], g[side])
    worst = {}
    for side in sides:
        worst.update({side + k: v for k, v in stats(totals[side]).items()})
    return worst, {r: stats(acc) for r, acc in per_request.items()}


def _no_eos(logits: torch.Tensor, eos: Optional[int]) -> torch.Tensor:
    """The logits with EOS never the best, as the sampler's ``avoid_eos``."""
    if eos is not None:
        logits[:, eos] = float("-inf")
    return logits


def _zero() -> dict:
    return {"token_gap": 0.0, "order_gap": 0.0, "gap_sum": 0.0, "n": 0, "flips": 0,
            "order_sum": 0.0, "steps": 0}


def _fold(acc: dict, g: dict) -> None:
    for k in ("token_gap", "order_gap"):
        acc[k] = max(acc[k], g[k])
    for k in ("gap_sum", "n", "flips"):
        acc[k] += g[k]
    acc["order_sum"] += g["order_gap"]
    acc["steps"] += 1


def stats(acc: dict) -> Dict[str, float]:
    """The numbers a comparison may hold to limits: the widest token and
    order gaps; the mean token gap over the committed tokens and the share
    of them that are not the reference's greedy token; the mean order gap
    over the judged steps."""
    return {"token_gap": acc["token_gap"], "order_gap": acc["order_gap"],
            "token_gap_mean": acc["gap_sum"] / max(acc["n"], 1),
            "flip_share": acc["flips"] / max(acc["n"], 1),
            "order_gap_mean": acc["order_sum"] / max(acc["steps"], 1)}


def _control_gaps(logits, logits_c, cur, nxt, mask_id):
    """The gaps of the control's own step at the program's state: its
    greedy tokens at the masked positions, and as many positions as the
    program committed, chosen by its own probabilities."""
    masked = cur == mask_id
    k = int((cur != nxt).sum())
    pick = logits_c.argmax(dim=-1)
    conf = torch.log_softmax(logits_c, dim=-1).max(dim=-1).values
    conf = torch.where(masked, conf, torch.full_like(conf, float("-inf")))
    chosen = torch.zeros_like(masked)
    chosen[torch.argsort(-conf, stable=True)[:k]] = True
    return gaps(logits, cur, torch.where(chosen, pick.to(cur.dtype), cur), mask_id, chosen)
