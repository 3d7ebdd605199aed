"""The SDAR cells' comparison with the plain reference, and their sizes.

SDAR decodes a block at a time against an exact cache of the prompt and
the blocks before it (the program's ``models/sdar_cache.py``): a prefill,
then ``steps_per_block`` denoising steps a block, each over the block's
tokens alone, then a commit of the finished block.  The benchmark records
what the sampler hands the model at ``ModelRunner.block_fns``: the padded
prompt and its mask at the prefill, each step's block and start, each
commit's block and start (:class:`Record`).  So the state a step saw is
the prompt, the blocks committed before it and its block, and the check
follows the program's own path, as ``decode_check.py`` does for LLaDA:

- ``structure`` (exact, limit 0): the prefill's prompt is the padded
  prompt handed in; every block gets ``steps_per_block`` steps at its
  start, the first on a block of masks, each unmasking exactly the
  schedule's count (``decode_check.schedule``) of masked positions and
  changing nothing else; each block is committed once, as its last step
  left it, with no mask; the output returned is the prompt followed by the
  committed blocks.  Every step of each sampled request is checked, and
  every completed request's output for masks.
- ``token_gap`` and ``order_gap`` (``decode_check.gaps``): each sampled
  step's transition judged against the reference's full block-causal
  forward of the step's state (``portbench/reference/sdar.py``), with no
  cache: prefix, committed blocks, current block.  The sampled states of
  one request run as one row (``reference/sdar.py::pack``): its prompt and
  committed blocks once, each state's block beside them seeing its own
  state's keys, so a forward costs about one state a request.

The sample is ``decode_check.sample``'s and the numbers ``decode_check.
stats``'s, so the limits mean what they mean for the LLaDA cells.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness import model
from portbench.harness.decode_check import (
    _control_gaps, _fold, _no_eos, _zero, gaps, schedule, stats)
from portbench.reference import sdar as ref

Step = Tuple[int, torch.Tensor]      # (block start, the block's tokens [B, bl] or [bl])


def sizes(conf: dict) -> Dict:
    """The harness's sizes of a configuration file (``harness/model.py``)
    with what an SDAR file implies: qk-norm on (Qwen3-MoE's, named by no
    config key) and the block length the file states."""
    s = model.sizes(conf)
    if str(conf.get("model_type", "")).startswith("sdar"):
        s["qk_norm"] = True
    s["block_length"] = int(conf["block_length"])
    return s


@dataclass
class Record:
    """What one ``generate_ids`` call handed ``ModelRunner.block_fns``."""
    prompt: torch.Tensor                     # [B, P] as the prefill got it
    mask: torch.Tensor                       # [B, P]
    steps: List[Step] = field(default_factory=list)
    commits: List[Step] = field(default_factory=list)


@dataclass
class Trajectory:
    """One request's path: its row of a :class:`Record` and its output."""
    prompt: torch.Tensor                     # [P]
    mask: torch.Tensor                       # [P]
    steps: List[Step]
    commits: List[Step]
    final: torch.Tensor                      # [P - pad + G], as returned

    @property
    def states(self) -> List[Step]:
        """One entry a step (``decode_check.sample`` counts them)."""
        return self.steps


def trajectories(record: Record, out, lengths: List[int], device) -> List[Trajectory]:
    """Each row of a batch's record as a trajectory, with the output row."""
    return [Trajectory(prompt=record.prompt[r], mask=record.mask[r],
                       steps=[(s, b[r]) for s, b in record.steps],
                       commits=[(s, b[r]) for s, b in record.commits],
                       final=torch.as_tensor(out[r], device=device))
            for r in range(len(lengths))]


def _gen(mix: dict) -> Tuple[int, int, int]:
    gen = mix["generate"]
    bl = gen["block_length"]
    n_blocks = gen["gen_length"] // bl
    return bl, n_blocks, gen["steps"] // n_blocks


def packed(t: Trajectory, steps: List[int], spb: int, bl: int):
    """``reference/sdar.py::pack`` of the states of steps ``steps``: the
    prompt and the blocks committed before the last of them, with each
    step's block beside them."""
    k = max(steps) // spb
    prefix = torch.cat([t.prompt] + [c for _, c in t.commits[:k]])
    mask = torch.cat([t.mask.to(prefix.device),
                      torch.ones(k * bl, dtype=t.mask.dtype, device=prefix.device)])
    blocks = [(t.prompt.shape[0] + (i // spb) * bl, t.steps[i][1]) for i in steps]
    return ref.pack(prefix, mask, blocks, bl)


def after(t: Trajectory, i: int, spb: int) -> Optional[torch.Tensor]:
    """The block as step ``i`` left it: the next step's block, or the
    commit after the block's last step (None where the path stops)."""
    k, j = divmod(i, spb)
    if j + 1 < spb:
        return t.steps[i + 1][1] if i + 1 < len(t.steps) else None
    return t.commits[k][1] if k < len(t.commits) else None


def structure_faults(t: Trajectory, mix: dict, mask_id: int) -> int:
    """The count of the trajectory's departures from the sampler's rules."""
    bl, n_blocks, spb = _gen(mix)
    G = mix["generate"]["gen_length"]
    P = t.prompt.shape[0]
    pad = P + G - t.final.shape[0]
    dev = t.prompt.device
    final = t.final.to(dev)
    faults = int(len(t.steps) != n_blocks * spb) + int(len(t.commits) != n_blocks)
    faults += int(pad < 0 or not torch.equal(final[:P - pad], t.prompt[pad:]))
    counts = schedule(bl, spb)
    for i, (start, blk) in enumerate(t.steps):
        k, j = divmod(i, spb)
        nxt = after(t, i, spb)
        ok = start == P + k * bl and nxt is not None
        if ok and j == 0:
            ok = bool((blk == mask_id).all())
        if ok:
            changed = blk != nxt
            ok = (int(changed.sum()) == counts[j] and bool((blk[changed] == mask_id).all())
                  and bool((nxt[changed] != mask_id).all()))
        faults += int(not ok)
    for k, (start, blk) in enumerate(t.commits):
        lo = start - pad
        faults += int(start != P + k * bl or bool((blk == mask_id).any())
                      or not torch.equal(blk, final[lo:lo + bl]))
    faults += int(bool((final[P - pad:] == mask_id).any()))
    return faults


def judge(trajs: List[Trajectory], pairs, weights: dict, s: Dict, mix: dict,
          control=None):
    """(the widest gaps over ``pairs``, {request: its widest gaps}) under the
    float32 reference, the sampled states of one request packed into one
    row (:func:`packed`), ``check.rows_per_forward`` requests a forward.
    ``control``: also the gaps of what the reference computed under that
    cast would commit, under ``control_*`` names."""
    bl, _, spb = _gen(mix)
    mask_id = s["mask_token_id"]
    eos = s["eos_token_id"] if mix["generate"].get("avoid_eos") else None
    chunk = mix["check"]["rows_per_forward"]
    sides = ("", "control_") if control is not None else ("",)
    totals = {side: _zero() for side in sides}
    per_request = {r: _zero() for r, _ in pairs}
    head = weights["lm_head"].float()
    steps: Dict[int, List[int]] = {}
    for r, i in pairs:
        steps.setdefault(r, []).append(i)
    requests = list(steps)
    for c in range(0, len(requests), chunk):
        part = requests[c:c + chunk]
        rows = [packed(trajs[r], steps[r], spb, bl) for r in part]
        width = max(x.shape[0] for x, _, _, _ in rows)
        dev = rows[0][0].device
        ids = torch.full((len(rows), width), mask_id, dtype=rows[0][0].dtype, device=dev)
        pos = torch.zeros((len(rows), width), dtype=torch.long, device=dev)
        # A padding query sees itself alone, so no softmax is empty; no real
        # query sees it.
        seen = torch.eye(width, dtype=torch.bool, device=dev).repeat(len(rows), 1, 1)
        for n, (x, p, v, _) in enumerate(rows):
            w = x.shape[0]
            ids[n, :w], pos[n, :w], seen[n, :w, :w] = x, p, v
        hidden = ref.final_hidden(weights, s, ids, None, seen=seen, pos=pos)
        hidden_c = (ref.final_hidden(weights, s, ids, None, control, seen=seen, pos=pos)
                    if control else None)
        for n, r in enumerate(part):
            for i, lo in zip(steps[r], rows[n][3]):
                cur, nxt = trajs[r].steps[i][1], after(trajs[r], i, spb).to(dev)
                logits = _no_eos(ref.linear(hidden[n, lo:lo + bl], head), eos)
                g = {"": gaps(logits, cur, nxt, mask_id)}
                if control is not None:
                    g["control_"] = _control_gaps(
                        logits, _no_eos(ref.linear(hidden_c[n, lo:lo + bl], head, control),
                                        eos), cur, nxt, mask_id)
                _fold(per_request[r], g[""])
                for side in sides:
                    _fold(totals[side], g[side])
    worst = {}
    for side in sides:
        worst.update({side + k: v for k, v in stats(totals[side]).items()})
    return worst, {r: stats(acc) for r, acc in per_request.items()}
