"""Readings that the limits of a cell are set from.

    python3 portbench/control.py --workload <name> --seeds <n> [--first <seed>]
        [--extras <n>] [--out FILE]

For each of ``--seeds`` seeds (``--first``, ``--first`` + 1, ...) it reads
the cell's comparison as a run does, at the cell's own size, and beside it
the control's: the reference computed in fp8
(``portbench/reference/control.py``) put in the program's place.

- Decode cells: decodes through the program as the window does until
  enough requests are done for the comparison's sample; the program's
  numbers (its committed tokens and positions) and, on the first
  ``--extras`` seeds, the control's (the tokens and positions it would
  commit) are read on the same states.
- Training cells: the program's first steps through the window's call and
  feed; on the first ``--extras`` seeds also the control and two faults
  planted in the reference put in the program's place: half of the
  micro-batches left out, the mean taken over the rest, and the tokens of
  every row altered (each id one higher) where the batch is made.  (A state left unchanged reads
  1 on ``change_gap`` by its definition.)

One JSON line a seed on standard output and in ``--out``.  Needs a CUDA
card, as a run does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class _Variant:
    """A training feed with a fault planted in what the reference takes."""

    def __init__(self, feed, fault: str):
        self.feed, self.fault = feed, fault

    def reference(self, i):
        ids, plens, t, u = self.feed.reference(i)
        if self.fault == "half":
            h = ids.shape[0] // 2
            return ids[:h], plens[:h], t[:h], u[:h]
        return ids + 1, plens, t, u    # every token of every row


def sft_readings(cell, seed: int, device, extras: bool) -> dict:
    import torch

    from portbench.harness import cells, train_check
    from portbench.harness.runtime import Run
    from portbench.reference.control import fp8

    drv = cells.driver(cell.traffic["kind"])
    run = Run(cell=cell, seed=seed, seconds=0, trace=False, device=device, t0=T0)
    s, params, state, step, clock, feed = drv.build(run)
    t0 = time.perf_counter()
    params, state, program, _ = drv.first_steps(run, s, params, state, step, feed)
    steps_s = time.perf_counter() - t0
    del params, state, step, clock
    feed.collator = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = train_check.reference_readings(run, s, feed)
    row = dict(seed=seed, steps_s=steps_s, reference_s=time.perf_counter() - t0,
               program_losses=program["losses"], reference_losses=ref["losses"],
               **train_check.compare(program, ref))
    row["leaves"] = {k: [program["first"][k], ref["first"][k], program["change"][k],
                         ref["change"][k]] for k in ref["first"]}
    if extras:
        for name, f in (("control", None), ("half", "half"), ("token", "token")):
            other = train_check.reference_readings(
                run, s, feed if f is None else _Variant(feed, f),
                cast=fp8 if f is None else None)
            row.update({f"{name}_{k}": v for k, v in train_check.compare(other, ref).items()})
            row[f"{name}_losses"] = other["losses"]
    return row


def readings(cell, seed: int, device, extras: bool) -> dict:
    """The program's readings at one seed, with ``extras`` the control's."""
    import torch

    from portbench.harness import cells, decode_check, model, seeds, traffic
    from portbench.harness.runtime import Run
    from portbench.reference import llada as ref
    from portbench.reference.control import fp8

    drv = cells.driver(cell.traffic["kind"])
    run = Run(cell=cell, seed=seed, seconds=0, trace=False, device=device, t0=T0)
    mix = run.mix
    s, runner, rec = drv.build(run)
    need = mix["check"]["requests"]
    done, t0 = [], time.perf_counter()
    batches = traffic.prompt_batches(mix, seed, s["mask_token_id"])
    kw = drv.decode_kw(mix)
    while sum(b.ids.shape[0] for b, _, _ in done) < need:
        b = next(batches)
        out = runner.generate_ids(b.ids, attn_mask=b.mask, **kw)
        done.append((b, out, rec.take()))
    decode_s = time.perf_counter() - t0
    trajs, lengths = drv.trajectories(done, device)
    del runner, rec, done
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pairs = decode_check.sample(trajs, lengths, mix, seeds.host_rng(seed, seeds.SAMPLE))
    faults = sum(decode_check.structure_faults(trajs[r], mix, s["mask_token_id"])
                 for r in sorted({r for r, _ in pairs}))
    ref.strict_f32()
    weights = model.draw_weights(s, seed, device)
    t1 = time.perf_counter()
    worst, _ = decode_check.judge(trajs, pairs, weights, s, mix,
                                  control=fp8 if extras else None)
    return dict(seed=seed, structure=faults, decode_s=decode_s,
                judge_s=time.perf_counter() - t1, tokens_judged=2 * len(pairs), **worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=1000)
    ap.add_argument("--extras", type=int, default=3,
                    help="seeds that also read the control (training cells: and the faults)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cells

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    rows = []
    for seed in range(args.first, args.first + args.seeds):
        dev = torch.device("cuda", 0)
        if cell.traffic["kind"] == "sft":
            row = sft_readings(cell, seed, dev, seed - args.first < args.extras)
        else:
            row = readings(cell, seed, dev, seed - args.first < args.extras)
        row["workload"] = args.workload
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
