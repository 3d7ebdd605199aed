"""Readings that the limits of a latent-attention cell are set from.

    python3 portbench/mla_control.py --workload <name> --seeds <n> [--first <seed>]
        [--extras <n>] [--out FILE]

As ``portbench/sdar_control.py`` does for the SDAR cells, for the cells
whose mix's ``kind`` is ``mla_decode``: for each of ``--seeds`` seeds
(``--first``, ``--first`` + 1, ...) it decodes through the program as the
window does (``drivers/mla_decode.py``) until enough requests are done for
the comparison's sample, and reads the comparison
(``harness/mla_check.py``) at the cell's own size; on the first
``--extras`` seeds also the control's: the reference computed in fp8
(``portbench/reference/control.py``) put in the program's place, its
tokens and positions read on the program's states, routed as the program
routed, and its own choices of experts read against the f32 reference's.
Each line also holds the cell's comparison of both under the limits the
cell's file gives now (``harness/runtime.py::Check``, as a run's
``correct``): ``correct`` the program's, ``control_correct`` the
control's, with ``control_within`` naming each limit the control kept.

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

from portbench import run as bench_run  # noqa: E402,F401  (the build caches' paths)


def readings(cell, seed: int, device, extras: bool) -> dict:
    """The program's readings at one seed, with ``extras`` the control's."""
    import torch

    from portbench.harness import cells, decode_check, mla_check, sdar_check, seeds
    from portbench.harness.runtime import Check, Run
    from portbench.reference import kanana as ref
    from portbench.reference.control import fp8

    drv = cells.driver(cell.traffic["kind"])
    run = Run(cell=cell, seed=seed, seconds=0, trace=False, device=device, t0=T0)
    mix = run.mix
    s, runner, rec = drv.build(run)
    done, t0 = [], time.perf_counter()
    batches = drv.prompt_batches(mix, seed, s["mask_token_id"])
    kw = drv.decode_kw(mix)
    while sum(len(b.lengths) for b, _, _ in done) < mix["check"]["requests"]:
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
    faults = sum(sdar_check.structure_faults(trajs[r], mix, s["mask_token_id"])
                 for r in sorted({r for r, _ in pairs}))
    ref.strict_f32()
    weights = mla_check.draw_weights(s, seed, device)
    t1 = time.perf_counter()
    worst, per_request = mla_check.judge(trajs, pairs, weights, s, mix,
                                         control=fp8 if extras else None)
    worst.update({f"request_max_{k}": max(r[k] for r in per_request.values())
                  for k in next(iter(per_request.values()))})
    del weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.limits["limits"]
    verdict = dict(correct=faults == 0 and all(Check(worst[k], v).ok for k, v in limits.items()))
    if extras:
        kept = [k for k, v in limits.items() if Check(worst["control_" + k], v).ok]
        verdict.update(control_correct=len(kept) == len(limits), control_within=kept)
    return dict(seed=seed, structure=faults, decode_s=decode_s,
                judge_s=time.perf_counter() - t1, tokens_judged=2 * len(pairs), **verdict,
                **worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--first", type=int, default=1000)
    ap.add_argument("--extras", type=int, default=3,
                    help="seeds that also read the fp8 control")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cells

    if not torch.cuda.is_available():
        print("portbench mla_control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    if cell.traffic["kind"] != "mla_decode":
        print(f"portbench mla_control: {args.workload} is no latent-attention cell",
              file=sys.stderr)
        return 2
    rows = []
    for seed in range(args.first, args.first + args.seeds):
        row = readings(cell, seed, torch.device("cuda", 0), seed - args.first < args.extras)
        row["workload"] = args.workload
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
