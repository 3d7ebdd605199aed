"""Run one decode cell's span batch: the program's spans joined to the
device trace, with the span metrics and the tracer's cost.

    python3 portbench/span_batch.py --workload <name> --seed <n> [--pairs 1]

Builds the cell's program as its driver does (``drivers/eval_decode.py``:
the weights from the seed, the runner, one warm-up batch), then decodes
one batch of the mix again and again: untraced and under the program's
tracer (``utils/profiling.py::tracing``) in turns, ``--pairs`` times
off, on, on, off, which gives the tracer's cost on the host's clock; once
under the device profiler alone, as the driver's traced batch; and once
under the tracer and the device profiler, the span batch, which
``harness/spans.py`` joins.  Prints one JSON object as the last line: the
walls, both batches' busy times, the span metrics (:data:`SPAN_METRICS`,
read by their files under ``portbench/metrics/``), the spans' coverage,
device time and idle gaps by span.

Exits 2 where there is no CUDA card, or the program has no tracer.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run as bench_run  # noqa: E402  (the build caches' paths)

DECODE = "decode_tokens_per_s"
SPAN_METRICS = [
    {"name": "sampler_share.decode", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "runner, sampler", "moves": DECODE},
    {"name": "model_glue_share.decode", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "model step", "moves": DECODE},
    {"name": "forward_ms.decode", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "model step", "moves": DECODE},
    {"name": "pad_share.decode", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "runner, sampler", "moves": DECODE},
]


def span_batch(cell, seed: int, device, pairs: int = 1, base=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ct_diffusionmodelbench_tpu_torch.utils.profiling import tracing
    from portbench.harness import cells, seeds, spans, traffic
    from portbench.harness.runtime import Run
    from portbench.harness.trace import traced

    base = base or cells.PORTBENCH
    drv = cells.driver(cell.traffic["kind"], base)
    run = Run(cell=cell, seed=seed, seconds=0.0, trace=True, device=device, t0=T0)
    if device.type == "cuda":
        run.card = torch.cuda.get_device_name(device)
    s, runner, rec = drv.build(run)
    mix, gen = run.mix, run.mix["generate"]
    warm = next(traffic.prompt_batches(mix, seed, s["mask_token_id"], tag=seeds.WARMUP))
    runner.generate_ids(warm.ids, attn_mask=warm.mask,
                        **drv.decode_kw(mix, gen["gen_length"] // gen["block_length"]))
    rec.take()
    run.setup_done()
    kw = drv.decode_kw(mix)
    b = next(traffic.prompt_batches(mix, seed, s["mask_token_id"]))

    def decode():
        runner.generate_ids(b.ids, attn_mask=b.mask, **kw)
        return len(rec.take()[1])          # the Recorder's full passes

    walls = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off") * pairs:
        t0 = time.perf_counter()
        if turn == "on":
            with tracing():
                decode()
        else:
            decode()
        walls[turn].append(time.perf_counter() - t0)
        run.log(f"batch, tracer {turn}: {walls[turn][-1]:.3f} s")
    traced_busy = None
    if device.type == "cuda":
        _, traced_slice = traced(decode)
        traced_busy = traced_slice.busy_s
    # The profile just taken is freed by the collector alone (a reference
    # cycle); a full pass inside the span batch stalled an H100 0.5 s.
    gc.collect()
    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with tracing() as recording, profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        passes = decode()
        window = time.perf_counter() - t0
    run.span_slice = sl = spans.join(prof.profiler.kineto_results.events(), recording.spans,
                                     recording.counters, window, spans.classifier(base))
    run.log(f"span batch: busy {sl.busy_s:.3f} of {window:.3f} s, {len(recording.spans)} spans")

    total = sum(sum(t.own) for t in sl.spans.values()) + sl.unlaunched_s
    decode_s = sl.seconds("sampler.decode")
    off, on = statistics.median(walls["off"]), statistics.median(walls["on"])
    return {
        "workload": cell.name, "seed": seed,
        "device": {"kind": run.card, "power_limit_w": bench_run.power_limit_w()},
        "setup_s": run.setup_s,
        "walls_s": walls,
        "tracer_cost": on / off - 1.0,
        "traced_busy_s": traced_busy,
        "metrics": cells.read_metrics(SPAN_METRICS, run, base),
        "coverage": {
            "in_runner_generate": sl.seconds("runner.generate") / total if total else None,
            "under_step_children": ((sl.seconds("model.forward") + sl.seconds("sampler.select"))
                                    / decode_s if decode_s else None),
            "busy_over_traced": sl.busy_s / traced_busy if traced_busy else None,
            "gaps": len(sl.gaps),
            "unlaunched_s": sl.unlaunched_s,
        },
        "passes": {"model.forward": sl.counters.get("model.forward"), "recorder": passes},
        "span_batch": {"window_s": window, "busy_s": sl.busy_s, "counters": sl.counters,
                       "spans": sl.top(), "idle": sl.idle()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cells

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: the span batch needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from ct_diffusionmodelbench_tpu_torch.utils.profiling import tracing  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program has no tracer: {e}", file=sys.stderr)
        return 2
    out = span_batch(cell, args.seed, torch.device("cuda", 0), args.pairs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
