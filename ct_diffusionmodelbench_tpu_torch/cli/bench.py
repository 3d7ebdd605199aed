"""Pre-trained benchmark sweep CLI (MathOlympiadBench).

Counterpart of ``cli/bench.py``, flag for flag, plus ``--device`` (the card
by default).  ``--dataset-path`` takes a hub id or a local json/jsonl file
or ``save_to_disk`` directory; loading goes through ``datasets``, imported
only then.  :func:`run` is the sweep on entries already loaded, which
:func:`main` calls after loading.

    python -m ct_diffusionmodelbench_tpu_torch.cli.bench --preset llada-tiny \\
        --device cpu --dataset-path entries.jsonl --fake-lean
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

from ct_diffusionmodelbench_tpu_torch.cli.common import (
    add_parallel_flags, rank_zero_output, runner_from_args)
from ct_diffusionmodelbench_tpu_torch.eval.benchmark import BenchmarkConfig, DiffusionBenchmark
from ct_diffusionmodelbench_tpu_torch.eval.lean import (
    FakeLeanVerifier,
    LeanVerifier,
    lean_available,
)
from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io.datasets_io import (
    MATH_OLYMPIAD_DATASET,
    load_hub_or_local,
    pick_bench_split,
)


def build_parser():
    p = argparse.ArgumentParser(description="Benchmark a diffusion LM on MathOlympiadBench")
    p.add_argument("--style", choices=["llada", "dream", "diffucoder"], default="llada")
    p.add_argument("--model-dir", type=str, default=None)
    p.add_argument("--preset", type=str, default=None,
                   help="Random-init preset instead of loading a checkpoint")
    p.add_argument("--dataset-path", type=str, default=MATH_OLYMPIAD_DATASET,
                   help="Hub id or local json/jsonl/dataset dir")
    p.add_argument("--max-samples", type=int, default=100)
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--save-interval", type=int, default=25)
    p.add_argument("--gen-length", type=int, default=256)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--block-length", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--cfg-scale", type=float, default=0.0)
    p.add_argument("--remasking", type=str, default="low_confidence")
    p.add_argument("--mask-id", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--dream-temperature", type=float, default=0.4)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--alg", type=str, default="entropy")
    p.add_argument("--exact", action="store_true",
                   help="Exact Dream parity mode: full-vocab top-p/top-k "
                        "filtering (no approx prefilter)")
    p.add_argument("--batch-mean-counts", action="store_true",
                   help="Remote-code batch-averaged transfer counts")
    p.add_argument("--results-dir", type=str, default=None)
    p.add_argument("--fake-lean", action="store_true",
                   help="Use the offline fake Lean verifier")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--batch-size", type=int, default=1,
                   help="Prompts per generate (one left-padded batch)")
    p.add_argument("--quiet", action="store_true")
    add_parallel_flags(p)
    return p


def run(args, runner: ModelRunner, entries: Sequence[Dict]) -> DiffusionBenchmark:
    """The sweep over ``entries`` as ``args`` configure it; prints the
    overall metrics and returns the benchmark (results, verifier, stats)."""
    verifier = None
    if not args.no_verify:
        verifier = FakeLeanVerifier() if args.fake_lean or not lean_available() \
            else LeanVerifier(timeout=60)

    cfg = BenchmarkConfig(
        style=args.style, gen_length=args.gen_length, steps=args.steps,
        block_length=args.block_length, temperature=args.temperature,
        cfg_scale=args.cfg_scale, remasking=args.remasking,
        max_new_tokens=args.max_new_tokens, top_p=args.top_p, alg=args.alg,
        dream_temperature=args.dream_temperature, results_dir=args.results_dir,
        exact=args.exact, batch_mean_counts=args.batch_mean_counts,
        batch_size=args.batch_size,
    )
    bench = DiffusionBenchmark(runner, cfg, verifier=verifier, quiet=args.quiet)
    report = bench.run_benchmark(
        entries, max_samples=args.max_samples, start_idx=args.start_idx,
        save_interval=args.save_interval)
    print(json.dumps(report["overall_metrics"], indent=2))
    return bench


def main(argv=None):
    args = build_parser().parse_args(argv)

    runner = runner_from_args(args)

    ds = load_hub_or_local(args.dataset_path)
    data_split, split_name = pick_bench_split(ds)
    print(f"Using split: {split_name}  ({len(data_split)} entries)")

    entries = data_split if isinstance(data_split, list) else \
        [data_split[i] for i in range(len(data_split))]
    with rank_zero_output(args):
        run(args, runner, entries)


if __name__ == "__main__":
    main()
