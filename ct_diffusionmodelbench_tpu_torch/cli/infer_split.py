"""Split-based inference driver over NuminaMath-LEAN.

Counterpart of ``cli/infer_split.py``, flag for flag, plus ``--device`` (the
card by default): rebuilds the training splits (``val_from_training``, as
the training script builds it, or the fresh seeded 80/10/10) and writes
``generations.jsonl``, one row per sample with prompt / generated /
reference / latency.  The dataset goes through ``datasets``, imported only
when it is loaded.

    python -m ct_diffusionmodelbench_tpu_torch.cli.infer_split --preset llada-tiny \
        --device cpu --dataset numina.jsonl --split test --num-samples 2
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path

from ct_diffusionmodelbench_tpu_torch.cli.common import (
    add_parallel_flags, rank_zero_output, runner_from_args)
from ct_diffusionmodelbench_tpu_torch.io.datasets_io import (
    NUMINA_DATASET,
    format_instruction_problem,
    load_hub_or_local,
    split_fresh_for_inference,
    split_val_from_training,
)
from ct_diffusionmodelbench_tpu_torch.utils.logging import log

LEAN_EXTRA_SYSTEM = ("Respond only with Lean code (import Mathlib, theorem, "
                     "proof). Do not include explanations or natural language.")


def build_parser():
    p = argparse.ArgumentParser(description="Split-based diffusion inference over NuminaMath-LEAN")
    p.add_argument("--model-dir", type=str, default=None)
    p.add_argument("--preset", type=str, default=None)
    p.add_argument("--dataset", type=str, default=NUMINA_DATASET)
    p.add_argument("--split", type=str, default="test",
                   choices=["val_from_training", "test", "val", "train"])
    p.add_argument("--num-samples", type=int, default=10)
    p.add_argument("--max-length", type=int, default=2048)
    p.add_argument("--gen-length", type=int, default=128)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--block-length", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--cfg-scale", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--training-like-max-samples", type=int, default=100)
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--no-avoid-eos", action="store_true")
    p.add_argument("--no-truncate-at-eos", action="store_true")
    p.add_argument("--no-lean-only", action="store_true")
    p.add_argument("--mask-id", type=int, default=None)
    add_parallel_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    runner = runner_from_args(args)
    with rank_zero_output(args):
        _infer(args, runner)


def _infer(args, runner) -> None:
    extra = "" if args.no_lean_only else LEAN_EXTRA_SYSTEM
    raw = load_hub_or_local(args.dataset, split="train")
    formatted = raw.map(
        lambda x: format_instruction_problem(x, runner.tokenizer, extra_system=extra),
        remove_columns=raw.column_names)
    formatted = formatted.filter(lambda x: x["prompt"] != "")

    if args.split == "val_from_training":
        ds = split_val_from_training(formatted, args.training_like_max_samples,
                                     seed=args.seed)
    else:
        train_ds, val_ds, test_ds = split_fresh_for_inference(formatted,
                                                              seed=args.seed)
        ds = {"train": train_ds, "val": val_ds, "test": test_ds}[args.split]
    log(f"Split '{args.split}': {len(ds)} rows; generating "
        f"{min(args.num_samples, len(ds))}")

    save_dir = Path(args.save_dir or f"inference_{args.split}_"
                    f"{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    save_dir.mkdir(parents=True, exist_ok=True)
    out_path = save_dir / "generations.jsonl"

    with open(out_path, "w") as f:
        for i in range(min(args.num_samples, len(ds))):
            row = ds[i]
            res = runner.generate(
                row["prompt"], max_length=args.max_length,
                gen_length=args.gen_length, steps=args.steps,
                block_length=args.block_length, temperature=args.temperature,
                cfg_scale=args.cfg_scale,
                avoid_eos=not args.no_avoid_eos,
                truncate_at_eos=not args.no_truncate_at_eos,
                seed=args.seed,
            )
            rec = {
                "index": i,
                "prompt": row["prompt"],
                "generated": res.text,
                "reference": row.get("reference", ""),
                "latency_sec": res.latency_sec,
                "gen_length": args.gen_length,
                "steps": args.steps,
                "block_length": args.block_length,
                "temperature": args.temperature,
                "cfg_scale": args.cfg_scale,
                "seed": args.seed,
            }
            f.write(json.dumps(rec) + "\n")
            log(f"[{i+1}] {res.latency_sec}s")
    log(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
