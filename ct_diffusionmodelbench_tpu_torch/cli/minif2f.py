"""MiniF2F pass@1 evaluation CLI.

Counterpart of ``cli/minif2f.py``, flag for flag, plus ``--device`` (the
card by default).  :func:`run` evaluates with a runner already built, which
:func:`main` calls after building it.

    python -m ct_diffusionmodelbench_tpu_torch.cli.minif2f --preset llada-tiny \\
        --device cpu --json-path minif2f.json --fake-lean
"""

from __future__ import annotations

import argparse
from typing import Dict

from ct_diffusionmodelbench_tpu_torch.cli.common import (
    add_parallel_flags, rank_zero_output, runner_from_args)
from ct_diffusionmodelbench_tpu_torch.eval.lean import FakeLeanVerifier
from ct_diffusionmodelbench_tpu_torch.eval.minif2f import run_minif2f_evaluation
from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner


def build_parser():
    p = argparse.ArgumentParser(
        description="Evaluate a diffusion LM on miniF2F with Lean 4 verification")
    p.add_argument("--model-dir", type=str, default=None, help="Path to model directory")
    p.add_argument("--preset", type=str, default=None,
                   help="Random-init preset instead of loading a checkpoint")
    p.add_argument("--json-path", type=str, required=True, help="Path to miniF2F JSON file")
    p.add_argument("--output-dir", type=str, default="eval_results")
    p.add_argument("--split", type=str, default="test", choices=["test", "valid"])
    p.add_argument("--gen-length", type=int, default=512)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--block-length", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--cfg-scale", type=float, default=0.0)
    p.add_argument("--mask-id", type=int, default=None)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--fake-lean", action="store_true",
                   help="Use the offline fake Lean verifier")
    p.add_argument("--verification-timeout", type=int, default=60)
    p.add_argument("--reuse-work-dir", action="store_true",
                   help="Reuse Lean workspace (faster)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="Disable generation/verification overlap")
    p.add_argument("--batch-size", type=int, default=1,
                   help="Prompts per generate (one left-padded batch)")
    p.add_argument("--prompt-bucket", type=int, default=64,
                   help="Left-pad prompts to multiples of this (1 = exact "
                        "shapes)")
    add_parallel_flags(p)
    return p


def run(args, runner: ModelRunner) -> Dict:
    """The evaluation as ``args`` configure it; returns the result file's
    contents."""
    runner.prompt_bucket = max(args.prompt_bucket, 1)
    return run_minif2f_evaluation(
        runner,
        json_path=args.json_path,
        output_dir=args.output_dir,
        split=args.split,
        gen_length=args.gen_length,
        steps=args.steps,
        block_length=args.block_length,
        temperature=args.temperature,
        cfg_scale=args.cfg_scale,
        num_samples=args.num_samples,
        verify_proofs=not args.no_verify,
        verification_timeout=args.verification_timeout,
        reuse_work_dir=args.reuse_work_dir,
        verifier=FakeLeanVerifier() if args.fake_lean else None,
        pipeline_verification=not args.no_pipeline,
        batch_size=args.batch_size,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    runner = runner_from_args(args)
    with rank_zero_output(args):
        run(args, runner)


if __name__ == "__main__":
    main()
