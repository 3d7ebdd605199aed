"""Cross-model analyzer CLI.

Counterpart of ``cli/analyze.py``: ``model_performance.{csv,md,json}`` from
each model's ``results_batch_*.json``.

    python -m ct_diffusionmodelbench_tpu_torch.cli.analyze \
        --results llada=results/results_batch_100.json --no-syntax-check
"""

from __future__ import annotations

import argparse

from ct_diffusionmodelbench_tpu_torch.eval.analyzer import ModelAnalyzer


def main(argv=None):
    p = argparse.ArgumentParser(description="Cross-model benchmark analyzer")
    p.add_argument("--results", nargs="+", required=True,
                   metavar="NAME=PATH",
                   help="model=results_batch.json pairs, e.g. "
                        "llada=llada_benchmark/results_batch_100.json")
    p.add_argument("--output-dir", type=str, default="processing")
    p.add_argument("--no-syntax-check", action="store_true",
                   help="Skip Lean syntax re-validation (no lean binary)")
    args = p.parse_args(argv)

    paths = dict(item.split("=", 1) for item in args.results)
    checker = (lambda code: False) if args.no_syntax_check else None
    analyzer = ModelAnalyzer(paths, syntax_checker=checker,
                             output_dir=args.output_dir)
    analyzer.run_analysis()


if __name__ == "__main__":
    main()
