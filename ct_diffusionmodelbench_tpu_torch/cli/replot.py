"""Re-render training plots from a saved ``training_metrics.json``.

Counterpart of ``cli/replot.py``:

    python -m ct_diffusionmodelbench_tpu_torch.cli.replot run/training_metrics.json
"""

from __future__ import annotations

import argparse

from ct_diffusionmodelbench_tpu_torch.train.plotting import replot_from_file


def main(argv=None):
    p = argparse.ArgumentParser(description="Replot training metrics")
    p.add_argument("metrics_json", help="Path to training_metrics.json")
    p.add_argument("--output-dir", default=None)
    args = p.parse_args(argv)
    ok = replot_from_file(args.metrics_json, args.output_dir)
    print("Plots written." if ok else "No plottable series found.")


if __name__ == "__main__":
    main()
