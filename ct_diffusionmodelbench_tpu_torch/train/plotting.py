"""Training-loss plots, with the reference's panels and artifact names.

Counterpart of ``train/plotting.py``: ``training_plots.png`` at dpi 300, a
training-loss panel and a validation-loss panel, only the panels with data;
:func:`replot_from_file` re-renders from a saved ``training_metrics.json``.
matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


def plot_training_metrics(logs: List[Dict], output_dir: str | Path,
                          filename: str = "training_plots.png") -> bool:
    """Write the plot; False (and no file) when no series has data."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    train_step_logs = [e for e in logs if "loss" in e and "step" in e]
    train_final_logs = [e for e in logs if "train_loss" in e and "step" in e
                        and e.get("train_loss") is not None]
    eval_logs = [e for e in logs if "eval_loss" in e and "step" in e]
    if not (train_step_logs or train_final_logs or eval_logs):
        return False

    two_panels = bool((train_step_logs or train_final_logs) and eval_logs)
    plt.figure(figsize=(12, 5))
    if train_step_logs or train_final_logs:
        ax1 = plt.subplot(1, 2, 1) if two_panels else plt.gca()
        if train_step_logs:
            ax1.plot([e["step"] for e in train_step_logs],
                     [e["loss"] for e in train_step_logs],
                     "b-", marker="o", markersize=3, label="Training Loss")
        if train_final_logs:
            ax1.plot([e["step"] for e in train_final_logs],
                     [e["train_loss"] for e in train_final_logs],
                     "bx", markersize=6, label="Final Train Loss")
        ax1.set_xlabel("Steps")
        ax1.set_ylabel("Loss")
        ax1.set_title("Training Loss (masked diffusion)")
        ax1.grid(True)
        ax1.legend()
    if eval_logs:
        ax2 = plt.subplot(1, 2, 2) if two_panels else plt.gca()
        ax2.plot([e["step"] for e in eval_logs], [e["eval_loss"] for e in eval_logs],
                 "r-", marker="s", markersize=3, label="Validation Loss")
        ax2.set_xlabel("Steps")
        ax2.set_ylabel("Loss")
        ax2.set_title("Validation Loss (masked diffusion)")
        ax2.grid(True)
        ax2.legend()
    plt.tight_layout()
    plt.savefig(Path(output_dir) / filename, dpi=300, bbox_inches="tight")
    plt.close()
    return True


def replot_from_file(metrics_path: str | Path, output_dir: str | Path | None = None):
    """Re-render the plot from ``training_metrics.json`` (into its own
    directory unless ``output_dir`` is given)."""
    metrics_path = Path(metrics_path)
    with open(metrics_path) as f:
        logs = json.load(f)
    out_dir = Path(output_dir) if output_dir else metrics_path.parent
    return plot_training_metrics(logs, out_dir)
