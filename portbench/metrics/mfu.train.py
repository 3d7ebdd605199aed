"""Model FLOPs of the window's training steps over its wall time, as a
share of the cards' bf16 peak: 3 × each forward pass's FLOPs at its rows'
non-pad tokens, with the full LM head (``portbench/harness/counts.py``).
Recomputed blocks are not counted."""

from portbench.harness.counts import calls_flops


def read(run):
    if not run.window_s or not run.calls or run.peaks is None:
        return None
    return 300.0 * calls_flops(run.sizes, run.calls) / run.window_s / (
        run.peaks["bf16"] * run.chips)
