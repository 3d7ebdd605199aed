"""Model FLOPs of the window's decode over its wall time, as a share of
the cards' bf16 peak.  Each forward pass the window made counts each row
at its real length (padding not counted) with the LM head over the
positions the pass asked for (``portbench/harness/counts.py``)."""

from portbench.harness.counts import calls_flops


def read(run):
    if not run.window_s or not run.calls or run.peaks is None:
        return None
    return 100.0 * calls_flops(run.sizes, run.calls) / run.window_s / (
        run.peaks["bf16"] * run.chips)
