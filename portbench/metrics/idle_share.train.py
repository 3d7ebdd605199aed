"""Share of a training step's wall in which no device operation ran:
100 · (1 − busy / wall).  Busy is the union of the device intervals of the
traced step; wall is an untraced step's, the window's wall over the steps
it completed (the same work).  The profiler records each launch on the
host, which slows a host-bound stretch: the traced step's own wall would
count that cost as idle."""


def read(run):
    sl = run.slice
    if sl is None or sl.busy_s <= 0 or not run.window_s or not run.units:
        return None
    return 100.0 * (1.0 - sl.busy_s * run.units / run.window_s)
