"""Milliseconds in which the device worked during the traced training
step: the union of its device intervals.  The host's speed, which sets
much of an SFT step's wall, does not enter it, so it moves little from
run to run where ``train_tokens_per_s`` moves with the host."""


def read(run):
    sl = run.slice
    if sl is None or sl.busy_s <= 0 or not run.slice_calls:
        return None
    return 1000.0 * sl.busy_s
