"""Milliseconds a step in the optimizer's ``update``: CUDA events around
the call on the optimizer instance handed to ``make_train_step``, the mean
over the window's steps."""


def read(run):
    return run.spans.get("optimizer_ms")
