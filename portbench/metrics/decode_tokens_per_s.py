"""Generated tokens of every batch the window completed, over the wall
time from the window's start to the last completion (host clock)."""


def read(run):
    if not run.window_s or not run.tokens:
        return None
    return run.tokens / run.window_s
