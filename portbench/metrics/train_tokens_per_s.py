"""Non-pad tokens of every optimizer step the window completed, over the
wall time from the window's start to the last step's end (host clock; a
step ends when its loss is read on the host)."""


def read(run):
    if not run.window_s or not run.tokens:
        return None
    return run.tokens / run.window_s
