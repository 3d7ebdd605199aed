"""Set-up seconds: from the process's start to the window's (host clock).

Imports, loading the kernel libraries (building them on a checkout's first
run), the weights drawn on the card, the optimizer's state and the warm-up
all fall inside it."""


def read(run):
    return run.setup_s
