"""call_s: the window's time over the calls it completed, what a modeller
waits for one inference call."""


def read(run):
    return run.window_s / run.completed if run.completed else None
