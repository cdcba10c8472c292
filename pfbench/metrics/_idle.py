"""The device's idle share of a traced window: the time in which no
operation runs on a card (the union of the profiler's device intervals),
averaged over the cards the cell uses, over the window's length."""


def idle_pct(run):
    if run.profile is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_mean_s(run.cards) / run.window_s)
