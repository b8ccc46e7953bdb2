"""Share of the traced sub-window in which no kernel, copy or memset ran
on the card (100 minus the union of their intervals)."""


def read(run):
    if run.trace is None or not run.trace.jobs:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
