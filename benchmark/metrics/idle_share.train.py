"""Percent of the traced window in which the card ran nothing, in a train
cell: 100 (1 - busy / window)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
