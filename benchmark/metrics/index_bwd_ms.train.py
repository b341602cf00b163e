"""Device milliseconds a train step in the gathers' backward (kernels whose
names hold "indexing_backward"), from the window's device trace."""


def read(run):
    if run.trace is None:
        return None
    s = sum(v for name, v in run.trace["per_name"].items() if "indexing_backward" in name)
    return s / run.units * 1e3 if s > 0 else None
