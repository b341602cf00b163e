"""Device operations (kernels, copies, fills) a render, from the window's
device trace: what the host has to issue, one eager launch each."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["ops"] / run.units
