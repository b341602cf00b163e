"""Device milliseconds a render in the traversal kernel K1 (kernels whose
names hold "bvh_traverse"), from the window's device trace."""


def read(run):
    if run.trace is None:
        return None
    s = sum(v for name, v in run.trace["per_name"].items() if "bvh_traverse" in name)
    return s / run.units * 1e3 if s > 0 else None
