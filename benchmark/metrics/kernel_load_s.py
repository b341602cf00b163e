"""Seconds to load (and, in a fresh checkout, build) the traversal kernels'
library: the benchmark's span around its first load, taken only where the
program will walk a BVH."""


def read(run):
    if not any(name == "kernel_load" for name, _, _ in run.ctx.spans):
        return None
    return run.ctx.span_seconds("kernel_load")
