"""Active-lane compaction (the reference's StreamCompaction) and its
policy bench.

Counterpart of aten_tpu/ops/compaction.py.  `compaction_order` is a
stable sort of `~alive` (live lanes first, each group in lane order),
`compact` gathers arrays into that order and `scatter_back` returns
results to lane order.  The reference kept masked full-width lanes in
its integrator from a TPU measurement (XLA runs masked lanes at full
width and has static shapes); on a GPU a launch covers only the lanes
it is given, so `bench_compaction` times the round trip against the
masked pass on the card (CUDA events) to re-measure that choice.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.device import resolve_device


def compaction_order(alive):
    """(perm [N] int32, live count [] int32): perm[:count] are the live
    lanes in lane order, then the dead ones in lane order."""
    key = (~alive).to(torch.int32)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    return perm, alive.to(torch.int32).sum(dtype=torch.int32)


def compact(alive, *arrays):
    """(perm, count, the arrays gathered into live-first order)."""
    perm, count = compaction_order(alive)
    idx = perm.long()
    return perm, count, tuple(a[idx] for a in arrays)


def scatter_back(perm, *arrays):
    """The inverse of `compact`: the arrays back in lane order."""
    idx = perm.long()
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(idx.shape[0], device=idx.device)
    return tuple(a[inv] for a in arrays)


def bench_compaction(n=1 << 20, live_frac=0.5, iters=20, device="cuda"):
    """{"compact_ms", "masked_ms"}: device ms of one compact + scale +
    scatter_back round trip over four [n, 3] float32 payloads, and of the
    masked pass (`where(alive, 2x, x)`) on the same data, each the mean
    of `iters` runs after a warm-up; on the card by CUDA events, on the
    CPU by the wall clock."""
    import time

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    alive = torch.from_numpy(rng.uniform(size=n) < live_frac).to(dev)
    payload = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
               for _ in range(4)]

    def roundtrip():
        perm, _, g = compact(alive, *payload)
        return scatter_back(perm, *(x * 2.0 for x in g))

    def masked():
        m = alive[:, None]
        return tuple(torch.where(m, x * 2.0, x) for x in payload)

    def timeit(f):
        f()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                f()
            stop.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(stop) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            f()
        return (time.perf_counter() - t0) / iters * 1e3

    return {"compact_ms": timeit(roundtrip), "masked_ms": timeit(masked)}
