"""Active-lane compaction (the reference's StreamCompaction).

Counterpart of aten_tpu/ops/compaction.py.  `compaction_order` is a
stable sort of `~alive` (live lanes first, each group in lane order),
`compact` gathers arrays into that order and `scatter_back` returns
results to lane order.  The reference kept masked full-width lanes in
its integrator from a TPU measurement (XLA runs masked lanes at full
width and has static shapes); on a GPU a launch covers only the lanes
it is given, so the share of lanes a render still has alive at each
bounce (the "lanes.live.<bounce>" and "lanes.issued.<bounce>" counters
of integrator/pathtracer.py, utils/spans.py) is what would size that
choice again.
"""
from __future__ import annotations

import torch


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
