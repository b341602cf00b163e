"""What the per-layer metrics of the program's own spans and counters read
(aten_tpu_torch/utils/spans.py, the port's one registry).

The registry records while torch's profiler records, so after a run with
--trace 1 it holds what the program recorded inside the measured window
and nothing of the set-up or the check.  A stage metric keeps the spans
under the program's root spans of the window's units: roots named like
the entry's unit ("render", "step") that lie inside one of the
benchmark's own unit spans, on the same host clock.  A program without
the registry, an untraced run, or a window in which the program recorded
nothing reads None.
"""
from __future__ import annotations


def _registry():
    try:
        from aten_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def unit_records(run, unit):
    """(the records of the window's `unit` roots and every span under
    them, the number of those roots), or None."""
    reg = None if run.trace is None else _registry()
    if reg is None:
        return None
    windows = [(s, e) for n, s, e in run.ctx.spans if n == unit]
    recs = reg.records()
    roots = {r["id"] for r in recs if r["parent"] is None and r["name"] == unit
             and any(s <= r["start_ns"] and r["end_ns"] <= e for s, e in windows)}
    if not roots:
        return None
    return [r for r in recs if r["root"] in roots], len(roots)


def stage_ms(run, unit, stage, key):
    """Device ms a unit in the spans named `stage`: the sum of `key`
    ("self_ms": the stage's own time, each nested span counted once;
    "device_ms": the spans' whole time), over the units; None where the
    window recorded no such span."""
    got = unit_records(run, unit)
    if got is None:
        return None
    recs, units = got
    picked = [r[key] for r in recs if r["name"] == stage]
    return sum(picked) / units if picked else None


def counters(run):
    """The registry's counters and tallies over the window, or None."""
    reg = None if run.trace is None else _registry()
    return None if reg is None else reg.counters()
