"""The device trace of a window and its reduction.

`DeviceTrace` records the card's activity only (kernels, copies, fills)
with torch.profiler over the measured window; recording the host's ops
too slows host-paced work and takes seconds to summarise.  The sums are
taken over the profiler's raw events, as the repository's on-card check
takes them (its per-name averages cost about 0.2 ms an event).  Event
times are on the host's wall clock (ns since the epoch), so an idle gap
on the card is labelled with the benchmark span the host was in.
"""
from __future__ import annotations


class DeviceTrace:
    """Context manager: the device events [(name, start_ns, dur_ns)] of
    everything the card ran inside it, in `events` after exit.  On a CPU
    device (the tests) the CPU's ops stand in for the card's."""

    def __init__(self, device_type="cuda"):
        self.events = []
        self._prof = None
        self._cuda = device_type == "cuda"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        act = ProfilerActivity.CUDA if self._cuda else ProfilerActivity.CPU
        self._prof = profile(activities=[act])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        self._prof.__exit__(*exc)
        kind = DeviceType.CUDA if self._cuda else DeviceType.CPU
        self.events = [(e.name(), e.start_ns(), e.duration_ns())
                       for e in self._prof.profiler.kineto_results.events()
                       if e.device_type() == kind]
        self._prof = None
        return False


def short_name(name):
    """A kernel's name without "void " and the at::native:: namespaces."""
    return name.removeprefix("void ").replace("at::native::", "")


def busy_intervals(events):
    """The union of the events' intervals, sorted: [(start_ns, end_ns)]."""
    out = []
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def summarize(events, t0_ns, t1_ns, spans, top=10):
    """Busy seconds, op count, seconds by op name, and the `top` longest
    idle gaps inside [t0_ns, t1_ns], each labelled by the innermost span
    (name, start_ns, end_ns) the host was in when it began."""
    inside = [e for e in events if t0_ns <= e[1] < t1_ns]
    busy = busy_intervals(inside)
    per_name = {}
    for name, _, d in inside:
        name = short_name(name)
        per_name[name] = per_name.get(name, 0.0) + d / 1e9
    gaps, at = [], t0_ns
    for s, e in busy:
        if s > at:
            gaps.append((at, s - at))
        at = max(at, e)
    if t1_ns > at:
        gaps.append((at, t1_ns - at))

    def label(t):
        best = None
        for name, s, e in spans:
            if s <= t < e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "harness"

    gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "ops": len(inside),
        "per_name": per_name,
        "device_ops": [[n, s] for n, s in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[label(s), d / 1e9] for s, d in gaps[:top]],
    }
