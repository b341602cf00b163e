"""Spans and counters of the port: one registry, recording only on demand.

`span(name)` marks a stage of a render or a train step, `count(name, n)`
adds to a host counter, and `tally(name, t)` adds a device tensor into a
device accumulator without a host sync.  Host counters always count:
an increment of a dict, as the kernel wrappers' launch counts always
were.  Spans and tallies record only while recording is on (`active()`):
while torch's profiler records (`torch.profiler.profile`, whatever its
activities) and inside `with recording():`; nothing else switches it.
While it is off, `span` returns one shared null context after a single
check and `tally` returns at once: no record, no event, no device op.

A span's record holds its name, its id, its parent's id (the span open
on the same thread when it began, None for a root), its root's id
(shared by every span of one render or one step) and its host interval
on `time.time_ns()`, the clock of the profiler's events.  A root takes
its device from `span(name, device)` (default: the current CUDA device
if CUDA is initialized, else the host), and its spans inherit it.  On a
CUDA device a span records a timing event on the stream at entry and at
exit; the pair is resolved once, at readout, after a synchronize, into
the span's device interval in stream order: the device time of the work
launched inside it, plus any idle inside it.  On the CPU the host
interval stands in for the device interval.

Records, counters and tallies stay in memory until `reset()`; nothing
is written out.  Readout: `records()`, `counters()`, `host_spans()`.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_forced = 0  # open recording() blocks
_spans = []  # finished spans, in the order they ended
_counts = {}
_tallies = {}


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stream_of(device):
    """The CUDA stream a root span records its events on, or None (host)."""
    if device is None:
        return torch.cuda.current_stream() if torch.cuda.is_initialized() else None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def _event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "device", "id", "parent", "root", "stream", "start_ns", "end_ns",
                 "events", "ms")

    def __init__(self, name, device):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.stream = _stream_of(self.device) if up is None else up.stream
        self.ms = None
        self.start_ns = time.time_ns()
        self.events = None if self.stream is None else [_event(self.stream)]
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events.append(_event(self.stream))
        self.end_ns = time.time_ns()
        _stack().pop()
        _spans.append(self)
        return False


def active():
    """Whether spans and tallies record."""
    return bool(_forced) or _profiling()


def span(name, device=None):
    """A context manager that records stage `name` while recording is on.
    `device` matters only for a root span (see the module docstring)."""
    if not (_forced or _profiling()):
        return _NULL
    return _Span(name, device)


def count(name, n=1):
    """Add n to the host counter `name`, whether recording or not."""
    _counts[name] = _counts.get(name, 0) + n


def tally(name, t):
    """Add tensor t, element by element, into a device accumulator of its
    shape under `name`: one device op and no host sync a call (a sum
    would take a cast, a fill and a reduction).  `counters()` reports the
    sum of the name's accumulators, read once, at readout."""
    if not (_forced or _profiling()):
        return
    key = (name, t.shape, t.device)
    acc = _tallies.get(key)
    with torch.no_grad():
        if acc is None:
            _tallies[key] = t.to(torch.int32 if t.dtype == torch.bool else t.dtype, copy=True)
        else:
            acc.add_(t)


@contextlib.contextmanager
def recording():
    """Record inside the block, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def reset():
    """Drop every record, counter and tally."""
    _spans.clear()
    _counts.clear()
    _tallies.clear()


def _resolve():
    pending = [s for s in _spans if s.ms is None]
    for dev in {s.stream.device for s in pending if s.events is not None}:
        torch.cuda.synchronize(dev)
    for s in pending:
        if s.events is None:
            s.ms = (s.end_ns - s.start_ns) / 1e6
        else:
            s.ms = s.events[0].elapsed_time(s.events[1])
            s.events = None


def records():
    """The finished spans, in the order they ended: dicts of name, id,
    parent, root, start_ns, end_ns (host), device_ms and self_ms
    (device_ms less the part its child spans cover)."""
    _resolve()
    covered = {}
    for s in _spans:
        if s.parent is not None:
            covered[s.parent] = covered.get(s.parent, 0.0) + s.ms
    return [{"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
             "start_ns": s.start_ns, "end_ns": s.end_ns, "device_ms": s.ms,
             "self_ms": s.ms - covered.get(s.id, 0.0)} for s in _spans]


def counters():
    """The host counters and the tallies ({name: number}); reading the
    tallies waits for the device."""
    out = dict(_counts)
    for (name, _, _), acc in _tallies.items():
        out[name] = out.get(name, 0) + acc.sum().item()
    return out


def host_spans():
    """The finished spans as (name, start_ns, end_ns) on the host clock."""
    return [(s.name, s.start_ns, s.end_ns) for s in _spans]
