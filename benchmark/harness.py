"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name.  `BENCHMARK.json` lists the
cells and metrics; `workloads/<cell>.json` holds a cell's traffic and
names its configuration and its entry; `configs/<config>.json` holds the
configuration; `entries/<entry>.py` drives the program for that kind of
traffic; `metrics/<metric>.py` reads one per-layer metric.  A later cell,
configuration, entry or metric is a new file and a new manifest entry.

An entry module defines `Cell(ctx)`, which builds what the window needs
(set-up), and on it `run_unit(i)` (one render or step, not synchronized),
`end_to_end(units, seconds)` (the end-to-end metrics it measures),
`check()` (after the window: frees the program's state, runs the plain
reference and returns the compared numbers as [(name, value, limit)])
and `failed()` (units that failed the check).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import time

import torch

from benchmark import guard
from benchmark.trace import DeviceTrace, summarize

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(man, name):
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(man, name, kind):
    """The `kind` ("end_to_end" or "per_layer") metrics cell `name` reports."""
    return [m for m in man[kind] if name in m.get("workloads", [name])]


class Context:
    """What an entry gets: the cell's data, the device, the seed, and the
    run's spans and counters."""

    def __init__(self, name, workload, config, device, seed):
        self.name = name
        self.workload = workload
        self.config = config
        self.device = torch.device(device)
        self.seed = seed
        self.spans = []  # (name, start_ns, end_ns), host wall clock
        self.counters = {}
        self.report = ""  # one line on the run's phases, for standard error

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def span_seconds(self, name):
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Run:
    """What a per-layer metric reads: the context, the window and its trace."""

    def __init__(self, ctx, entry, units, window_s, trace):
        self.ctx = ctx
        self.entry = entry
        self.units = units
        self.window_s = window_s
        self.trace = trace  # summarize()'s dict, or None


def run_cell(name, seed, seconds, trace, device, t_start, root=ROOT, workload=None,
             config=None):
    """One run of cell `name` on `device`.  Returns (the result line's dict,
    the compared numbers [(name, value, limit)], the run's Context).
    `workload` and `config` replace the cell's files (tests run small
    copies); t_start is the process's start on time.time()."""
    bench_dir = os.path.join(root, "benchmark")
    man = manifest(root)
    spec = cell_spec(man, name)
    workload = workload or load_json(os.path.join(bench_dir, "workloads", name + ".json"))
    config = config or load_json(os.path.join(bench_dir, "configs", spec["config"] + ".json"))
    entry = load_module(os.path.join(bench_dir, "entries", workload["entry"] + ".py"),
                        "benchmark_entry_" + workload["entry"])
    ctx = Context(name, workload, config, device, seed)
    cell = entry.Cell(ctx)
    ctx.sync()
    setup_s = time.time() - t_start

    tracer = DeviceTrace(ctx.device.type) if trace else contextlib.nullcontext()
    units = 0
    with tracer:
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        while True:
            with ctx.span(entry.UNIT):
                cell.run_unit(units)
            with ctx.span("sync"):
                ctx.sync()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    summary = None
    if trace:
        summary = summarize(tracer.events, t0_ns, t1_ns, ctx.spans)
    t_check = time.time()
    compared = cell.check()
    check_s = time.time() - t_check
    bad = [n for n, v, lim in compared if not (math.isfinite(v) and v <= lim)]

    e2e = dict(cell.end_to_end(units, window_s), setup_s=setup_s)
    metrics = {}
    if trace:
        run = Run(ctx, workload["entry"], units, window_s, summary)
        for m in metrics_of(man, name, "per_layer"):
            reader = load_module(os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(man, name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": spec["chips"], "memory_peak_bytes": peak}
    result = {"correct": not bad, "attempted": units, "failed": cell.failed(),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    guard.check()
    guard.check_reference()
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    ctx.report = (f"setup {setup_s:.3f} s, window {window_s:.3f} s ({units} {entry.UNIT}s), "
                  f"check {check_s:.3f} s, peak {peak} B, total {time.time() - t_start:.3f} s")
    return result, compared, ctx
