"""BENCHMARK.json against the benchmark contract: names, units, keys, the
files each entry names, and which cells report which metric."""
import json
import os
import re

import pytest

from bench_cells import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in man["paths"])
    assert 1 <= len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    files = [w for w in man["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in man["paths"]) for f in files)


def test_names_units_and_keys(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    assert len({c["file"] for c in man["configs"]}) == len(man["configs"])
    cells = []
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(cells)
    assert {w["config"] for w in man["workloads"]} == set(names)
    metrics = []
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
        metrics.append(m["name"])
    assert len(set(metrics)) == len(metrics)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def _reports(man, cell, kind):
    return {m["name"] for m in man[kind] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_enough_and_moves_are_reported(man):
    e2e_names = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e_names
    for w in man["workloads"]:
        e2e = _reports(man, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reports(man, w["name"], "per_layer")
    for m in man["per_layer"]:
        assert m["moves"] in e2e_names
        for cell in m.get("workloads", [w["name"] for w in man["workloads"]]):
            assert m["moves"] in _reports(man, cell, "end_to_end"), (m["name"], cell)


def test_files_by_name(man):
    bench = os.path.join(ROOT, "benchmark")
    for w in man["workloads"]:
        with open(os.path.join(bench, "workloads", w["name"] + ".json")) as fh:
            wl = json.load(fh)
        assert wl["config"] == w["config"]
        assert os.path.exists(os.path.join(bench, "entries", wl["entry"] + ".py"))
        assert os.path.exists(os.path.join(bench, "configs", w["config"] + ".json"))
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics", m["name"] + ".py")), m["name"]


def test_a_full_check_of_24_cells_fits(man):
    """A full check with 24 cells: 2 + 14 x cells runs of run_seconds + 60
    seconds, 2 x 90 seconds a cell to compile, 1200 spare, in 43,200."""
    cells = 24
    total = (2 + 14 * cells) * (man["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_layers_share_names(man):
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"scene build", "native kernels", "traversal kernels",
                           "autograd backward", "host dispatch", "device"}
