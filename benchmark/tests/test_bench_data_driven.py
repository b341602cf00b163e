"""A later cell, configuration and per-layer metric are files and manifest
entries: a copy of the benchmark gains them with no edit to a file it has."""
import json
import os
import shutil
import time

from bench_cells import ROOT, small_cell


def _snapshot(tree):
    out = {}
    for d, _, files in os.walk(tree):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, tree)] = fh.read()
    return out


def test_new_cell_config_and_metric_are_found(tmp_path):
    from benchmark import harness

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _snapshot(tmp_path / "benchmark")

    w, c = small_cell("mtrl_zoo_ibl.render_512")
    c["name"] = "zoo_small"
    (tmp_path / "benchmark" / "configs" / "zoo_small.json").write_text(json.dumps(c))
    w["config"] = "zoo_small"
    (tmp_path / "benchmark" / "workloads" / "zoo_small.render_tiny.json").write_text(json.dumps(w))
    (tmp_path / "benchmark" / "metrics" / "renders.count.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "zoo_small", "source": "https://github.com/nackdai/aten",
                           "file": "benchmark/configs/zoo_small.json", "reduced": [],
                           "why": "a test's copy"})
    man["workloads"].append({"name": "zoo_small.render_tiny", "config": "zoo_small",
                             "traffic": "render_tiny", "chips": 1, "why": "a test's cell"})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"] == "mpaths_per_s":
            m["workloads"].append("zoo_small.render_tiny")
    man["per_layer"].append({"name": "renders.count", "unit": "renders", "better": "higher",
                             "source": "host_clock", "layer": "device",
                             "moves": "mpaths_per_s", "workloads": ["zoo_small.render_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    res, _, _ = harness.run_cell("zoo_small.render_tiny", 3, 0.0, False, "cpu", time.time(),
                                 root=str(tmp_path))
    assert res["correct"] and set(res["metrics"]) == {"mpaths_per_s", "setup_s"}
    res, _, _ = harness.run_cell("zoo_small.render_tiny", 3, 0.0, True, "cpu", time.time(),
                                 root=str(tmp_path))
    assert res["metrics"]["renders.count"]["value"] == 1.0
    after = _snapshot(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
