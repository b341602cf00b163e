"""Small copies of the benchmark's cells for the CPU tests."""
import copy
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("knot102k.render_720p", "mtrl_zoo_ibl.render_512", "knot102k.train_1024")


def small_cell(name):
    """(workload, config) of cell `name` cut to a CPU test's size: 32x24
    pixels, 2 samples a render, 64 checked pixels an image, a knot of 40 x
    16 quads (1,284 prims, still above the dense test's 512)."""
    from benchmark import harness

    spec = harness.cell_spec(harness.manifest(ROOT), name)
    bench = os.path.join(ROOT, "benchmark")
    w = copy.deepcopy(harness.load_json(os.path.join(bench, "workloads", name + ".json")))
    c = copy.deepcopy(harness.load_json(os.path.join(bench, "configs", spec["config"] + ".json")))
    w["width"], w["height"] = 32, 24
    if w["entry"] == "render":
        w["spp"] = 2
        w["check"]["pixels_per_image"] = 64
    for m in c["scene"].get("meshes", ()):
        m["n_u"], m["n_v"] = 40, 16
    return w, c
