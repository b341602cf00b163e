"""The traversal kernel's yardstick, fixed in the benchmark."""
from benchmark import roofline


def test_peaks_are_the_data_sheet():
    assert roofline.PEAK_HBM_BYTES_PER_S == 3.35e12
    assert "H100" in roofline.PEAK_SOURCE and "700 W" in roofline.PEAK_SOURCE


def test_k1_bytes():
    # 28 B in, 16 B out a closest-hit ray; 28 in, 8 out a shadow ray; 36 B
    # a triangle once a bounce
    assert roofline.k1_bytes(1, 0, 0, 0) == 44
    assert roofline.k1_bytes(0, 1, 0, 0) == 36
    assert roofline.k1_bytes(0, 0, 10, 5) == 1800
    assert roofline.k1_bytes(1000, 500, 102404, 5) == 1000 * 44 + 500 * 36 + 5 * 102404 * 36
    assert roofline.least_seconds(3.35e12) == 1.0


def test_roofline_reader_uses_reference_counts():
    """The reader reads K1's time from the trace and its work from the
    reference's counters, and finds nothing without either."""
    import importlib.util
    import os

    from bench_cells import ROOT

    path = os.path.join(ROOT, "benchmark", "metrics", "k1_roofline_pct.render.py")
    spec = importlib.util.spec_from_file_location("k1_roofline_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Ctx:
        counters = {"rays.closest": 3.35e9 / 44, "rays.shadow": 0, "num_tris": 0, "bounces": 5}

    class Run:
        ctx, entry, units = Ctx(), "render", 2
        trace = {"per_name": {"void bvh_traverse_kernel<false, false, false>": 0.02,
                              "other": 1.0}}

    assert abs(mod.read(Run()) - 10.0) < 1e-9  # 1 ms of least time over 10 ms a render
    Run.trace = {"per_name": {"other": 1.0}}
    assert mod.read(Run()) is None
