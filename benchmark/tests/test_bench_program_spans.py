"""The per-layer metrics read from the program's own spans and counters
(benchmark/program_spans.py over aten_tpu_torch/utils/spans.py): reported
in a traced run of each cell, absent from an untraced one, and on the same
host clock as the benchmark's own spans and the device trace."""
import math
import time

import pytest

from bench_cells import CELLS, small_cell

NEW = {"render": {"sampler_ms.render", "traverse_ms.render", "shade_ms.render",
                  "nee_ms.render", "live_lanes_pct.render"},
       "train": {"forward_ms.train", "backward_ms.train"}}


@pytest.fixture(autouse=True)
def empty():
    from aten_tpu_torch.utils import spans

    spans.reset()
    yield
    spans.reset()


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_program_metrics(name):
    from benchmark import harness

    w, c = small_cell(name)
    new = NEW[w["entry"]]
    res, _, _ = harness.run_cell(name, 2**31 + 5, 0.0, True, "cpu", time.time(), workload=w,
                                 config=c)
    assert res["correct"], res["compared"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in new}
    assert set(got) == new
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    if "live_lanes_pct.render" in got:
        assert got["live_lanes_pct.render"] <= 100.0
    res, _, _ = harness.run_cell(name, 2**31 + 5, 0.0, False, "cpu", time.time(), workload=w,
                                 config=c)
    assert not set(res["metrics"]) & new


def test_idle_gap_is_labelled_with_the_program_stage():
    """A gap on the card that begins while the host is inside the
    program's "shade" span takes that name, not the benchmark's "render"."""
    from aten_tpu_torch.utils import spans

    from benchmark import harness
    from benchmark.trace import summarize

    ctx = harness.Context("x", {}, {}, "cpu", 0)
    with spans.recording(), ctx.span("render"):
        with spans.span("render"):
            time.sleep(0.002)
            with spans.span("shade"):
                time.sleep(0.004)
            time.sleep(0.002)
    (_, s0, s1), = [s for s in spans.host_spans() if s[0] == "shade"]
    (_, b0, b1), = ctx.spans
    mid = (s0 + s1) // 2
    events = [("op_a", b0, mid - b0), ("op_b", b1 - 1000, 1000)]
    summary = summarize(events, b0, b1, ctx.spans + spans.host_spans())
    assert summary["idle_gaps"][0][0] == "shade"
    assert summarize(events, b0, b1, ctx.spans)["idle_gaps"][0][0] == "render"
