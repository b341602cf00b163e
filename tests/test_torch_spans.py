"""The port's registry of spans and counters (aten_tpu_torch/utils/spans.py)
on the CPU: spans and tallies recording only while a profiler records or
inside `spans.recording()`, host counters always; the parent, root and
self-time arithmetic; the stages of a render and of a train step; the
lane counters; and that recording changes no output bit and adds no op
but the tallies'."""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.parallel.mesh import make_train_step
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.shading import dispatch
from aten_tpu_torch.utils import spans

RENDER_STAGES = {"render", "traverse", "sampler", "shade", "nee"}
STEP_STAGES = {"step", "forward", "backward", "traverse", "sampler", "shade", "nee"}
W = H = 8


@pytest.fixture(autouse=True)
def empty():
    spans.reset()
    yield
    spans.reset()


def _plant(depth=2):
    """Three nested spans "a" > "b" > "b", each sleeping before and after
    its child, and a sibling root "c"."""
    def nest(names):
        if not names:
            return
        with spans.span(names[0]):
            time.sleep(0.002)
            nest(names[1:])
            time.sleep(0.002)

    nest(["a", "b", "b"][:depth + 1])
    with spans.span("c"):
        spans.count("n", 2)
        spans.tally("t", torch.tensor([1, 2, 3]))


def test_off_leaves_no_record_counter_or_tally():
    """Off: no span, no tally, no lane counter; a host counter counts."""
    assert not spans.active()
    assert spans.span("a") is spans.span("b")  # one shared null context
    _plant()
    assert spans.records() == [] and spans.host_spans() == []
    assert spans.counters() == {"n": 2}


@pytest.mark.parametrize("how", ["recording", "profiler", "both"])
def test_records_while_on_and_not_after(how):
    if how == "recording":
        with spans.recording():
            _plant()
    elif how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            _plant()
    else:
        with profile(activities=[ProfilerActivity.CPU]), spans.recording():
            with spans.recording():
                _plant()
    names = [r["name"] for r in spans.records()]
    assert names == ["b", "b", "a", "c"]
    assert spans.counters() == {"n": 2, "t": 6}
    assert not spans.active()
    _plant()
    assert [r["name"] for r in spans.records()] == names
    assert spans.counters() == {"n": 4, "t": 6}
    spans.reset()
    assert spans.records() == [] and spans.counters() == {}


def test_parent_root_and_self_time():
    with spans.recording():
        _plant()
    inner, mid, outer, sib = spans.records()
    assert (outer["parent"], mid["parent"], inner["parent"]) == (None, outer["id"], mid["id"])
    assert {outer["root"], mid["root"], inner["root"]} == {outer["id"]}
    assert sib["parent"] is None and sib["root"] == sib["id"] != outer["id"]
    for r in (inner, mid, outer, sib):
        # on the CPU the host interval stands in for the device interval
        assert r["device_ms"] == (r["end_ns"] - r["start_ns"]) / 1e6
        assert r["start_ns"] <= r["end_ns"]
    assert outer["start_ns"] <= mid["start_ns"] <= inner["start_ns"]
    assert inner["end_ns"] <= mid["end_ns"] <= outer["end_ns"]
    assert inner["self_ms"] == inner["device_ms"] >= 4.0
    assert mid["self_ms"] == mid["device_ms"] - inner["device_ms"] >= 4.0
    assert outer["self_ms"] == outer["device_ms"] - mid["device_ms"] >= 4.0
    # a nested span of one name: its self times sum the outer one's time once
    b = sum(r["self_ms"] for r in (inner, mid))
    assert b == pytest.approx(mid["device_ms"], rel=1e-12)
    assert spans.host_spans() == [(r["name"], r["start_ns"], r["end_ns"])
                                  for r in (inner, mid, outer, sib)]


def test_threads_keep_their_own_stacks():
    with spans.recording():
        with spans.span("main"):
            t = threading.Thread(target=lambda: spans.span("other").__enter__().__exit__())
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    other, main = spans.records()
    assert other["name"] == "other" and other["parent"] is None and other["root"] == other["id"]
    assert main["parent"] is None


def _scene(kind):
    if kind == "cornell":
        return tdefs.cornell_box(W, H, device="cpu")
    if kind == "knot":  # 1,284 prims: K1's plain version
        return tdefs.procedural_mesh_scene(W, H, n_u=40, n_v=16, device="cpu")
    return tdefs.material_test_scene(W, H, device="cpu")


def _render(scene, cam):
    return render_image(scene, cam, spp=4, max_depth=3, rr_depth=1, spp_chunk=2)


class _Ops(TorchDispatchMode):
    """The aten ops run inside, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["cornell", "knot", "zoo"])
def test_render_stages_lanes_and_bits(kind, monkeypatch):
    monkeypatch.setattr(dispatch, "_ENV_PARTITION", False)
    scene, cam = _scene(kind)
    _render(scene, cam)  # the scene's first render fills its caches
    with _Ops() as off_ops:
        off = _render(scene, cam)
    assert spans.records() == [] and spans.counters() == {}
    with spans.recording(), _Ops() as on_ops:
        on = _render(scene, cam)
    assert torch.equal(on, off)
    recs = spans.records()
    assert {r["name"] for r in recs} == RENDER_STAGES
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["render"]
    assert all(r["root"] == roots[0]["id"] for r in recs)
    c = spans.counters()
    n, depth, chunks = W * H * 2, 3, 2
    issued = {k: v for k, v in c.items() if k.startswith("lanes.issued.")}
    live = [c[f"lanes.live.{b}"] for b in range(depth)]
    assert issued == {f"lanes.issued.{b}": n * chunks for b in range(depth)}
    assert sum(issued.values()) == n * depth * chunks
    assert live[0] == n * chunks and all(a >= b for a, b in zip(live, live[1:]))
    assert not any(k.startswith("host_sync.") for k in c)
    # spans add no op; a bounce's tally is one op a chunk: the first chunk
    # copies its mask into the bounce's accumulator, the next adds to it
    extra = list(on_ops.ops)
    for op in off_ops.ops:
        extra.remove(op)
    assert sorted(extra) == sorted(["aten._to_copy"] * depth
                                   + ["aten.add_"] * depth * (chunks - 1))


def test_train_step_stages_and_bits():
    scene, cam = tdefs.cornell_box(W, H, device="cpu")
    ca = cam.arrays("cpu")
    step = make_train_step(W, H, spp=1, max_depth=2, rr_depth=1)
    target = torch.full((H, W, 3), 0.25)
    loss0, s0 = step(scene, ca, target, 0)
    with spans.recording():
        loss1, s1 = step(scene, ca, target, 0)
    assert torch.equal(loss0, loss1)
    for k in ("base_color",):
        assert torch.equal(s0["materials"][k], s1["materials"][k])
    assert torch.equal(s0["lights"]["le"], s1["lights"]["le"])
    recs = spans.records()
    assert {r["name"] for r in recs} == STEP_STAGES
    by = {r["name"]: r for r in recs if r["name"] in ("step", "forward", "backward")}
    assert by["step"]["parent"] is None
    assert by["forward"]["parent"] == by["backward"]["parent"] == by["step"]["id"]
    assert by["forward"]["end_ns"] <= by["backward"]["start_ns"]
    assert spans.counters()["lanes.live.0"] == W * H


def test_dispatch_counts_its_host_read():
    mat = {"type": torch.tensor([3, 1, 3, 0]), "x": torch.arange(4.0)}

    def run_family(sub, m, a):
        return [a * 2.0]

    (got,) = dispatch._dispatch(mat, [torch.arange(4.0)], run_family)
    assert torch.equal(got, torch.arange(4.0) * 2.0)
    assert spans.counters() == {"host_sync.dispatch": 1}


def test_volume_counts_its_host_syncs():
    from aten_tpu_torch.integrator.volpt import render_volpt

    scene, cam = tdefs.hetero_volume_scene(8, 8, res=8, device="cpu")
    img = render_volpt(scene, cam, spp=1, max_depth=3)
    assert bool(torch.isfinite(img).all())
    c = spans.counters()
    assert c["host_sync.tracking"] > 0 and c["host_sync.shadow"] > 0
