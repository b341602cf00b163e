"""The check has to fail what is wrong: the reference in bfloat16 in the
program's place (the control), and a run with the timed path broken
underneath (the faults), each at a CPU test's size."""
import time

import pytest
import torch

from bench_cells import CELLS, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    from benchmark.control import control_numbers

    w, c = small_cell(name)
    numbers = control_numbers(name, 77, "bf16", 2, "cpu", workload=w, config=c)
    assert any(not v <= lim for _, v, lim in numbers), numbers


def _stale(pt, real):
    """render_image that returns its first image again: state unchanged."""
    cache = {}

    def fake(*a, **k):
        if "img" not in cache:
            cache["img"] = real(*a, **k)
        return cache["img"]

    return fake


def _half_samples(pt, real):
    """render_image over half of the samples, the mean over the rest."""
    return lambda scene, cam, spp=16, **k: real(scene, cam, spp=max(1, spp // 2), **k)


def _altered(pt, real):
    """render_image whose image is altered where it is produced."""
    return lambda *a, **k: real(*a, **k) * 1.05


@pytest.mark.parametrize("fault", [_stale, _half_samples, _altered])
@pytest.mark.parametrize("name", ["knot102k.render_720p", "mtrl_zoo_ibl.render_512"])
def test_render_faults_fail(name, fault, monkeypatch):
    from aten_tpu_torch.integrator import pathtracer

    from benchmark import harness

    monkeypatch.setattr(pathtracer, "render_image", fault(pathtracer, pathtracer.render_image))
    w, c = small_cell(name)
    result, _, _ = harness.run_cell(name, 4242, 0.3, False, "cpu", time.time(), workload=w,
                                    config=c)
    assert result["attempted"] >= 1
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("family", ["VELVET", "DISNEY", "REFRACTION"])
def test_render_fault_in_one_family_fails(family, monkeypatch):
    """One of the zoo's BSDF families with its value f(wo, wi) scaled by
    0.9 in the program, every pixel of the small image checked."""
    from aten_tpu_torch.scene.materials import MaterialType
    from aten_tpu_torch.shading import brdf

    from benchmark import harness
    from benchmark.control import scaled_family

    name = "mtrl_zoo_ibl.render_512"
    w, c = small_cell(name)
    w["width"], w["height"] = 64, 48  # each sphere some 16 pixels
    w["check"]["pixels_per_image"] = w["width"] * w["height"]
    with scaled_family(brdf, MaterialType[family]):
        result, _, _ = harness.run_cell(name, 4243, 0.0, False, "cpu", time.time(),
                                        workload=w, config=c)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("family", ["VELVET", "REFRACTION"])
def test_family_fault_in_the_reference_reads_high(family):
    """The family fault as planted in the reference (the readings PERF.md
    gives at the cell's size) fails the check here too."""
    from benchmark.control import control_numbers

    w, c = small_cell("mtrl_zoo_ibl.render_512")
    w["width"], w["height"] = 64, 48
    w["check"]["pixels_per_image"] = w["width"] * w["height"]
    numbers = control_numbers("mtrl_zoo_ibl.render_512", 78, "family", 1, "cpu", workload=w,
                              config=c, family=family)
    assert any(not v <= lim for _, v, lim in numbers), numbers


def _window_steps(monkeypatch, units, altered_from=None):
    """The train cell's small copy driven through set-up and `units` window
    steps; from call `altered_from` on (the warm-up is call 1) the step
    alters its update.  Returns the compared numbers."""
    from aten_tpu_torch.parallel import mesh

    from benchmark import harness
    from benchmark.entries import train

    real = mesh.make_train_step

    def make(*a, **k):
        step, calls = real(*a, **k), []

        def maybe_altered(scene, cam, target, frame):
            loss, out = step(scene, cam, target, frame)
            calls.append(frame)
            if len(calls) >= altered_from:
                bc = out["materials"]["base_color"]
                out = mesh._set_params(out, {"base_color": bc * 1.05})
            return loss, out

        return maybe_altered

    if altered_from is not None:
        monkeypatch.setattr(mesh, "make_train_step", make)
    name = "knot102k.train_1024"
    w, c = small_cell(name)
    cell = train.Cell(harness.Context(name, w, c, "cpu", 2**31 + 5))
    for i in range(units):
        cell.run_unit(i)
    assert len(cell.window["loss"]) == min(units, w["check"]["checked_steps"])
    return cell.check()


def test_train_window_steps_are_checked_sound(monkeypatch):
    compared = _window_steps(monkeypatch, 6)
    assert all(v <= 1e-6 for _, v, _ in compared), compared  # the same arithmetic here


@pytest.mark.parametrize("altered_from", [3, 7])
def test_train_window_steps_are_checked(monkeypatch, altered_from):
    """The check compares the window's own steps: a step that is sound in
    set-up's warm-up and in the window's first step (or first five) and
    alters its update from then on fails."""
    compared = _window_steps(monkeypatch, 6, altered_from)
    assert any(not v <= lim for _, v, lim in compared), compared


def test_train_fault_unchanged_state_fails(monkeypatch):
    from aten_tpu_torch.parallel import mesh

    from benchmark import harness

    real = mesh.make_train_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda scene, cam, target, frame: (step(scene, cam, target, frame)[0], scene)

    monkeypatch.setattr(mesh, "make_train_step", make)
    w, c = small_cell("knot102k.train_1024")
    result, _, _ = harness.run_cell("knot102k.train_1024", 99, 0.0, False, "cpu", time.time(),
                                    workload=w, config=c)
    assert not result["correct"], result["compared"]


def test_train_fault_half_batch_fails(monkeypatch):
    from aten_tpu_torch.parallel import mesh

    from benchmark import harness

    monkeypatch.setattr(mesh, "_band", lambda height, group, device: (0, height // 2))
    w, c = small_cell("knot102k.train_1024")
    result, _, _ = harness.run_cell("knot102k.train_1024", 99, 0.0, False, "cpu", time.time(),
                                    workload=w, config=c)
    assert not result["correct"], result["compared"]


def test_train_fault_altered_answer_fails(monkeypatch):
    """The update of one trained value off by lr where it is produced."""
    from aten_tpu_torch.parallel import mesh

    from benchmark import harness

    real = mesh.rms_update

    def altered(scene, grads, lr):
        out = real(scene, grads, lr)
        bc = out["materials"]["base_color"]
        bump = torch.zeros_like(bc)
        bump.view(-1)[0] = lr
        return mesh._set_params(out, {"base_color": bc + bump})

    monkeypatch.setattr(mesh, "rms_update", altered)
    w, c = small_cell("knot102k.train_1024")
    result, _, _ = harness.run_cell("knot102k.train_1024", 99, 0.0, False, "cpu", time.time(),
                                    workload=w, config=c)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("mode", ["half", "alter"])
def test_train_faults_in_the_reference_read_high(mode):
    """The faults as planted in the reference (the readings PERF.md gives
    at the cell's size) fail the check here too."""
    from benchmark.control import control_numbers

    w, c = small_cell("knot102k.train_1024")
    numbers = control_numbers("knot102k.train_1024", 5, mode, 0, "cpu", workload=w, config=c)
    assert any(not v <= lim for _, v, lim in numbers), numbers
