"""Gradients and the inverse-rendering train step of aten_tpu_torch
against aten_tpu.

* d mean(radiance) / d {textures.tex_stack, lights.le, lights.pos} by
  `torch.autograd.grad` through the port's `_trace_paths` against
  `jax.grad` through the reference's, on the setups of tests/test_grad.py
  (the 4x4-texel textured quad, the Cornell box, the point-lit quad; 16x16
  at 1 spp): rtol 1e-4, atol 1e-6 (float32 rounding only).
* The port-only finite-difference counterparts of test_grad.py's four
  tests, with its steps and its bound (relative error under 0.15).
* `parallel.mesh.make_train_step` against aten_tpu's on the shapes of
  tests/test_sharding.py (16x16, 1 spp, depth 2, RR depth 1; the
  reference on its 8-device CPU mesh, the port in one process, which
  computes the same mean): from `base_color * 0.5` toward the 1-spp
  render at lr 0.1, the loss and each new field within rtol 1e-4 at step
  1, and steps 2-3 within the same bound; measured, every step's fields
  within 1.4e-7 relative (no lane's roulette or sampled lobe flipped).
  Also the light field toward a black target and the default fields on
  the textured quad (test_sharding.py:72-98).
* The step's plumbing: the live fields match the reference's on every
  setup, a trained scene keeps the packed kernel records of the scene it
  came from, and the caller's tensors are never written.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import _trace_paths as jax_trace_paths
from aten_tpu.integrator.pathtracer import render_sample as jax_render_sample
from aten_tpu.parallel import mesh as jmesh
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.pathtracer import _trace_paths
from aten_tpu_torch.parallel import mesh
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

S = 16
RTOL, ATOL = 1e-4, 1e-6


def _textured_quad(b, albedo=0.5, le=8.0, cam_z=2.2):
    """test_grad.py's textured setup: a quad with a 4x4 albedo texture
    filling the view, lit by a quad light (test_sharding.py's variant:
    albedo 0.8, le 6, camera at z 2)."""
    tid = b.add_texture(np.full((4, 4, 3), albedo, np.float32))
    m = b.add_material(MaterialType.DIFFUSE, base_color=(1, 1, 1), albedo_map=tid)
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(le, le, le))
    b.add_quad((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0), m)
    ls, lc = b.add_quad((-1, -1, 3), (-1, 1, 3), (1, 1, 3), (1, -1, 3), emit)
    b.add_area_light_tris(ls, lc, le=(le, le, le))
    return PinholeCamera(origin=(0, 0, cam_z), lookat=(0, 0, 0), vfov_deg=60, width=S, height=S)


def _point_lit_quad(b):
    """test_grad.py's point-lit quad (the light-position setup)."""
    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.8, 0.8, 0.8))
    b.add_quad((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0), m)
    b.add_point_light((0.5, 0.5, 2.0), (6, 6, 6))
    return PinholeCamera(origin=(0, 0, 2.5), lookat=(0, 0, 0), vfov_deg=60, width=S, height=S)


def _cornell_alpha(b):
    """The Cornell box with a blue veil at alpha 0.5 hung before the back
    wall: alpha punch-through and the shadow rays' transmittance walk."""
    cam = tdefs.populate_cornell_box(b, S, S)
    veil = b.add_material(MaterialType.DIFFUSE, base_color=(0.2, 0.4, 0.8), alpha=0.5)
    b.add_quad((-0.6, -0.6, -0.5), (0.6, -0.6, -0.5), (0.6, 0.6, -0.5), (-0.6, 0.6, -0.5), veil)
    return cam


SETUPS = {
    "cornell": lambda b: tdefs.populate_cornell_box(b, S, S),
    "cornell_alpha": _cornell_alpha,
    "textured": _textured_quad,
    "textured_bright": lambda b: _textured_quad(b, 0.8, 6.0, 2.0),
    "point": _point_lit_quad,
}


def _both(name):
    """(reference scene, port scene, reference cam arrays, port cam arrays)."""
    jb = JaxSceneBuilder()
    cam = SETUPS[name](jb)
    js = jb.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    return js, ts, JaxPinholeCamera(**dataclasses.asdict(cam)).arrays(), cam.arrays("cpu")


def _jax_set(scene, spec, value):
    return jmesh._set_params(scene, {spec: value})


# --- gradients against jax.grad --------------------------------------------


@pytest.mark.parametrize("setup,spec,depth", [
    ("textured", "textures.tex_stack", 2),
    ("cornell", "lights.le", 3),
    ("point", "lights.pos", 2),
])
def test_grad_matches_reference(setup, spec, depth):
    js, ts, jca, tca = _both(setup)

    def jloss(v):
        rad = jax_trace_paths(_jax_set(js, spec, v), jca, S, S, jnp.uint32(0), jnp.uint32(0),
                              1, depth, 2)
        return jnp.mean(rad)

    ref = np.asarray(jax.jit(jax.grad(jloss))(jmesh._get_param(js, spec)))
    leaf = mesh._get_param(ts, spec).clone().requires_grad_(True)
    rad = _trace_paths(mesh._set_params(ts, {spec: leaf}), tca, S, S, 0, 0, 1, depth, 2)
    (got,) = torch.autograd.grad(rad.mean(), leaf)
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(ref).max() > 1e-3  # the loss does depend on the field
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# --- the finite-difference counterparts of tests/test_grad.py ----------------


def _port_loss_and_grad(scene, tca, spec, value, depth, grad=True):
    leaf = value.clone().requires_grad_(grad)
    loss = _trace_paths(mesh._set_params(scene, {spec: leaf}), tca, S, S, 0, 0, 1, depth, 2).mean()
    if not grad:
        return float(loss)
    (g,) = torch.autograd.grad(loss, leaf)
    return float(loss.detach()), g.numpy()


def _fd_check(scene, tca, spec, index, eps, depth):
    v = mesh._get_param(scene, spec)
    _, g = _port_loss_and_grad(scene, tca, spec, v, depth)
    assert np.isfinite(g).all()
    plus, minus = v.clone(), v.clone()
    plus[index] += eps
    minus[index] -= eps
    fd = (_port_loss_and_grad(scene, tca, spec, plus, depth, grad=False)
          - _port_loss_and_grad(scene, tca, spec, minus, depth, grad=False)) / (2 * eps)
    rel = abs(fd - g[index]) / max(abs(fd), 1e-6)
    assert rel < 0.15, (fd, g[index])
    return g


def test_port_grad_matches_finite_difference():
    scene, cam = tdefs.cornell_box(S, S, device="cpu")
    g = _fd_check(scene, cam.arrays("cpu"), "base_color", (0, 0), 1e-2, 3)
    assert g[0].sum() > 0  # the white walls brighten the image


def test_port_grad_wrt_emission():
    scene, cam = tdefs.cornell_box(S, S, device="cpu")
    base = scene["materials"]["base_color"]
    scale = torch.tensor(1.0, requires_grad=True)
    bc = torch.cat([base[:3], base[3:4] * scale, base[4:]])
    rad = _trace_paths(mesh._set_params(scene, {"base_color": bc}), cam.arrays("cpu"),
                       S, S, 0, 0, 1, 3, 2)
    (g,) = torch.autograd.grad(rad.mean(), scale)
    assert torch.isfinite(g) and float(g) > 0  # a brighter light, a brighter image


def test_port_grad_wrt_texture_texels():
    b = SceneBuilder()
    cam = _textured_quad(b)
    g = _fd_check(b.build("cpu"), cam.arrays("cpu"), "textures.tex_stack", (0, 0, 0, 0), 1e-2, 2)
    assert g[0, 0, 0, :3].sum() > 0  # uv 0 everywhere: texel (0, 0) takes it all


def test_port_grad_wrt_light_params():
    scene, cam = tdefs.cornell_box(S, S, device="cpu")
    g = _fd_check(scene, cam.arrays("cpu"), "lights.le", (0, 0), 0.5, 3)
    assert g[0].sum() > 0
    b = SceneBuilder()
    pcam = _point_lit_quad(b)
    gp = _fd_check(b.build("cpu"), pcam.arrays("cpu"), "lights.pos", (0, 2), 5e-2, 2)
    assert np.abs(gp[0]).sum() > 0


# --- the train step against the reference's ----------------------------------


def _steps(setup, n_steps, perturb, target_kind, lr, fields=None):
    """n_steps of both packages' train steps: lists of (loss, {spec: field})."""
    js, ts, jca, tca = _both(setup)
    kw = {} if fields is None else {"fields": fields}
    if target_kind == "render":
        target = np.asarray(jax_render_sample(js, jca, S, S, jnp.uint32(0), jnp.uint32(0),
                                              1, 2, 1))
    else:
        target = np.zeros((S, S, 3), np.float32)
    spec, factor = perturb or (None, None)
    if spec is not None:
        js = _jax_set(js, spec, jmesh._get_param(js, spec) * factor)
        ts = mesh._set_params(ts, {spec: mesh._get_param(ts, spec) * factor})
    live = [k for k in (fields or mesh.TRAINABLE_FIELDS) if jmesh._has_param(js, k)]
    assert live == [k for k in (fields or mesh.TRAINABLE_FIELDS) if mesh._has_param(ts, k)]
    jstep = jmesh.make_train_step(S, S, spp=1, max_depth=2, rr_depth=1,
                                  mesh=jmesh.make_mesh(8), lr=lr, **kw)
    tstep = mesh.make_train_step(S, S, spp=1, max_depth=2, rr_depth=1, lr=lr, **kw)
    out = {"jax": [], "torch": []}
    for _ in range(n_steps):
        loss, js = jstep(js, jca, jnp.asarray(target), jnp.uint32(0))
        out["jax"].append((float(loss), {k: np.asarray(jmesh._get_param(js, k)) for k in live}))
        tloss, ts = tstep(ts, tca, torch.tensor(target), 0)
        out["torch"].append((float(tloss), {k: mesh._get_param(ts, k).numpy() for k in live}))
    return out, live


@pytest.fixture(scope="module")
def material_steps():
    return _steps("cornell", 3, ("base_color", 0.5), "render", 0.1)


def test_train_step_one_matches_reference(material_steps):
    out, live = material_steps
    assert live == ["base_color", "lights.le"]
    (jl, jf), (tl, tf) = out["jax"][0], out["torch"][0]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for k in live:
        np.testing.assert_allclose(tf[k], jf[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_train_steps_two_and_three_match_reference(material_steps):
    out, live = material_steps
    losses = []
    for (jl, jf), (tl, tf) in zip(out["jax"][1:], out["torch"][1:]):
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        for k in live:
            np.testing.assert_allclose(tf[k], jf[k], rtol=RTOL, atol=ATOL, err_msg=k)
        losses.append(tl)
    assert losses[-1] < out["torch"][0][0]  # the step descends


def test_train_step_light_field_matches_reference():
    """test_sharding.py:72-98: the emitter moves down toward black."""
    out, live = _steps("cornell", 1, None, "black", 0.05, fields=("base_color", "lights.le"))
    (jl, jf), (tl, tf) = out["jax"][0], out["torch"][0]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for k in live:
        np.testing.assert_allclose(tf[k], jf[k], rtol=RTOL, atol=ATOL, err_msg=k)
    js, ts, _, _ = _both("cornell")
    assert tf["lights.le"][0].sum() < mesh._get_param(ts, "lights.le")[0].sum()


def test_train_step_default_fields_train_the_texture():
    """test_sharding.py's default-field step on the textured quad: the
    dimmed texture moves up toward the target, step for step as in the
    reference."""
    out, live = _steps("textured_bright", 2, ("textures.tex_stack", 0.4), "render", 0.05)
    assert live == ["base_color", "textures.tex_stack", "lights.le"]
    for (jl, jf), (tl, tf) in zip(out["jax"], out["torch"]):
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        for k in live:
            np.testing.assert_allclose(tf[k], jf[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert out["torch"][1][0] < out["torch"][0][0]
    assert out["torch"][1][1]["textures.tex_stack"].mean() > 0.4 * 0.8


# --- the step's plumbing ------------------------------------------------------


def test_set_params_keeps_layouts_and_the_callers_tensors():
    scene, cam = tdefs.procedural_mesh_scene(S, S, 48, 16, device="cpu")
    assert "bvh_nodes" in scene and scene["num_tris"] + scene["num_spheres"] > 512
    before = {k: mesh._get_param(scene, k).clone() for k in ("base_color", "lights.le")}
    step = mesh.make_train_step(S, S, spp=1, max_depth=2, rr_depth=1, lr=0.1)
    loss, new = step(scene, cam.arrays("cpu"), torch.zeros((S, S, 3)), 0)
    assert loss.requires_grad is False and float(loss) > 0
    for k, v in before.items():
        assert torch.equal(mesh._get_param(scene, k), v), k  # the caller's scene is unchanged
        got = mesh._get_param(new, k)
        assert not got.requires_grad and not torch.equal(got, v), k
    for k in ("bvh_nodes", "bvh_prims", "nodes_bmin", "tri_v0"):
        assert new[k] is scene[k], k  # the kernel's records ride along
    assert new.static is scene.static and new.device == scene.device
    assert new["materials"]["type"] is scene["materials"]["type"]


def test_train_step_refuses_unported_features():
    """Nothing of the reference's scene features is refused any more.  A
    scene with alpha, which the step once refused, steps as the
    reference's: the Cornell box with an alpha veil, toward black, the
    loss and the new fields within rtol 1e-4.  A scene whose material
    carries a medium, which the build once refused, builds (media are
    ported, PR 14) and steps, the path tracer not reading the medium:
    its loss is that of the same scene without one."""
    out, live = _steps("cornell_alpha", 1, None, "black", 0.05)
    assert live == ["base_color", "lights.le"]
    (jl, jf), (tl, tf) = out["jax"][0], out["torch"][0]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for k in live:
        np.testing.assert_allclose(tf[k], jf[k], rtol=RTOL, atol=ATOL, err_msg=k)
    losses = []
    for with_medium in (True, False):
        b = SceneBuilder()
        if with_medium:
            b.add_medium(sigma_s=(0.5, 0.5, 0.5))
        m = b.add_material(MaterialType.DIFFUSE, medium=0 if with_medium else -1)
        b.add_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0), m)
        b.add_point_light((0.0, 0.0, 2.0), (4.0, 4.0, 4.0))
        scene = b.build("cpu")
        assert ("med_sigma_a" in scene) == with_medium
        cam = PinholeCamera(origin=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0), width=8, height=8)
        step = mesh.make_train_step(8, 8, spp=1, max_depth=2, rr_depth=1)
        loss, _ = step(scene, cam.arrays("cpu"), torch.zeros(8, 8, 3), 0)
        losses.append(float(loss))
    assert losses[0] == losses[1] and losses[0] > 0.0, losses
