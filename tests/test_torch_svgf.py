"""SVGF (`aten_tpu_torch/denoise/svgf.py`) and AO (`integrator/ao.py`)
against aten_tpu.

* The denoiser: the reference renders the Cornell box at 32x32, one
  sample a frame, depth 3, for four frames while its camera orbits
  (CameraOperator.orbit, 0.02 rad a frame), and both denoisers take the
  same radiance and AOVs (the reference's run op by op under
  `jax.disable_jit()`; the jitted reference contracts multiply-adds).
  Each frame: history and valid equal on >= 99.9% of pixels; the
  filtered output and the state's colour and moments within rtol 1e-4,
  atol 1e-6 on >= 99.9% of pixels, with max abs < 1e-3 everywhere
  (measured: every pixel, 6e-6 abs, 1e-6 rel).
* Object motion: `inst_l2w_from_w2l` and `object_motion_pos` on seeded
  instance transforms within rtol 1e-5 (atol 1e-5; a 3x3 inverse by two
  LAPACKs), and the reference's two-instance test on the port.
* The reference's SVGF and AO tests (tests/test_svgf.py), on the port.
* `render_ao` on the Cornell box at 32x32 (spp 2, 8 rays, radius 2.5)
  equal to the reference's at >= 99.9% of pixels (visibility is binary;
  measured: all), and on the 2,004-prim knot through K1's plain version
  equal to the oracle walk's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import camera as jcam
from aten_tpu.denoise import svgf as jsvgf
from aten_tpu.integrator.ao import render_ao as jax_render_ao
from aten_tpu.integrator.pathtracer import render_sample_with_aovs as jax_render_aovs
from aten_tpu.scene.scenedefs import cornell_box as jax_cornell_box
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.denoise import svgf
from aten_tpu_torch.integrator.ao import render_ao
from aten_tpu_torch.integrator.pathtracer import render_image, render_sample_with_aovs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder
from aten_tpu_torch.scene.scenedefs import cornell_box, procedural_mesh_scene

torch.set_num_threads(1)

W = H = 32
FRAC = 0.999
RTOL, ATOL, MAX_ABS = 1e-4, 1e-6, 1e-3


def _frac_close(got, ref):
    """Fraction of pixels whose every channel is within RTOL, ATOL."""
    ok = np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)
    return ok.reshape(ok.shape[0], ok.shape[1], -1).all(-1).mean()


@pytest.fixture(scope="module")
def setup():
    return cornell_box(W, H, device="cpu")


@pytest.fixture(scope="module")
def jax_frames():
    """Four frames of the reference's render: (img, aovs, camera)."""
    js, cam = jax_cornell_box(W, H)
    out = []
    for f in range(4):
        img, aovs = jax_render_aovs(js, cam.arrays(), W, H, jnp.uint32(f), jnp.uint32(0), 1, 3, 2)
        out.append((np.array(img), {k: np.array(v) for k, v in aovs.items()}, cam))
        cam = jcam.CameraOperator.orbit(cam, 0.02, 0.0)
    return out


def test_svgf_matches_reference(jax_frames):
    jd = jsvgf.SVGFDenoiser(W, H)
    td = svgf.SVGFDenoiser(W, H, device="cpu")
    for f, (img, aovs, cam) in enumerate(jax_frames):
        with jax.disable_jit():
            ref = np.asarray(jd.step(jnp.asarray(img), {k: jnp.asarray(v) for k, v in aovs.items()},
                                     cam))
        got = td.step(torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in aovs.items()},
                      PinholeCamera(**dataclasses.asdict(cam))).numpy()
        pairs = [("out", got, ref)] + [
            (k, td.state[k].numpy(), np.asarray(jd.state[k])) for k in ("color", "moments")]
        for name, a, b in pairs:
            assert _frac_close(a, b) >= FRAC, (f, name)
            assert np.abs(a - b).max() < MAX_ABS, (f, name)
        for k in ("history", "valid"):
            assert (td.state[k].numpy() == np.asarray(jd.state[k])).mean() >= FRAC, (f, k)
        if f:
            # the orbit keeps most of the history
            assert td.state["history"].numpy().mean() > 1.5, f


def _affine_rows(rng, n):
    """n seeded [3, 4] affine rows (rotation times scale, translation)
    and the identity row, as a scene's inst_w2l holds them."""
    m = np.zeros((n + 1, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m[i, :, :3] = q * rng.uniform(0.5, 2.0, 3)
        m[i, :, 3] = rng.uniform(-3, 3, 3)
    m[n, :, :3] = np.eye(3)
    return m


def test_object_motion_matches_reference():
    rng = np.random.default_rng(7)
    n = 3
    cur_w2l = _affine_rows(rng, n)
    prev_w2l = _affine_rows(rng, n)
    prev_l2w = np.array(jsvgf.inst_l2w_from_w2l(jnp.asarray(prev_w2l)))
    np.testing.assert_allclose(svgf.inst_l2w_from_w2l(torch.from_numpy(prev_w2l)).numpy(),
                               prev_l2w, rtol=1e-5, atol=1e-5)
    pos = rng.uniform(-5, 5, (H, W, 3)).astype(np.float32)
    inst = rng.integers(-1, n, (H, W)).astype(np.int32)
    with jax.disable_jit():
        ref = np.asarray(jsvgf.object_motion_pos(jnp.asarray(pos), jnp.asarray(inst),
                                                 jnp.asarray(cur_w2l), jnp.asarray(prev_l2w)))
    got = svgf.object_motion_pos(torch.from_numpy(pos), torch.from_numpy(inst),
                                 torch.from_numpy(cur_w2l), torch.from_numpy(prev_l2w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[inst < 0], pos[inst < 0])


def _two_instance_scene(tx):
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.8, 0.2, 0.2))
    o = b.create_object()
    quad = np.array([[-0.6, -0.6, 0], [0.6, -0.6, 0], [0.6, 0.6, 0], [-0.6, 0.6, 0]],
                    np.float32)
    b.add_mesh(quad, [[0, 1, 2], [0, 2, 3]], m, obj=o)
    mtx = np.eye(4, dtype=np.float32)
    mtx[0, 3] = tx
    b.add_instance(o, mtx)
    o2 = b.create_object()
    back = quad * 8.0
    back[:, 2] = -2.0
    b.add_mesh(back, [[0, 1, 2], [0, 2, 3]],
               b.add_material(MaterialType.DIFFUSE, base_color=(0.3, 0.3, 0.35)), obj=o2)
    b.add_instance(o2, np.eye(4, dtype=np.float32))
    b.add_point_light((0, 2, 4), (30, 30, 30))
    return b.build("cpu")


def test_object_motion_vectors_accept_moving_instance():
    """tests/test_svgf.py's test on the port: a translating instance keeps
    its history when the denoiser is fed the scene, and loses it at its
    edges when not."""
    w = h = 48
    cam = PinholeCamera(origin=(0, 0, 4), lookat=(0, 0, 0), vfov_deg=45, width=w, height=h)
    ca = cam.arrays("cpu")

    def run(with_motion):
        den = svgf.SVGFDenoiser(w, h, device="cpu")
        for f, tx in enumerate((0.0, 0.5)):
            scene = _two_instance_scene(tx)
            img, aovs = render_sample_with_aovs(scene, ca, w, h, f, 0, 1, 2, 1)
            den.step(img, aovs, cam, scene=scene if with_motion else None)
        on_obj = aovs["inst"].numpy() == 0
        assert on_obj.sum() > 20
        return den.state["history"].numpy()[on_obj].mean()

    h_motion = run(True)
    h_static = run(False)
    assert h_motion > 1.8, h_motion
    assert h_motion > h_static + 0.25, (h_motion, h_static)


def test_svgf_reduces_noise(setup):
    scene, cam = setup
    ca = cam.arrays("cpu")
    ref = render_image(scene, cam, spp=32, max_depth=3, frame=3).numpy()
    den = svgf.SVGFDenoiser(W, H, device="cpu")
    out = None
    for f in range(6):
        img, aovs = render_sample_with_aovs(scene, ca, W, H, f, 0, 1, 3, 2)
        out = den.step(img, aovs, cam).numpy()
    raw = render_sample_with_aovs(scene, ca, W, H, 5, 0, 1, 3, 2)[0].numpy()
    err_raw = np.median(np.abs(raw - ref))
    err_den = np.median(np.abs(out - ref))
    assert np.isfinite(out).all()
    assert err_den < err_raw * 0.75, (err_den, err_raw)
    patch = np.s_[8:14, 12:20]
    assert out[patch].mean(-1).std() < raw[patch].mean(-1).std() * 0.45


def test_svgf_history_accumulates(setup):
    scene, cam = setup
    ca = cam.arrays("cpu")
    den = svgf.SVGFDenoiser(W, H, device="cpu")
    for f in range(3):
        img, aovs = render_sample_with_aovs(scene, ca, W, H, f, 0, 1, 2, 1)
        den.step(img, aovs, cam)
    assert den.state["history"].numpy().max() == 3


def test_ao_renderer(setup):
    scene, cam = setup
    img = render_ao(scene, cam, spp=2, num_rays=8, ao_radius=2.5).numpy()
    assert img.shape == (W, H, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all() and (img <= 1).all()
    assert img.min() < 0.7
    assert img.mean() > 0.2


def test_render_ao_matches_reference(setup):
    scene, cam = setup
    js, _ = jax_cornell_box(W, H)
    ref = np.asarray(jax_render_ao(js, jcam.PinholeCamera(**dataclasses.asdict(cam)), spp=2,
                                   num_rays=8, ao_radius=2.5))
    got = render_ao(scene, cam, spp=2, num_rays=8, ao_radius=2.5).numpy()
    assert (got == ref).all(-1).mean() >= FRAC


def test_render_ao_kernel_matches_oracle_walk():
    """K1's plain version (the kernel's route on a CPU tensor) against
    the oracle walk, on the 2,004-prim knot."""
    scene, cam = procedural_mesh_scene(16, 16, n_u=40, n_v=25, device="cpu")
    kw = {"spp": 2, "num_rays": 4, "ao_radius": 1.0}
    got = render_ao(scene, cam, impl="cuda", **kw).numpy()
    ref = render_ao(scene, cam, impl="plain", **kw).numpy()
    assert (got == ref).all(-1).mean() >= FRAC
    assert 0.0 < got.mean() < 1.0
