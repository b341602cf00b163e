"""aten_tpu_torch.core (sampler, camera) against aten_tpu.core.

The sampler is integer arithmetic and must agree bit for bit; pinhole
rays agree to rtol = atol = 1e-6.  Inputs come from numpy seeds and go
through both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import camera as jcam
from aten_tpu.core import sampler as jsmp
from aten_tpu_torch.core import camera as tcam
from aten_tpu_torch.core import sampler as tsmp

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.uint32), b.astype(np.float32).view(np.uint32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def test_wang_hash_bitwise():
    x = _u32(np.random.default_rng(0), 20000)
    _bits_equal(jsmp.wang_hash(jnp.asarray(x)), tsmp.wang_hash(_t(x)))


@pytest.mark.parametrize("fn", ["cmj_1d", "cmj_2d"])
def test_cmj_bitwise(fn):
    rng = np.random.default_rng(1)
    s = _u32(rng, 20000)
    p = _u32(rng, 20000)
    ref = getattr(jsmp, fn)(jnp.asarray(s), jnp.asarray(p))
    got = getattr(tsmp, fn)(_t(s), _t(p))
    if fn == "cmj_1d":
        ref, got = (ref,), (got,)
    for a, b in zip(ref, got):
        _bits_equal(a, b)


@pytest.mark.parametrize("frame,spp,bounce", [
    (0, 1, 0), (0, 16, 1), (3, 16, 4), (1000, 100, 2), (70000, 64, 9),
])
def test_sampler_state_and_draws_bitwise(frame, spp, bounce):
    """make_state + a sequence of next_1d / next_2d draws over a
    (pixel, sample) grid, for several (frame, spp, bounce)."""
    pix = np.arange(64 * 64, dtype=np.uint32)
    samples = np.array([0, 1, 3, 15, 255, 256, 1023], np.uint32)
    pp, ss = np.meshgrid(pix, samples, indexing="ij")
    pp, ss = pp.ravel(), ss.ravel()
    jseed = jsmp.wang_hash(jnp.asarray(pp + np.uint32(1)))
    tseed = tsmp.wang_hash(_t(pp) + 1)
    _bits_equal(jseed, tseed)
    js = jsmp.make_state(jseed, frame, jnp.asarray(ss), spp, bounce=bounce)
    ts = tsmp.make_state(tseed, frame, _t(ss), spp, bounce=bounce)
    for k in ("idx", "dim", "scramble"):
        _bits_equal(js[k], ts[k])
    for kind in ("2d", "1d", "1d", "2d", "1d", "2d"):
        if kind == "1d":
            a, js = jsmp.next_1d(js)
            b, ts = tsmp.next_1d(ts)
            _bits_equal(a, b)
        else:
            a0, a1, js = jsmp.next_2d(js)
            b0, b1, ts = tsmp.next_2d(ts)
            _bits_equal(a0, b0)
            _bits_equal(a1, b1)
        _bits_equal(js["dim"], ts["dim"])


@pytest.mark.parametrize("cam_kw", [
    dict(origin=(0.0, 0.0, 3.45), lookat=(0.0, 0.0, 0.0), vfov_deg=45.0, width=64, height=64),
    dict(origin=(0.0, 4.0, 14.0), lookat=(0.0, 1.5, 0.0), vfov_deg=40.0, width=96, height=48),
    dict(origin=(2.0, -1.0, 5.0), lookat=(0.3, 0.2, -1.0), up=(0.1, 1.0, 0.0),
         vfov_deg=60.0, width=33, height=71),
])
def test_pinhole_rays(cam_kw):
    rng = np.random.default_rng(2)
    s = rng.random(5000).astype(np.float32)
    t = rng.random(5000).astype(np.float32)
    jc = jcam.PinholeCamera(**cam_kw)
    tc = tcam.PinholeCamera(**cam_kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    ca_j = jc.arrays()
    ca_t = tc.arrays("cpu")
    for k in ca_j:
        np.testing.assert_array_equal(np.asarray(ca_j[k]), ca_t[k].numpy())
    ro_j, rd_j = jcam.generate_ray(ca_j, jnp.asarray(s), jnp.asarray(t))
    ro_t, rd_t = tcam.generate_ray(ca_t, torch.from_numpy(s), torch.from_numpy(t))
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-6, atol=1e-6)


def test_unported_cameras_raise():
    """Thin-lens and equirect cameras, once refused, route through the
    integrator (the port's counterpart of
    tests/test_camera.py::test_camera_dispatch_in_render_path): a big
    lens blurs the Cornell box, a pin-sized one converges to the pinhole
    render's mean, and the equirect render from inside the box sees
    geometry in every column.  A camera type the integrator does not
    know raises."""
    from aten_tpu_torch.integrator.pathtracer import render_image, render_sample
    from aten_tpu_torch.scene.scenedefs import cornell_box

    scene, cam = cornell_box(48, 48, device="cpu")
    img_pin = render_image(scene, cam, spp=8, max_depth=2).numpy()
    dist = float(np.linalg.norm(np.subtract(cam.lookat, cam.origin)))
    base = dict(origin=cam.origin, lookat=cam.lookat, vfov_deg=cam.vfov_deg, width=48, height=48)
    tl = tcam.ThinLensCamera(**base, lens_radius=0.8, focus_dist=dist * 0.4)
    img_tl = render_image(scene, tl, spp=8, max_depth=2).numpy()
    assert np.isfinite(img_tl).all() and np.abs(img_tl - img_pin).mean() > 0.05
    tl0 = tcam.ThinLensCamera(**base, lens_radius=1e-6, focus_dist=dist)
    img_tl0 = render_image(scene, tl0, spp=8, max_depth=2).numpy()
    np.testing.assert_allclose(img_tl0.mean(), img_pin.mean(), rtol=0.1)
    eq = tcam.EquirectCamera(origin=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, 0.0), width=64, height=32)
    img_eq = render_image(scene, eq, spp=4, max_depth=2).numpy()
    assert np.isfinite(img_eq).all() and (img_eq.max(axis=(0, 2)) > 0).all()
    assert tcam.camera_type_of(tl) == "thinlens" and tcam.camera_type_of(eq) == "equirect"
    with pytest.raises(ValueError, match="camera type"):
        render_sample(scene, cam.arrays("cpu"), 48, 48, 0, 0, cam_type="fisheye")
