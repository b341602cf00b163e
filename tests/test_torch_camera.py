"""aten_tpu_torch's thin-lens and equirect cameras against aten_tpu.

* Rays: `generate_ray_thinlens` and `generate_ray_equirect` (and the
  equirect dispatch of `generate_ray`) within rtol = atol = 1e-6 on
  seeded film and lens samples; the cameras' arrays equal.
* `CameraOperator`'s dolly, orbit and pan, and `camera_matrices`, within
  1e-6.
* Renders through each camera against the reference's `render_image` at
  32 pixels wide, 4 spp, depth 3, within the full-image radiance bounds
  (frac(rel > 2e-2) < 5e-3, mean rel < 3e-3), and `camera_type_of`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import camera as jcam
from aten_tpu.integrator.pathtracer import camera_type_of as jax_camera_type_of
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.scene import scenedefs as jdefs
from aten_tpu_torch.core import camera as tcam
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene import bridge

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

THIN = [
    dict(origin=(0.0, 0.0, 3.45), lookat=(0.0, 0.0, 0.0), vfov_deg=45.0, width=64, height=64,
         lens_radius=0.3, focus_dist=2.5),
    dict(origin=(2.0, -1.0, 5.0), lookat=(0.3, 0.2, -1.0), up=(0.1, 1.0, 0.0), vfov_deg=60.0,
         width=33, height=71, lens_radius=0.05, focus_dist=7.0),
]
EQUI = [
    dict(origin=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, 0.0), width=64, height=32),
    dict(origin=(1.0, 2.0, -3.0), lookat=(0.5, 1.0, 0.0), up=(0.0, 0.0, 1.0), width=96,
         height=40),
]


def _samples(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(n).astype(np.float32) for _ in range(k)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", THIN)
def test_thinlens_rays(kw):
    jc, tc = jcam.ThinLensCamera(**kw), tcam.ThinLensCamera(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    ja, ta = jc.arrays(), tc.arrays("cpu")
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ja[k]), ta[k].numpy(), err_msg=k)
    s, t, u1, u2 = _samples(5000, 4, 3)
    jro, jrd = jcam.generate_ray_thinlens(ja, *(jnp.asarray(x) for x in (s, t, u1, u2)))
    tro, trd = tcam.generate_ray_thinlens(ta, *(torch.tensor(x) for x in (s, t, u1, u2)))
    _close(tro, jro)
    _close(trd, jrd)


@pytest.mark.parametrize("kw", EQUI)
def test_equirect_rays(kw):
    jc, tc = jcam.EquirectCamera(**kw), tcam.EquirectCamera(**kw)
    ja, ta = jc.arrays(), tc.arrays("cpu")
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ja[k]), ta[k].numpy(), err_msg=k)
    s, t = _samples(5000, 2, 4)
    jro, jrd = jcam.generate_ray_equirect(ja, jnp.asarray(s), jnp.asarray(t))
    tro, trd = tcam.generate_ray_equirect(ta, torch.tensor(s), torch.tensor(t))
    _close(tro, jro)
    _close(trd, jrd)
    # generate_ray tells the equirect arrays apart, as the reference's does
    gro, grd = tcam.generate_ray(ta, torch.tensor(s), torch.tensor(t))
    assert torch.equal(gro, tro) and torch.equal(grd, trd)


@pytest.mark.parametrize("op,args", [
    ("dolly", (0.7,)), ("dolly", (-1.3,)), ("dolly", (99.0,)),
    ("orbit", (0.4, -0.2)), ("orbit", (-2.5, 1.4)), ("pan", (0.3, -0.6)),
])
def test_camera_operator(op, args):
    for kw in (THIN[0], {**THIN[1], "up": (0.0, 1.0, 0.0)},
               dict(origin=(0.0, 5.0, 0.1), lookat=(0.0, 0.0, 0.0))):
        kw = {k: v for k, v in kw.items() if k not in ("lens_radius", "focus_dist")}
        jc, tc = jcam.PinholeCamera(**kw), tcam.PinholeCamera(**kw)
        jn = getattr(jcam.CameraOperator, op)(jc, *args)
        tn = getattr(tcam.CameraOperator, op)(tc, *args)
        for f in ("origin", "lookat", "up"):
            np.testing.assert_allclose(np.asarray(getattr(tn, f), np.float64),
                                       np.asarray(getattr(jn, f), np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert type(tn) is tcam.PinholeCamera


@pytest.mark.parametrize("kw", THIN)
def test_camera_matrices(kw):
    kw = {k: v for k, v in kw.items() if k not in ("lens_radius", "focus_dist")}
    jw2v, jv2c = jcam.camera_matrices(jcam.PinholeCamera(**kw))
    tw2v, tv2c = tcam.camera_matrices(tcam.PinholeCamera(**kw), device="cpu")
    _close(tw2v, jw2v)
    _close(tv2c, jv2c)
    assert tw2v.dtype == torch.float32 and tw2v.shape == (4, 4)


def test_camera_type_of():
    for kw, jcls, tcls in ((THIN[0], jcam.ThinLensCamera, tcam.ThinLensCamera),
                           (EQUI[0], jcam.EquirectCamera, tcam.EquirectCamera)):
        assert tcam.camera_type_of(tcls(**kw)) == jax_camera_type_of(jcls(**kw))
    assert tcam.camera_type_of(tcam.PinholeCamera(origin=(0, 0, 1), lookat=(0, 0, 0))) \
        == "pinhole"


_CORNELL = {}


def _cornell():
    if not _CORNELL:
        js, cam = jdefs.cornell_box(32, 32)
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        _CORNELL["c"] = (js, ts, cam)
    return _CORNELL["c"]


def _image_bounds(img, ref):
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    return (rel > 2e-2).mean(), rel.mean()


@pytest.mark.parametrize("which", ["thinlens", "thinlens_pin", "equirect"])
def test_render_through_camera_matches_reference(which):
    js, ts, cam = _cornell()
    if which == "equirect":
        kw = EQUI[0] | {"width": 32, "height": 16}
        jc, tc = jcam.EquirectCamera(**kw), tcam.EquirectCamera(**kw)
    else:
        kw = dict(origin=cam.origin, lookat=cam.lookat, vfov_deg=cam.vfov_deg, width=32,
                  height=32, lens_radius=0.3 if which == "thinlens" else 1e-6,
                  focus_dist=2.5 if which == "thinlens" else 3.45)
        jc, tc = jcam.ThinLensCamera(**kw), tcam.ThinLensCamera(**kw)
    ref = np.asarray(jax_render_image(js, jc, spp=4, max_depth=3))
    img = render_image(ts, tc, spp=4, max_depth=3).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.05
    frac, mean_rel = _image_bounds(img, ref)
    assert frac < 5e-3, frac
    assert mean_rel < 3e-3, mean_rel
