"""NPR (`aten_tpu_torch/integrator/npr.py`) against aten_tpu.

* On AOVs taken from the reference (its `_npr_frame` run op by op, so
  the walk is not under test) of the 48x48 Cornell box and the 24x24
  material zoo: `feature_lines` bitwise; `toon_shade` within rtol 1e-5
  (atol 1e-6) on >= 99.5% of pixels: its band (ceil(ndl * bands)) and
  highlight (spec > 0.5 after pow) thresholds turn an ulp of torch's
  pow or normalize into a step of 1/bands or highlight_gain.
* `render_npr` on both and `feature_lines_sample_rays` on
  tests/test_feature_lines.py's sphere-before-plane scene agree with the
  reference run op by op on >= 0.995 of pixels (every channel within
  1e-4 abs + 1e-4 rel; line masks equal).  Measured: every pixel.
* On the 2,004-prim knot the walks through K1's plain version and the
  oracle walk give the same images, with 2 closest-hit and 3 any-hit
  calls of the K1 wrapper for `render_npr` (the G-buffer pass's two
  bounces and their NEE rays, the key light's shadow ray) and 9
  closest-hit ones for `feature_lines_sample_rays` with 8 samples.
* tests/test_npr.py's and tests/test_feature_lines.py's checks, on the
  port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator import npr as jnpr
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator import npr
from aten_tpu_torch.ops import traverse_cuda
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

torch.set_num_threads(1)

POPULATE = {
    "cornell": lambda b: tdefs.populate_cornell_box(b, 48, 48),
    "zoo": lambda b: tdefs.populate_material_test_scene(b, 24, 24),
}
AGREE = 0.995


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_cam(cam):
    return JaxPinholeCamera(**{f: getattr(cam, f) for f in cam.__dataclass_fields__})


def _scenes(populate):
    jb = JaxSceneBuilder()
    cam = populate(jb)
    js = jb.build()
    return js, bridge.from_numpy(_np(js.arrays), js.static, "cpu"), cam


def populate_sphere_before_plane(b):
    """tests/test_feature_lines.py's scene: a sphere floating before a
    plane, one diffuse colour."""
    m1 = b.add_material(MaterialType.DIFFUSE, base_color=(0.8, 0.2, 0.2))
    m2 = b.add_material(MaterialType.DIFFUSE, base_color=(0.8, 0.2, 0.2))
    b.add_quad((-10, -10, -3), (10, -10, -3), (10, 10, -3), (-10, 10, -3), m2)
    b.add_sphere((0, 0, 0), 1.0, m1)
    return PinholeCamera(origin=(0, 0, 6), lookat=(0, 0, 0), vfov_deg=30, width=64, height=64)


LINE_KW = {"num_samples": 8, "disc_radius_px": 1.5}


@pytest.fixture(scope="module")
def references():
    """The reference's NPR frame (image and G-buffer) of each scene and its
    sample-ray lines of the sphere-before-plane scene, op by op."""
    out = {}
    with jax.disable_jit():
        for name, populate in POPULATE.items():
            js, ts, cam = _scenes(populate)
            img, aovs = jnpr._npr_frame(js, _jax_cam(cam).arrays(), cam.width, cam.height,
                                        jnp.uint32(0), jnp.asarray(cam.origin, jnp.float32),
                                        jnpr.ToonParams())
            out[name] = (js, ts, cam, np.asarray(img), aovs)
        js, ts, cam = _scenes(populate_sphere_before_plane)
        lines = jnpr.feature_lines_sample_rays(js, _jax_cam(cam).arrays(), 64, 64, jnp.uint32(0),
                                               jnpr.ToonParams(), **LINE_KW)
        out["lines"] = (ts, cam, np.asarray(lines))
    return out


def _torch_aovs(aovs):
    return {k: torch.tensor(np.asarray(v)) for k, v in aovs.items()}


def _agree(got, want, rtol=1e-4, atol=1e-4):
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    return float(ok.reshape(ok.shape[0], ok.shape[1], -1).all(-1).mean())


@pytest.mark.parametrize("name", list(POPULATE))
def test_feature_lines_bitwise_on_reference_aovs(references, name):
    aovs = references[name][4]
    got = npr.feature_lines(_torch_aovs(aovs), npr.ToonParams()).numpy()
    want = np.asarray(jnpr.feature_lines(aovs, jnpr.ToonParams()))
    assert 0.01 < want.mean() < 0.6
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(POPULATE))
def test_toon_shade_on_reference_aovs(references, name):
    js, ts, cam, _, aovs = references[name]
    origin = np.asarray(cam.origin, np.float32)
    got = npr.toon_shade(ts, _torch_aovs(aovs), torch.tensor(origin), npr.ToonParams()).numpy()
    with jax.disable_jit():
        want = np.asarray(jnpr.toon_shade(js, aovs, jnp.asarray(origin), jnpr.ToonParams()))
    frac = _agree(got, want, rtol=1e-5, atol=1e-6)
    assert frac >= 0.995, frac


@pytest.mark.parametrize("name", list(POPULATE))
def test_render_npr_matches_reference(references, name):
    _, ts, cam, want, _ = references[name]
    got = npr.render_npr(ts, cam).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    frac = _agree(got, want)
    assert frac >= AGREE, frac


def test_feature_lines_sample_rays_match_reference(references):
    ts, cam, want = references["lines"]
    got = npr.feature_lines_sample_rays(ts, cam.arrays("cpu"), 64, 64, 0, npr.ToonParams(),
                                        **LINE_KW).numpy()
    assert 0.02 < want.mean() < 0.3
    frac = float((got == want).mean())
    assert frac >= AGREE, frac


def test_knot_through_k1_plain_version_and_its_calls(reference_native, monkeypatch):  # noqa: F811
    """K1's plain version (impl "auto" on CPU tensors) and the oracle walk
    give the same images; the K1 wrapper's calls are counted."""
    scene, cam = tdefs.procedural_mesh_scene(32, 32, n_u=40, n_v=25, device="cpu")
    calls = {"closest": 0, "any": 0}
    real = traverse_cuda.bvh_traverse

    def counted(*a, any_hit=False, **kw):
        calls["any" if any_hit else "closest"] += 1
        return real(*a, any_hit=any_hit, **kw)

    monkeypatch.setattr(traverse_cuda, "bvh_traverse", counted)
    img = npr.render_npr(scene, cam).numpy()
    assert calls == {"closest": 2, "any": 3}, calls
    lines = npr.feature_lines_sample_rays(scene, cam.arrays("cpu"), 32, 32, 0).numpy()
    assert calls == {"closest": 11, "any": 3}, calls
    np.testing.assert_array_equal(npr.render_npr(scene, cam, impl="plain").numpy(), img)
    np.testing.assert_array_equal(
        npr.feature_lines_sample_rays(scene, cam.arrays("cpu"), 32, 32, 0, impl="plain").numpy(),
        lines)
    assert calls == {"closest": 11, "any": 3}, calls
    assert 0.0 < lines.mean() < 0.5 and np.isfinite(img).all()


def test_npr_renders():
    scene, cam = tdefs.material_test_scene(32, 32, device="cpu")
    img = npr.render_npr(scene, cam).numpy()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()


def test_feature_lines_where_expected():
    from aten_tpu_torch.integrator.pathtracer import render_sample_with_aovs

    scene, cam = tdefs.cornell_box(48, 48, device="cpu")
    _, aovs = render_sample_with_aovs(scene, cam.arrays("cpu"), 48, 48, 0, 0, 1, 2, 1)
    lines = npr.feature_lines(aovs, npr.ToonParams()).numpy()
    assert 0.02 < lines.mean() < 0.6
    assert lines[16:24, 12:22].mean() < 0.1


def test_toon_ramp_quantizes():
    scene, cam = tdefs.cornell_box(48, 48, device="cpu")
    img = npr.render_npr(scene, cam).numpy()
    assert len(np.unique(np.round(img[24:34, 6:12, 0], 2))) <= 12


def test_silhouette_and_interior():
    b = SceneBuilder()
    cam = populate_sphere_before_plane(b)
    sc = b.build("cpu")
    W = H = 64
    lines = npr.feature_lines_sample_rays(sc, cam.arrays("cpu"), W, H, 0, npr.ToonParams(),
                                          **LINE_KW).numpy()
    assert lines.shape == (H, W)
    yy, xx = np.mgrid[0:H, 0:W]
    r = np.hypot(yy - H / 2 + 0.5, xx - W / 2 + 0.5)
    assert lines[(r > 16) & (r < 26)].mean() > 0.1
    assert lines[r < 8].mean() < 0.05
    assert lines[(xx < 6) & (yy < 6)].mean() < 0.05
