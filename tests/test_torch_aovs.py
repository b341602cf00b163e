"""The first-hit AOV G-buffer (`render_sample_with_aovs`) against aten_tpu.

* On the Cornell box (the dense test), the 2,004-prim knot (the plain
  walk), the instanced fixture (the two-level walk: the `inst` AOV) and
  the stencil fixture (primary rays resolved through the stencil quad;
  a 534-prim knot), each 32x32, against the reference's `render_sample_with_aovs` run op
  by op (`jax.disable_jit()`, as tests/test_torch_bands.py runs it; the
  jitted reference contracts multiply-adds): the ids (prim, mtl, inst)
  exact; depth and albedo within rtol 1e-5 (atol 1e-6, for values near
  zero) at every pixel; normal and pos within the same on every
  single-level triangle hit.  Sphere hits and the instanced fixture's
  hits differ more: the walks agree on a hit's u, v only to ~1e-5
  (tests/test_torch_tlas.py's bound), which the interpolated normal
  carries, and a grazing sphere hit turns the walks' ulp differences in
  t (torch's CPU sqrt is not correctly rounded) into larger ones in p.
  There the normal holds within atol 5e-4 (measured 1.8e-4) and pos
  within 1e-5 of the ray's length |ro| + depth (measured 1.0e-4 at a
  depth of 25, the bound 5.3e-4).
* A band (y0, tile_h) is bitwise the same rows of the whole image, and
  the radiance is bitwise `render_sample`'s.
* With max_depth 0 (no ray traced) the AOVs are exactly the reference's
  initial G-buffer.
* utils/debug.py's AOV views read the port's AOVs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import render_sample_with_aovs as jax_render_aovs
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.pathtracer import render_sample, render_sample_with_aovs
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.utils.debug import aov_debug_image
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

torch.set_num_threads(1)

W = H = 32
POPULATE = {
    "cornell": lambda b: tdefs.populate_cornell_box(b, W, H),
    "knot2004": lambda b: tdefs.populate_procedural_mesh_scene(b, W, H, 40, 25),
    "instanced": lambda b: tdefs.populate_instanced_mesh_scene(b, W, H, 12, 6),
    # a 528-triangle knot behind the portal: the reference resolves every
    # lane through the stencil with five op-by-op walks (~50 s at this size)
    "stencil": lambda b: tdefs.populate_stencil_mesh_scene(b, W, H, 24, 11),
}
IDS = ("prim", "mtl", "inst")
FLOATS = ("depth", "normal", "albedo", "pos")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def scenes(reference_native):  # noqa: F811
    out = {}
    for name, populate in POPULATE.items():
        jb = JaxSceneBuilder()
        cam = populate(jb)
        js = jb.build()
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        out[name] = (js, ts, cam)
    return out


@pytest.mark.parametrize("name", list(POPULATE))
def test_aovs_match_reference(scenes, name):
    js, ts, cam = scenes[name]
    with jax.disable_jit():
        _, ref = jax_render_aovs(js, JaxPinholeCamera(**dataclasses.asdict(cam)).arrays(), W, H,
                                 jnp.uint32(0), jnp.uint32(0), 1, 1, 1)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    img, got = render_sample_with_aovs(ts, PinholeCamera(**dataclasses.asdict(cam)).arrays("cpu"),
                                       W, H, 0, 0, 1, 1, 1)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref) == set(IDS + FLOATS)
    assert img.shape == (H, W, 3)
    for k in IDS + FLOATS:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    for k in IDS:  # exact
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} {k}")
    for k in ("depth", "albedo"):  # rtol 1e-5, atol 1e-6, every pixel
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=f"{name} {k}")
    exact = got["prim"] < (js["num_tris"] if name != "instanced" else 0)  # misses too
    assert exact.mean() > (0.0 if name == "instanced" else 0.8)
    for k in ("normal", "pos"):  # rtol 1e-5, atol 1e-6 on single-level triangle hits
        np.testing.assert_allclose(got[k][exact], ref[k][exact], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["normal"], ref["normal"], rtol=0, atol=5e-4,
                               err_msg=f"{name} normal")
    ray_len = np.linalg.norm(cam.origin) + np.abs(ref["depth"])[..., None]
    assert (np.abs(got["pos"] - ref["pos"]) <= RTOL * ray_len).all(), f"{name} pos"
    hit = got["prim"] >= 0
    assert 0.2 < hit.mean() <= 1.0
    assert (got["depth"][~hit] == -1.0).all() and (got["mtl"][~hit] == -1).all()
    assert (got["depth"][hit] > 0).all()
    if name == "instanced":
        inst = got["inst"][hit]
        assert (inst >= 0).all() and len(np.unique(inst)) > 3
    else:
        assert (got["inst"] == -1).all()
    for mode in ("normal", "depth", "albedo", "prim_id", "mtl_id", "position"):
        v = aov_debug_image({k: torch.from_numpy(a) for k, a in got.items()}, mode)
        assert v.shape == (H, W, 3) and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("name", ["knot2004", "instanced"])
def test_aov_band_is_the_whole_images_rows(scenes, name):
    """A band's radiance and AOVs are bitwise the same rows of the whole
    image's, and the whole image's radiance is bitwise render_sample's."""
    _, ts, cam = scenes[name]
    ca = PinholeCamera(**dataclasses.asdict(cam)).arrays("cpu")
    img, aovs = render_sample_with_aovs(ts, ca, W, H, 2, 1, 4, 3, 2)
    assert torch.equal(img, render_sample(ts, ca, W, H, 2, 1, 4, 3, 2))
    y0, th = 9, 13
    band, baovs = render_sample_with_aovs(ts, ca, W, H, 2, 1, 4, 3, 2, y0=y0, tile_h=th)
    assert band.shape == (th, W, 3) and torch.equal(band, img[y0:y0 + th])
    for k, v in aovs.items():
        assert torch.equal(baovs[k], v[y0:y0 + th]), k


def test_aovs_without_a_bounce_are_the_references_initial_gbuffer(scenes):
    """max_depth 0 traces no ray: radiance zero and the AOVs of a miss
    (depth -1, ids -1, zero vectors), exactly the reference's."""
    js, ts, cam = scenes["cornell"]
    # jitted: no bounce runs, so nothing is contracted (and the op-by-op
    # mode refuses the reference's zero-length scan)
    jimg, ref = jax_render_aovs(js, JaxPinholeCamera(**dataclasses.asdict(cam)).arrays(),
                                W, H, jnp.uint32(2), jnp.uint32(1), 4, 0, 0)
    img, got = render_sample_with_aovs(ts, PinholeCamera(**dataclasses.asdict(cam)).arrays("cpu"),
                                       W, H, 2, 1, 4, 0, 0)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))  # exact
    assert set(got) == set(ref)
    for k, v in ref.items():  # exact, dtype and shape too
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert (got["depth"] == -1.0).all() and (got["prim"] == -1).all()
