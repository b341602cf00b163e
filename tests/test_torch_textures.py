"""aten_tpu_torch's textures against aten_tpu.scene.textures.

* The texture stack, its sizes and its mip chain are bitwise equal to the
  reference's, for textures of different, non-square sizes.
* `sample_texture`, `sample_texture_lod`, `footprint_lod` and the three
  shade-time applications (`apply_albedo`, `apply_normal_map`,
  `apply_roughness_map`) agree within rtol 1e-5 / atol 1e-6, on uvs that
  wrap and go negative (floor modulo), with texture id -1 lanes.
* The counterparts of test_mipmap.py.
* The port's texture fixture (scenedefs.textured_scene: a GGX floor with
  seeded albedo, normal and roughness maps, a GGX sphere and an area
  light) at 32x32, 4 spp, depth 4 against aten_tpu's `render_image`, with
  the full-image radiance bounds (fraction of values with rel > 2e-2
  under 5e-3, mean rel under 3e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.scene import textures as jtex
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene import textures as ttex
from aten_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)

N = 8192
RTOL, ATOL = 1e-5, 1e-6


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((20, 12, 3)).astype(np.float32),
            rng.random((7, 16, 4)).astype(np.float32),
            rng.random((16, 16)).astype(np.float32)]


def _tables(images, mipmap=True):
    jt, tt = jtex.TextureTable(), ttex.TextureTable()
    for img in images:
        assert jt.add(img) == tt.add(img)
    ref = {k: np.asarray(v) for k, v in jt.arrays(mipmap=mipmap).items()}
    got = tt.numpy_arrays(mipmap=mipmap)
    return ref, got


def _as_tensors(tables):
    return {k: torch.tensor(v) for k, v in tables.items()}


def _lanes(rng, n, n_tex):
    tid = rng.integers(-1, n_tex, n).astype(np.int32)
    u = rng.uniform(-2.5, 3.5, n).astype(np.float32)
    v = rng.uniform(-2.5, 3.5, n).astype(np.float32)
    return tid, u, v


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("mipmap", [True, False])
def test_texture_tables_bitwise(mipmap):
    ref, got = _tables(_images(), mipmap)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the 20x16 stack: 10x8, 5x4, 2x2, 1x1
    assert ttex.num_mip_levels(got) == jtex.num_mip_levels(ref) == (5 if mipmap else 1)


def test_sample_texture_matches_reference():
    ref, got = _tables(_images(1))
    rng = np.random.default_rng(40)
    tid, u, v = _lanes(rng, N, 3)
    for default in (1.0, 0.5):
        r = jtex.sample_texture(ref, *map(jnp.asarray, (tid, u, v)), default=default)
        g = ttex.sample_texture(_as_tensors(got), *map(torch.tensor, (tid, u, v)), default=default)
        _close(g, r, f"rgba, default {default}")
        assert (g.numpy()[tid < 0] == default).all()


def test_sample_texture_lod_and_footprint_match_reference():
    ref, got = _tables(_images(2))
    rng = np.random.default_rng(41)
    tid, u, v = _lanes(rng, N, 3)
    lod = rng.uniform(-0.5, 5.0, N).astype(np.float32)
    r = jtex.sample_texture_lod(ref, *map(jnp.asarray, (tid, u, v, lod)))
    g = ttex.sample_texture_lod(_as_tensors(got), *map(torch.tensor, (tid, u, v, lod)))
    _close(g, r, "trilinear rgba")
    t = rng.uniform(0.01, 50.0, N).astype(np.float32)
    r = jtex.footprint_lod(ref, jnp.asarray(tid), jnp.asarray(t), pixel_spread=0.01)
    g = ttex.footprint_lod(_as_tensors(got), torch.tensor(tid), torch.tensor(t), pixel_spread=0.01)
    _close(g, r, "lod")
    # without mips the LOD fetch is the level-0 fetch
    ref0, got0 = _tables(_images(2), mipmap=False)
    g0 = ttex.sample_texture_lod(_as_tensors(got0), *map(torch.tensor, (tid, u, v, lod)))
    _close(g0, ttex.sample_texture(_as_tensors(got0), *map(torch.tensor, (tid, u, v))), "lod0")


def _mat_lanes(rng, n, n_tex):
    maps = {k: rng.integers(-1, n_tex, n).astype(np.int32)
            for k in ("albedo_map", "normal_map", "roughness_map")}
    return {"base_color": rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32),
            "roughness": rng.uniform(0.1, 0.9, n).astype(np.float32), **maps}


@pytest.mark.parametrize("which", ["albedo", "normal", "roughness"])
def test_apply_maps_match_reference(which):
    ref, got = _tables(_images(3))
    rng = np.random.default_rng(42)
    mat = _mat_lanes(rng, N, 3)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    d = rng.standard_normal((N, 3))
    ns = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    flags = {"has_albedo_maps": True, "has_normal_maps": True, "has_roughness_maps": True}
    sj, st = {**ref, **flags}, {**_as_tensors(got), **flags}
    mj = {k: jnp.asarray(v) for k, v in mat.items()}
    mt = {k: torch.tensor(v) for k, v in mat.items()}
    if which == "normal":
        r = jtex.apply_normal_map(sj, mj, jnp.asarray(ns), jnp.asarray(uv))
        g = ttex.apply_normal_map(st, mt, torch.tensor(ns), torch.tensor(uv))
        _close(g, r, "ns")
        off = mat["normal_map"] < 0
        np.testing.assert_array_equal(g.numpy()[off], ns[off])
        return
    fn = {"albedo": "apply_albedo", "roughness": "apply_roughness_map"}[which]
    r = getattr(jtex, fn)(sj, mj, jnp.asarray(uv))
    g = getattr(ttex, fn)(st, mt, torch.tensor(uv))
    assert set(g) == set(r)
    for k in g:
        _close(g[k], r[k], k)
    # a scene without such maps leaves the material as it was
    assert getattr(ttex, fn)({**st, f"has_{which}_maps": False}, mt, torch.tensor(uv)) is mt


# --- counterparts of test_mipmap.py ---------------------------------------------


def _checker(n=32):
    y, x = np.mgrid[0:n, 0:n]
    c = ((x + y) % 2).astype(np.float32)
    return np.stack([c, c, c], -1)


def test_mip_chain_shapes_and_means():
    tt = ttex.TextureTable()
    tt.add(_checker(32))
    tex = tt.numpy_arrays()
    L = ttex.num_mip_levels(tex)
    assert L == 6  # 32 -> 16 -> 8 -> 4 -> 2 -> 1
    for lv in range(1, L):
        np.testing.assert_allclose(tex[f"tex_mip{lv}"][..., :3].mean(), 0.5, atol=1e-6)
    assert tex["tex_mip5"].shape == (1, 1, 1, 4)


def test_lod_sampling_converges_to_average():
    tt = ttex.TextureTable()
    x = np.mgrid[0:32, 0:32][1]
    stripes = ((x // 8) % 2).astype(np.float32)
    tt.add(np.stack([stripes] * 3, -1))
    tex = _as_tensors(tt.numpy_arrays())
    tid = torch.zeros(16, dtype=torch.int32)
    u = torch.linspace(0.05, 0.95, 16)
    v = torch.full((16,), 1.0 - 16.5 / 32)
    c0 = ttex.sample_texture_lod(tex, tid, u, v, torch.zeros(16))
    np.testing.assert_allclose(c0.numpy(), ttex.sample_texture(tex, tid, u, v).numpy(), atol=1e-6)
    cmax = ttex.sample_texture_lod(tex, tid, u, v, torch.full((16,), 5.0))
    np.testing.assert_allclose(cmax.numpy()[..., :3], 0.5, atol=1e-6)
    var = [ttex.sample_texture_lod(tex, tid, u, v, torch.full((16,), lod))[..., 0].var()
           for lod in (0.0, 2.0, 4.0)]
    assert var[0] > var[1] > var[2]


def test_footprint_lod_monotone():
    tt = ttex.TextureTable()
    tt.add(_checker(64))
    tex = _as_tensors(tt.numpy_arrays())
    lod = ttex.footprint_lod(tex, torch.zeros(3, dtype=torch.int32),
                             torch.tensor([0.1, 1.0, 10.0]), pixel_spread=0.1).numpy()
    assert lod[0] < lod[1] < lod[2] and lod[0] >= 0.0


# --- the textured scene -------------------------------------------------------------


@pytest.fixture(scope="module")
def textured():
    """The texture fixture built by aten_tpu, rendered by it at 32x32,
    4 spp, depth 4, and bridged into the port."""
    b = JaxSceneBuilder()
    cam = tdefs.populate_textured_scene(b, 32, 32)
    js = b.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    ref = np.asarray(jax_render_image(
        js, JaxPinholeCamera(**dataclasses.asdict(cam)), spp=4, max_depth=4))
    return ts, cam, ref


def test_textured_scene_render_matches_reference(textured):
    ts, cam, ref = textured
    assert ts["has_albedo_maps"] and ts["has_normal_maps"] and ts["has_roughness_maps"]
    assert ttex.num_mip_levels(ts) == 5
    img = render_image(ts, cam, spp=4, max_depth=4).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.02
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3, (rel > 2e-2).mean()
    assert rel.mean() < 3e-3, rel.mean()
    own, _ = tdefs.textured_scene(32, 32, device="cpu")
    np.testing.assert_array_equal(render_image(own, cam, spp=4, max_depth=4).numpy(), img)


def test_texture_maps_change_the_render(textured):
    """Each map reaches the image: the same scene with one map dropped
    renders differently."""
    ts, cam, _ = textured
    img = render_image(ts, cam, spp=1, max_depth=3).numpy()
    for key in ("albedo_map", "normal_map", "roughness_map"):
        b = SceneBuilder()
        tdefs.populate_textured_scene(b, 32, 32)
        b.materials.rows[0][key] = -1
        other = render_image(b.build("cpu"), cam, spp=1, max_depth=3).numpy()
        assert np.abs(other - img).max() > 1e-2, key
