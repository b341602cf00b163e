"""aten_tpu_torch's image-based lighting against aten_tpu.scene.envmap.

* `build_env_tables` is bitwise equal to the reference's on the bench's
  procedural sky (scenedefs.sky_envmap) and on a seeded random map:
  envmap, env_weight, env_cdf_v, env_cdf_u, env_alias, env_payload and
  env_avg_illum.
* `eval_env`, `pdf_env`, `sample_ibl`, `env_miss_weight` and
  `nee_contribution` on a scene with an IBL row among five other lights
  agree with the reference within rtol 1e-5 / atol 1e-6 on at least 99.5%
  of lanes: the equirect mapping's atan2 and arccos differ by an ulp
  between XLA and torch on ~15% of inputs, which can move a texel floor
  (or, in sample_ibl, the alias cut compare) on a few lanes.
* The material zoo under the sky envmap at 48x24, 4 spp, depth 4 against
  aten_tpu's `render_image`, with the full-image radiance bounds
  (fraction of values with rel > 2e-2 under 5e-3, mean rel under 3e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import sampler as jsmp
from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.scene import envmap as jenv
from aten_tpu.scene.materials import MaterialType as JMT
from aten_tpu.scene.materials import gather_material as jgather
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu.shading import nee as jnee
from aten_tpu_torch.core import sampler as tsmp
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import envmap as tenv
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.shading import nee as tnee
from test_torch_shading import ATOL, RTOL, _populate_light_scene, _unit

torch.set_num_threads(1)

N = 8192


def _random_map(seed=0, h=24, w=40):
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.5, 1.0, (h, w, 3)).astype(np.float32)
    img[rng.random((h, w)) < 0.2] = 0.0  # dark texels: zero-probability cells
    return img


def _mostly_close(got, ref, what, frac=0.995):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    ok = np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)
    lanes = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert lanes.mean() >= frac, (what, int((~lanes).sum()), lanes.size)
    return lanes


def _bridged(populate):
    b = JaxSceneBuilder()
    cam = populate(b)
    js = b.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    return js, ts, cam


@pytest.mark.parametrize("which", ["sky", "random"])
def test_env_tables_bitwise(which):
    img = tdefs.sky_envmap() if which == "sky" else _random_map()
    got = tenv.build_env_tables(img)
    ref = jenv.build_env_tables(img)
    assert set(got) == set(tenv.TABLE_KEYS) == set(ref) - {"env_quad"}
    for k in tenv.TABLE_KEYS:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def _env_scene(img):
    def populate(b):
        b.add_material(MaterialType.DIFFUSE)
        b.add_sphere((0.0, 0.0, 0.0), 1.0, 0)
        b.set_envmap(img)
    return _bridged(populate)[:2]


@pytest.mark.parametrize("which", ["sky", "random"])
def test_eval_and_pdf_env_match_reference(which):
    js, ts = _env_scene(tdefs.sky_envmap() if which == "sky" else _random_map(1))
    rng = np.random.default_rng(30)
    d = _unit(rng, N)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]]  # poles and the seam
    uj, vj = jenv.dir_to_uv(jnp.asarray(d))
    ut, vt = tenv.dir_to_uv(torch.tensor(d))
    _mostly_close(ut, uj, "u")
    _mostly_close(vt, vj, "v")
    _mostly_close(tenv.eval_env(ts, torch.tensor(d)), jenv.eval_env(js, jnp.asarray(d)), "le")
    _mostly_close(tenv.pdf_env(ts, torch.tensor(d)), jenv.pdf_env(js, jnp.asarray(d)), "pdf")
    uv = rng.random((2, N)).astype(np.float32)
    np.testing.assert_allclose(tenv.uv_to_dir(*map(torch.tensor, uv)).numpy(),
                               np.asarray(jenv.uv_to_dir(*map(jnp.asarray, uv))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["sky", "random"])
def test_sample_ibl_matches_reference(which):
    js, ts = _env_scene(tdefs.sky_envmap() if which == "sky" else _random_map(2))
    rng = np.random.default_rng(31)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    uv = rng.random((2, N)).astype(np.float32)
    ref = jenv.sample_ibl(js, jnp.asarray(p), tuple(map(jnp.asarray, uv)))
    got = tenv.sample_ibl(ts, torch.tensor(p), tuple(map(torch.tensor, uv)))
    assert set(got) == set(ref)
    for k in ("singular", "infinite", "area_measure"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["dist"].numpy(), np.asarray(ref["dist"]))
    for k in ("dir", "nml", "le", "pdf", "pos"):
        _mostly_close(got[k], ref[k], k)
    # the sampled texels follow the luminance x sin(theta) distribution:
    # the pdf of the sampled direction is the pdf_env of it
    _mostly_close(tenv.pdf_env(ts, got["dir"]), got["pdf"], "pdf_env at the sample", 0.99)


def test_env_miss_weight_matches_reference():
    js, ts = _env_scene(tdefs.sky_envmap())
    rng = np.random.default_rng(32)
    d = _unit(rng, N)
    pdf_prev = rng.uniform(0.0, 5.0, N).astype(np.float32)
    sing = rng.random(N) < 0.3
    ref = jnee.env_miss_weight(js, *map(jnp.asarray, (d, pdf_prev, sing)))
    got = tnee.env_miss_weight(ts, *map(torch.tensor, (d, pdf_prev, sing)))
    _mostly_close(got, ref, "w")
    assert (got.numpy()[sing] == 1.0).all() and (got.numpy()[~sing] < 1.0).any()


@pytest.mark.parametrize("occl_frac", [0.0, 0.4])
def test_nee_contribution_with_ibl_matches_reference(occl_frac):
    """NEE over an IBL row and the five lights of test_torch_shading's
    light scene; the IBL lanes' shadow rays run to 1e30."""
    def populate(b):
        _populate_light_scene(b, JMT)
        b.set_envmap(tdefs.sky_envmap())

    js, ts, _ = _bridged(populate)
    assert ts["num_lights"] == 6 and int(ts["lights"]["type"][5]) == 1
    rng = np.random.default_rng(33)
    p = rng.uniform([-4, 0, -4], [4, 3, 4], (N, 3)).astype(np.float32)
    ns, wo = _unit(rng, N), _unit(rng, N)
    mtl = rng.integers(0, 4, N).astype(np.int32)
    occ = rng.random(N) < occl_frac
    seeds = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    mat_j = jgather(js["materials"], jnp.asarray(mtl))
    mat_t = gather_material(ts["materials"], torch.tensor(mtl))
    st_j = jsmp.make_state(jnp.asarray(seeds), 3, 5, 16, bounce=2)
    st_t = tsmp.make_state(torch.tensor(seeds.astype(np.int64)), 3, 5, 16, bounce=2)
    calls = {}

    def occ_j(o, d, dist):
        calls["jax"] = (o, d, dist)
        return jnp.asarray(occ)

    def occ_t(o, d, dist):
        calls["torch"] = (o, d, dist)
        return torch.tensor(occ)

    cj, st_j = jnee.nee_contribution(js, mat_j, jnp.asarray(p), jnp.asarray(ns),
                                     jnp.asarray(wo), st_j, occ_j, used=js["used_mtl_types"])
    ct, st_t = tnee.nee_contribution(ts, mat_t, torch.tensor(p), torch.tensor(ns),
                                     torch.tensor(wo), st_t, occ_t, ts["used_mtl_types"])
    np.testing.assert_array_equal(st_t["dim"].numpy(), np.asarray(st_j["dim"]).astype(np.int64))
    for name, a, b in zip(("ro", "rd", "dist"), calls["torch"], calls["jax"]):
        _mostly_close(a, b, "shadow " + name)
    # the IBL and the directional light, two in six, run to 1e30
    far = calls["torch"][2].numpy() == np.float32(1e30)
    assert 0.25 < far.mean() < 0.42, far.mean()
    _mostly_close(ct, cj, "contribution")
    assert (ct.numpy()[far] > 0).any(axis=1).mean() > 0.1


@pytest.fixture(scope="module")
def zoo_ibl():
    """The zoo under the sky, built by aten_tpu, rendered by it at 48x24,
    4 spp, depth 4, and bridged into the port."""
    js, ts, cam = _bridged(lambda b: tdefs.populate_material_test_scene(
        b, 48, 24, envmap=tdefs.sky_envmap()))
    ref = np.asarray(jax_render_image(
        js, JaxPinholeCamera(**dataclasses.asdict(cam)), spp=4, max_depth=4))
    return ts, cam, ref


def test_zoo_ibl_render_matches_reference(zoo_ibl):
    ts, cam, ref = zoo_ibl
    assert "envmap" in ts and ts["num_lights"] == 1
    img = render_image(ts, cam, spp=4, max_depth=4).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.1
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3, (rel > 2e-2).mean()
    assert rel.mean() < 3e-3, rel.mean()
    # the port's own builder gives the identical scene, hence image
    own, _ = tdefs.material_test_scene(48, 24, envmap=tdefs.sky_envmap(), device="cpu")
    np.testing.assert_array_equal(render_image(own, cam, spp=4, max_depth=4).numpy(), img)
