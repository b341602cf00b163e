"""aten_tpu_torch shading (BSDFs, NEE) against aten_tpu.shading.

The four ported families (DIFFUSE, SPECULAR, REFRACTION, GGX, plus
EMISSIVE) are sampled and evaluated on the same seeded inputs by both
packages, and `nee_contribution` runs with the same occlusion mask on a
scene holding every ported light kind.  Tolerance rtol 1e-5, atol 1e-6.

One exception: a GGX direction sampled near the lobe peak has a pdf and
bsdf whose denominator cancels (1 - nh^2 (1 - alpha^2)), so 1-ulp
differences between XLA's and torch's sin/cos/sqrt grow to relative
errors of up to ~1.5e-3 there.  For sample_brdf at least 99.5% of lanes
meet rtol 1e-5 / atol 1e-6, and every lane rtol 5e-3 / atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import sampler as jsmp
from aten_tpu.scene.materials import MaterialType as JMT
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu.shading import brdf as jbrdf
from aten_tpu.shading import nee as jnee
from aten_tpu_torch.core import sampler as tsmp
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.scene.scene import SceneBuilder
from aten_tpu_torch.shading import brdf as tbrdf
from aten_tpu_torch.shading import nee as tnee

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

N = 4096
USED = tuple(sorted(int(t) for t in (
    MaterialType.EMISSIVE, MaterialType.DIFFUSE, MaterialType.SPECULAR,
    MaterialType.REFRACTION, MaterialType.GGX)))
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _materials(rng, n, mtype=None):
    types = np.array(USED, np.int32)
    t = (rng.choice(types, n) if mtype is None
         else np.full(n, int(mtype), np.int32)).astype(np.int32)
    return {
        "type": t,
        "base_color": rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32),
        "roughness": rng.uniform(0.05, 0.9, n).astype(np.float32),
        "ior": rng.uniform(1.2, 2.6, n).astype(np.float32),
    }


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.tensor(v) for k, v in d.items()})


def _close(got, ref, what):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=what)


def _close_but_peaks(got, ref, what):
    """RTOL/ATOL on >= 99.5% of lanes; every lane within the bound that
    peaked GGX lobes allow (see the module docstring)."""
    got = got.numpy()
    ref = np.asarray(ref)
    ok = np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)
    lanes = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert lanes.mean() >= 0.995, (what, int((~lanes).sum()))
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("mtype", [None, "DIFFUSE", "SPECULAR", "REFRACTION", "GGX"])
def test_sample_brdf_matches_reference(mtype):
    rng = np.random.default_rng(10)
    mat_j, mat_t = _both(_materials(rng, N, None if mtype is None else MaterialType[mtype]))
    ns, wo = _unit(rng, N), _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    ref = jbrdf.sample_brdf(mat_j, jnp.asarray(ns), jnp.asarray(wo),
                            *map(jnp.asarray, u), used=USED)
    got = tbrdf.sample_brdf(mat_t, torch.tensor(ns), torch.tensor(wo),
                            *map(torch.tensor, u), USED)
    for k in ("singular", "transmission"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("wi", "pdf", "bsdf"):
        _close_but_peaks(got[k], ref[k], k)


@pytest.mark.parametrize("mtype", [None, "DIFFUSE", "GGX"])
def test_eval_bsdf_pdf_matches_reference(mtype):
    rng = np.random.default_rng(11)
    mat_j, mat_t = _both(_materials(rng, N, None if mtype is None else MaterialType[mtype]))
    ns, wo, wi = _unit(rng, N), _unit(rng, N), _unit(rng, N)
    fj, pj = jbrdf.eval_bsdf_pdf(mat_j, *map(jnp.asarray, (ns, wo, wi)), used=USED)
    ft, pt = tbrdf.eval_bsdf_pdf(mat_t, *map(torch.tensor, (ns, wo, wi)), USED)
    _close(ft, fj, "f")
    _close(pt, pj, "pdf")
    # GGX lanes carry a real lobe: most of them must be nonzero
    if mtype == "GGX":
        assert (pt.numpy() > 0).mean() > 0.2


def test_unported_families_raise():
    rng = np.random.default_rng(12)
    _, mat_t = _both(_materials(rng, 8))
    ns, wo = torch.tensor(_unit(rng, 8)), torch.tensor(_unit(rng, 8))
    u = torch.rand(8)
    # a type id that is no MaterialType (every family is ported, so an
    # unknown id is the one left to refuse)
    unknown = max(int(t) for t in MaterialType) + 1
    with pytest.raises(NotImplementedError):
        tbrdf.sample_brdf(mat_t, ns, wo, u, u, u, USED + (unknown,))
    # no used-type set is the reference's default: every family, the same
    # result as naming them all (on rows with every field the zoo reads)
    from test_torch_materials import _materials as zoo_materials

    _, mat_t = _both(zoo_materials(rng, 8))
    every = tuple(int(t) for t in MaterialType)
    got, want = tbrdf.sample_brdf(mat_t, ns, wo, u, u, u), tbrdf.sample_brdf(
        mat_t, ns, wo, u, u, u, every)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _populate_light_scene(b, mt):
    """Floor, two spheres and one light of every ported kind."""
    diffuse = b.add_material(mt.DIFFUSE, base_color=(0.7, 0.6, 0.5))
    ggx = b.add_material(mt.GGX, base_color=(0.9, 0.7, 0.3), roughness=0.3, ior=2.0)
    mirror = b.add_material(mt.SPECULAR, base_color=(0.95, 0.95, 0.95))
    glass = b.add_material(mt.REFRACTION, base_color=(0.98, 0.98, 0.98), ior=1.5)
    emit = b.add_material(mt.EMISSIVE, base_color=(20.0, 18.0, 15.0))
    b.add_quad([-5, 0, 5], [5, 0, 5], [5, 0, -5], [-5, 0, -5], diffuse)
    b.add_sphere((1.0, 1.0, 0.0), 0.8, ggx)
    b.add_sphere((-1.5, 0.7, 0.5), 0.6, glass)
    b.add_sphere((0.0, 2.0, -2.0), 0.5, mirror)
    ls, lc = b.add_quad([-1, 6, 1], [-1, 6, -1], [1, 6, -1], [1, 6, 1], emit)
    b.add_area_light_tris(ls, lc, le=(20.0, 18.0, 15.0))
    sid = b.add_sphere((2.5, 4.0, 2.0), 0.3, emit)
    b.add_area_light_sphere(sid, le=(30.0, 30.0, 30.0))
    b.add_point_light((-3.0, 3.0, 2.0), le=(15.0, 12.0, 10.0))
    b.add_spot_light((0.0, 5.0, 3.0), (0.0, -1.0, -0.5), le=(40.0, 40.0, 40.0),
                     inner_angle=0.4, outer_angle=0.7)
    b.add_directional_light((-0.3, -1.0, 0.2), le=(2.0, 2.0, 1.8))


def test_light_scene_builds_identically():
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    _populate_light_scene(jb, JMT)
    _populate_light_scene(tb, MaterialType)
    js = jb.build()
    ts = tb.build("cpu")
    assert ts["num_lights"] == 5
    via = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    for k in ("lights", "materials"):
        for f, v in ts[k].items():
            np.testing.assert_array_equal(v.numpy(), via[k][f].numpy(), err_msg=f"{k}.{f}")


@pytest.mark.parametrize("occl_frac", [0.0, 0.4])
def test_nee_contribution_matches_reference(occl_frac):
    jb = JaxSceneBuilder()
    _populate_light_scene(jb, JMT)
    js = jb.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    rng = np.random.default_rng(13)
    p = rng.uniform([-4, 0, -4], [4, 3, 4], (N, 3)).astype(np.float32)
    ns, wo = _unit(rng, N), _unit(rng, N)
    mtl = rng.integers(0, 4, N).astype(np.int32)  # the four shading families
    occ = rng.random(N) < occl_frac
    seeds = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)

    from aten_tpu.scene.materials import gather_material as jgather

    mat_j = jgather(js["materials"], jnp.asarray(mtl))
    mat_t = gather_material(ts["materials"], torch.tensor(mtl))
    for k in mat_t:
        np.testing.assert_array_equal(mat_t[k].numpy(), np.asarray(mat_j[k]), err_msg=k)
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
        _close(a, b, "shadow " + name)
    _close(ct, cj, "contribution")
    assert (ct.numpy() > 0).any(axis=1).mean() > 0.1


def test_implicit_light_weight_matches_reference():
    jb = JaxSceneBuilder()
    _populate_light_scene(jb, JMT)
    js = jb.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    rng = np.random.default_rng(14)
    light = rng.integers(-1, 5, N).astype(np.int32)
    pdf_prev = rng.uniform(0.0, 3.0, N).astype(np.float32)
    sing = rng.random(N) < 0.3
    t = rng.uniform(0.1, 10.0, N).astype(np.float32)
    cos_l = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    ref = jnee.implicit_light_weight(js, *map(jnp.asarray, (light, pdf_prev, sing, t, cos_l)))
    got = tnee.implicit_light_weight(ts, *map(torch.tensor, (light, pdf_prev, sing, t, cos_l)))
    _close(got, ref, "w")
