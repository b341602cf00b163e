"""Public names the port's modules gained to match aten_tpu's:
core/vecmath.py's EPS, intersect_aabb, intersect_tri, intersect_sphere,
transform_point and transform_vector (rtol 1e-6 against the
reference's); shading/brdf.py's eval_bsdf and eval_pdf (the two-level
bound of test_torch_shading.py, roughness in [0.15, 0.9]) and the
`used=None` default (every family); utils/retroreflective.py's era_table
(test_retroreflective_era.py's tolerance, atol 0.02: both evaluate in
float32, and 5 of 144 entries differ, by up to 0.0065, where a grid
origin on a triangle's edge flips a hit); and
scene/materials.py's SINGULAR_TYPES and TRANSMISSIVE_TYPES."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_materials import USED, _materials
from test_torch_shading import _both, _unit
from test_torch_shading import _close_but_peaks as _two_level

from aten_tpu.core import vecmath as jvm
from aten_tpu.scene import materials as jmaterials
from aten_tpu.shading import brdf as jbrdf
from aten_tpu.utils import retroreflective as jretro
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene import materials
from aten_tpu_torch.shading import brdf
from aten_tpu_torch.utils import retroreflective as retro

torch.set_num_threads(1)
N = 2048


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_vecmath_intersections_match_reference():
    assert vm.EPS == jvm.EPS
    rng = np.random.default_rng(40)
    ro = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    rd = _unit(rng, N)
    # aim half the rays at a triangle and the sphere so both paths hit
    v0 = np.array([-1.0, -1.0, 0.5], np.float32)
    e1 = np.array([2.5, 0.2, 0.1], np.float32)
    e2 = np.array([0.3, 2.4, -0.2], np.float32)
    rd[::2] = (v0 + 0.3 * e1 + 0.3 * e2 - ro[::2])
    rd[::2] /= np.linalg.norm(rd[::2], axis=1, keepdims=True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         dict(ro=ro, rd=rd, v0=v0, e1=e1, e2=e2).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    got = vm.intersect_tri(t["ro"], t["rd"], t["v0"], t["e1"], t["e2"])
    with jax.disable_jit():  # jnp.cross is jitted, and contracts multiply-adds
        ref = jvm.intersect_tri(j["ro"], j["rd"], j["v0"], j["e1"], j["e2"])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[3].sum()) > N // 4
    for a, b in zip(got[:3], ref[:3]):
        m = got[3].numpy()
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], rtol=1e-6, atol=1e-6)
    c, r = np.array([0.2, -0.1, 0.4], np.float32), 1.1
    got = vm.intersect_sphere(t["ro"], t["rd"], torch.from_numpy(c), r)
    ref = jvm.intersect_sphere(j["ro"], j["rd"], jnp.asarray(c), r)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    m = got[1].numpy()
    assert m.sum() > N // 4
    np.testing.assert_allclose(got[0].numpy()[m], np.asarray(ref[0])[m], rtol=1e-6)
    inv = 1.0 / np.where(rd == 0, 1e-30, rd)
    bmin, bmax = np.array([-1, -1, -1], np.float32), np.array([1, 0.5, 1], np.float32)
    tmax = rng.uniform(0.5, 6, N).astype(np.float32)
    got = vm.intersect_aabb(t["ro"], torch.from_numpy(inv), torch.from_numpy(bmin),
                            torch.from_numpy(bmax), torch.from_numpy(tmax))
    ref = jvm.intersect_aabb(j["ro"], jnp.asarray(inv), jnp.asarray(bmin), jnp.asarray(bmax),
                             jnp.asarray(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < N


def test_transforms_match_reference():
    rng = np.random.default_rng(41)
    m = rng.normal(size=(N, 4, 4)).astype(np.float32)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    _close(vm.transform_point(torch.from_numpy(m), torch.from_numpy(p)),
           jvm.transform_point(jnp.asarray(m), jnp.asarray(p)))
    _close(vm.transform_vector(torch.from_numpy(m), torch.from_numpy(p)),
           jvm.transform_vector(jnp.asarray(m), jnp.asarray(p)))
    one = rng.normal(size=(4, 4)).astype(np.float32)  # one matrix, many points
    _close(vm.transform_point(torch.from_numpy(one), torch.from_numpy(p)),
           jvm.transform_point(jnp.asarray(one), jnp.asarray(p)))


@pytest.mark.parametrize("mtype", [None, "GGX", "DISNEY", "MICROFACET_REFRACTION",
                                   "CAR_PAINT"])
def test_eval_bsdf_and_eval_pdf_match_reference(mtype):
    rng = np.random.default_rng(42)
    mat_j, mat_t = _both(_materials(rng, N, None if mtype is None
                                    else materials.MaterialType[mtype]))
    ns, wo, wi = _unit(rng, N), _unit(rng, N), _unit(rng, N)
    tj, tt = [jnp.asarray(x) for x in (ns, wo, wi)], [torch.from_numpy(x) for x in (ns, wo, wi)]
    for used_t, used_j in ((USED, USED), (None, None)):
        f = brdf.eval_bsdf(mat_t, *tt, used_t)
        p = brdf.eval_pdf(mat_t, *tt, used_t)
        _two_level(f, jbrdf.eval_bsdf(mat_j, *tj, used=used_j), "f")
        _two_level(p, jbrdf.eval_pdf(mat_j, *tj, used=used_j), "pdf")
    # used=None evaluates every family: the same as naming them all
    assert torch.equal(brdf.eval_bsdf(mat_t, *tt), brdf.eval_bsdf(mat_t, *tt, USED))


def test_era_table_matches_reference():
    got = retro.era_table(steps=12, n_orgs=30, device="cpu")
    ref = jretro.era_table(steps=12, n_orgs=30)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), atol=0.02)
    assert got[2].dtype == np.float32
    thetas, phis, table = got
    assert table.shape == (12, 12) and ((table >= 0) & (table <= 1)).all()
    assert table.mean(axis=1)[0] > table.mean(axis=1)[-1]


def test_type_tuples_match_reference():
    for name in ("SINGULAR_TYPES", "TRANSMISSIVE_TYPES"):
        assert ([int(t) for t in getattr(materials, name)]
                == [int(t) for t in getattr(jmaterials, name)]), name
