"""aten_tpu_torch's material zoo against aten_tpu.shading.brdf.

The seven families the port adds (OREN_NAYAR, BECKMANN, VELVET, DISNEY,
MICROFACET_REFRACTION, RETROREFLECTIVE, CAR_PAINT) and a batch mixing all
twelve non-toon types are sampled and evaluated on the same seeded inputs
by both packages.  `singular` and `transmission` must be equal.  `wi`,
`pdf` and `bsdf` are held to the two-level bound of test_torch_shading.py:
at least 99.5% of lanes within rtol 1e-5 / atol 1e-6, and every lane
within rtol 5e-3 / atol 1e-4.  For `sample_brdf` the first level holds
the sampled pdf and bsdf against the reference's evaluation at the
port's own sampled wi: XLA's and torch's sin and cos differ by one ulp
on ~5% of inputs, which moves the sampled wi by a few ulps, and the
rough dielectric's transmission pdf is steep enough in wi that 0.56% of
its lanes then differ by more than 1e-5 (up to 1.5e-4) from the
reference's sample (ROADMAP queue 3).  The second level holds them
against the reference's sample itself.

Roughness is drawn from [0.15, 0.9], the zoo's range.  Below it a
microfacet peak cancels in float32 (GGX's nh^2 (a^2 - 1) + 1 and
Beckmann's (1 - nh^2) / nh^2 lose all but a few bits when a^2 is ~1e-5),
so a 1-ulp difference between XLA's and torch's transcendental functions
grows there to relative errors of a few percent.

Also here: the counterparts of test_materials.py (white furnace,
sample/eval pdf consistency, flake coverage) and of
test_retroreflective_era.py; the ERA table and the lookup3 flake hash
`_inthash4` are bitwise equal to the reference's; `flakes_gen` agrees on
the coverage of at least 99.9% of lanes and on the normals within rtol
1e-5 / atol 1e-6 where the coverage agrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.shading import brdf as jbrdf
from aten_tpu.utils import flakes as jflakes
from aten_tpu.utils import retroreflective as jretro
from aten_tpu_torch.core import sampler as tsmp
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.materials import MaterialTable, MaterialType, gather_material
from aten_tpu_torch.shading import brdf as tbrdf
from aten_tpu_torch.utils import flakes as tflakes
from aten_tpu_torch.utils import retroreflective as tretro
from test_torch_shading import ATOL, RTOL, _both, _unit
from test_torch_shading import _close_but_peaks as _two_level

torch.set_num_threads(1)

N = 4096
USED = tuple(sorted(int(t) for t in MaterialType
                    if t not in (MaterialType.TOON, MaterialType.STYLIZED_BRDF)))
NEW_FAMILIES = ("OREN_NAYAR", "BECKMANN", "VELVET", "DISNEY", "MICROFACET_REFRACTION",
                "RETROREFLECTIVE", "CAR_PAINT")

def _materials(rng, n, mtype=None):
    """Per-lane material rows with every field the zoo reads, drawn at
    random, and flake fields from the reference's carpaint_flake_fields
    at random uvs."""
    t = (rng.choice(np.array(USED, np.int32), n) if mtype is None
         else np.full(n, int(mtype), np.int32))

    def u(lo, hi, shape=(n,)):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    mat = {
        "type": t.astype(np.int32),
        "base_color": u(0.05, 1.0, (n, 3)),
        "roughness": u(0.15, 0.9),
        "ior": u(1.2, 2.6),
        **{k: u(0.0, 1.0) for k in ("metallic", "clearcoat", "clearcoat_gloss", "sheen",
                                    "sheen_tint", "specular", "specular_tint", "subsurface",
                                    "flake_size_variance", "flake_normal_orientation")},
        "clearcoat_ior": u(1.5, 3.0),
        "clearcoat_roughness": u(0.15, 0.5),
        "clearcoat_color": u(0.5, 1.0, (n, 3)),
        "flakes_color": u(0.2, 1.0, (n, 3)),
        "flake_color_multiplier": u(0.5, 1.5),
        "flake_scale": u(50.0, 500.0),
        "flake_size": u(0.1, 0.4),
    }
    mj = {k: jnp.asarray(v) for k, v in mat.items()}
    uv, ns = jnp.asarray(u(0.0, 1.0, (n, 2))), jnp.asarray(_unit(rng, n))
    fl = jbrdf.carpaint_flake_fields(mj, uv, ns)
    mat["flake_a"] = np.asarray(fl["flake_a"])
    mat["flake_nml"] = np.asarray(fl["flake_nml"])
    return mat


@pytest.mark.parametrize("mtype", [None, *NEW_FAMILIES])
def test_sample_brdf_matches_reference(mtype):
    rng = np.random.default_rng(20)
    mat_j, mat_t = _both(_materials(rng, N, None if mtype is None else MaterialType[mtype]))
    ns, wo = _unit(rng, N), _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    ref = jbrdf.sample_brdf(mat_j, jnp.asarray(ns), jnp.asarray(wo),
                            *map(jnp.asarray, u), used=USED)
    got = tbrdf.sample_brdf(mat_t, torch.tensor(ns), torch.tensor(wo),
                            *map(torch.tensor, u), USED)
    for k in ("singular", "transmission"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    _two_level(got["wi"], ref["wi"], "wi")
    # pdf and bsdf against the reference's at the port's own sample wi
    # (the evaluation), and every lane against the reference's sample
    wi = jnp.asarray(got["wi"].numpy())
    f_ref, pdf_ref = jbrdf.eval_bsdf_pdf(mat_j, jnp.asarray(ns), jnp.asarray(wo), wi, used=USED)
    n_or = jbrdf.orient_normal(jnp.asarray(ns), jnp.asarray(wo))
    inv_cos = 1.0 / jnp.maximum(jnp.abs(jnp.sum(n_or * wi, axis=-1)), 1e-6)
    sing = ref["singular"]
    f_ref = jnp.where(sing[..., None], mat_j["base_color"] * inv_cos[..., None], f_ref)
    pdf_ref = jnp.where(sing, 1.0, pdf_ref)
    _two_level(got["pdf"], pdf_ref, "pdf at the port's wi")
    _two_level(got["bsdf"], f_ref, "bsdf at the port's wi")
    for k in ("pdf", "bsdf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=5e-3, atol=1e-4,
                                   err_msg=k)
    # the lobe is real: most lanes sample a direction of nonzero pdf
    assert (got["pdf"].numpy() > 0).mean() > 0.3


@pytest.mark.parametrize("mtype", [None, *NEW_FAMILIES])
def test_eval_bsdf_pdf_matches_reference(mtype):
    rng = np.random.default_rng(21)
    mat_j, mat_t = _both(_materials(rng, N, None if mtype is None else MaterialType[mtype]))
    ns, wo, wi = _unit(rng, N), _unit(rng, N), _unit(rng, N)
    fj, pj = jbrdf.eval_bsdf_pdf(mat_j, *map(jnp.asarray, (ns, wo, wi)), used=USED)
    ft, pt = tbrdf.eval_bsdf_pdf(mat_t, *map(torch.tensor, (ns, wo, wi)), USED)
    _two_level(ft, fj, "f")
    _two_level(pt, pj, "pdf")


# --- counterparts of test_materials.py ----------------------------------------


def _mat_row(mtype, n, **kw):
    t = MaterialTable()
    t.add(mtype, **kw)
    return gather_material(
        {k: torch.tensor(v) for k, v in t.numpy_arrays().items()},
        torch.zeros(n, dtype=torch.int64))


def _lane_uniforms(n):
    st = tsmp.make_state(tsmp.wang_hash(torch.arange(n, dtype=torch.int64)), 0, 0, 1)
    u1, u2, st = tsmp.next_2d(st)
    u3, _ = tsmp.next_1d(st)
    return u1, u2, u3


@pytest.mark.parametrize("mtype,kw", [
    (MaterialType.DIFFUSE, {}),
    (MaterialType.OREN_NAYAR, {"roughness": 0.5}),
    (MaterialType.GGX, {"roughness": 0.3, "ior": 1.8}),
    (MaterialType.BECKMANN, {"roughness": 0.3, "ior": 1.8}),
    (MaterialType.SPECULAR, {}),
    (MaterialType.REFRACTION, {"ior": 1.5}),
    (MaterialType.VELVET, {"roughness": 0.4}),
    (MaterialType.DISNEY, {"roughness": 0.4, "metallic": 0.3, "clearcoat": 0.5, "sheen": 0.3}),
    (MaterialType.MICROFACET_REFRACTION, {"roughness": 0.2, "ior": 1.5}),
    (MaterialType.RETROREFLECTIVE, {"roughness": 0.2}),
    (MaterialType.CAR_PAINT, {"roughness": 0.3}),
])
def test_energy_conservation(mtype, kw):
    """White furnace: the reflectance estimate stays <= 1 (+ MC slack)."""
    mat = _mat_row(mtype, N, base_color=(1.0, 1.0, 1.0), **kw)
    n = torch.tensor([0.0, 0.0, 1.0]).expand(N, 3)
    wo = vm.normalize(torch.tensor([0.3, 0.1, 0.9]).expand(N, 3))
    s = tbrdf.sample_brdf(mat, n, wo, *_lane_uniforms(N), USED)
    cos = torch.abs(vm.dot(n, s["wi"], keepdims=False))
    refl = (s["bsdf"] * (cos / torch.clamp(s["pdf"], min=1e-9))[..., None]).mean(0).numpy()
    assert np.isfinite(refl).all()
    assert refl.max() <= 1.05, refl


@pytest.mark.parametrize("mtype,kw", [
    (MaterialType.DIFFUSE, {}),
    (MaterialType.GGX, {"roughness": 0.4, "ior": 1.6}),
    (MaterialType.BECKMANN, {"roughness": 0.4, "ior": 1.6}),
    (MaterialType.DISNEY, {"roughness": 0.4, "metallic": 0.5}),
    (MaterialType.MICROFACET_REFRACTION, {"roughness": 0.3, "ior": 1.5}),
    (MaterialType.RETROREFLECTIVE, {"roughness": 0.3}),
    (MaterialType.CAR_PAINT, {"roughness": 0.3}),
])
def test_sample_eval_pdf_consistent(mtype, kw):
    """The pdf sampling returns equals eval_bsdf_pdf's at the sample."""
    n_l = 512
    mat = _mat_row(mtype, n_l, **kw)
    n = torch.tensor([0.0, 0.0, 1.0]).expand(n_l, 3)
    wo = vm.normalize(torch.tensor([0.4, -0.2, 0.8]).expand(n_l, 3))
    s = tbrdf.sample_brdf(mat, n, wo, *_lane_uniforms(n_l), USED)
    _, pdf2 = tbrdf.eval_bsdf_pdf(mat, n, wo, s["wi"], USED)
    np.testing.assert_allclose(s["pdf"].numpy(), pdf2.numpy(), rtol=2e-3, atol=1e-5)


def test_retroreflective_peak_toward_source():
    """Corner-cube sheeting sends light back toward the source."""
    mat = _mat_row(MaterialType.RETROREFLECTIVE, 1, roughness=0.15, ior=1.5)
    n = torch.tensor([[0.0, 0.0, 1.0]])
    wo = vm.normalize(torch.tensor([[0.35, 0.0, 0.9]]))
    side = vm.normalize(torch.tensor([[0.0, 0.35, 0.9]]))
    f_retro, _ = tbrdf.eval_bsdf_pdf(mat, n, wo, wo, USED)
    f_side, _ = tbrdf.eval_bsdf_pdf(mat, n, wo, side, USED)
    assert f_retro.mean() > 4.0 * f_side.mean(), (f_retro, f_side)


def test_carpaint_flake_fields_coverage():
    """Flake coverage tracks the analytic density and the flake normal
    tilts away from the surface normal on flakes only."""
    n_l = 8192
    mat = _mat_row(MaterialType.CAR_PAINT, n_l, flake_size=0.25)
    rng = np.random.default_rng(1)
    uv = torch.tensor(rng.uniform(0, 1, (n_l, 2)).astype(np.float32))
    ns = torch.tensor([0.0, 0.0, 1.0]).expand(n_l, 3)
    m2 = tbrdf.carpaint_flake_fields(mat, uv, ns)
    cover = float(m2["flake_a"].mean())
    dens = float(np.pi * 0.25 ** 2)
    assert 0.2 * dens < cover < 1.2 * dens, (cover, dens)
    dev = 1.0 - vm.dot(m2["flake_nml"], ns, keepdims=False).numpy()
    a = m2["flake_a"].numpy() > 0
    assert dev[a].mean() > 1e-3
    np.testing.assert_allclose(dev[~a], 0.0, atol=1e-6)


def test_carpaint_flakes_color_visible():
    """Flake lanes reflect flakes_color through the wide Beckmann lobe."""
    mat = _mat_row(MaterialType.CAR_PAINT, 4, base_color=(0.6, 0.05, 0.05),
                   flakes_color=(1.0, 1.0, 0.0))
    n = torch.tensor([0.0, 0.0, 1.0]).expand(4, 3)
    wo = vm.normalize(torch.tensor([0.2, 0.1, 0.95]).expand(4, 3))
    wi = vm.normalize(torch.tensor([-0.3, 0.2, 0.9]).expand(4, 3))
    f_on, _ = tbrdf.eval_bsdf_pdf(dict(mat, flake_a=torch.ones(4), flake_nml=n), n, wo, wi, USED)
    f_off, _ = tbrdf.eval_bsdf_pdf(dict(mat, flake_a=torch.zeros(4), flake_nml=n), n, wo, wi,
                                   USED)
    assert not torch.allclose(f_on, f_off)
    assert f_on[:, 2].mean() < f_on[:, 0].mean()


# --- flakes ---------------------------------------------------------------------


def test_inthash4_bitwise():
    """lookup3 on seeded keys, negative cells (two's complement) and the
    uint32 extremes included."""
    rng = np.random.default_rng(22)
    cells = rng.integers(-(1 << 20), 1 << 20, (3, 4096)).astype(np.int32)
    cells[:, :4] = [[0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]] * 3
    keys = cells.astype(np.uint32)
    k3 = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jflakes._inthash4(*(jnp.asarray(k) for k in (*keys, k3))))
    got = tflakes._inthash4(*(torch.tensor(k.astype(np.int64)) for k in (*keys, k3)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    # the float cells: floor, int32, then the uint32 reinterpretation (on
    # cells that float32 holds exactly, so not the int32 extremes)
    exact = np.r_[0:2, 4:4096]
    p = torch.tensor(cells[0, exact].astype(np.float32) + 0.25)
    np.testing.assert_array_equal(tflakes._cell_key(p).numpy(), keys[0, exact].astype(np.int64))
    fc = cells[:, exact].astype(np.float32) + 0.5
    r_ref = jflakes._cellnoise3(*(jnp.asarray(c) for c in fc))
    r_got = tflakes._cellnoise3(*(torch.tensor(c) for c in fc))
    for a, b in zip(r_got, r_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_flakes_gen_matches_reference():
    rng = np.random.default_rng(23)
    n = 1 << 15
    args = [rng.uniform(-2.0, 3.0, n), rng.uniform(-2.0, 3.0, n), rng.uniform(50, 500, n),
            rng.uniform(0.1, 0.45, n), rng.uniform(0.0, 1.2, n), rng.uniform(0.0, 1.0, n)]
    args = [a.astype(np.float32) for a in args]
    nj, aj = jflakes.flakes_gen(*map(jnp.asarray, args))
    nt, at = tflakes.flakes_gen(*map(torch.tensor, args))
    same = at.numpy() == np.asarray(aj)
    assert same.mean() >= 0.999, int((~same).sum())
    assert 0.05 < at.numpy().mean() < 0.6
    np.testing.assert_allclose(nt.numpy()[same], np.asarray(nj)[same], rtol=RTOL, atol=ATOL)
    dens = tflakes.flake_density(torch.tensor(args[3]))
    dens_ref = jflakes.flake_density(jnp.asarray(args[3]))
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_ref), rtol=1e-7)


def test_make_flakes_normal_map_matches_reference():
    got = tflakes.make_flakes_normal_map(size=64, flake_scale=8.0, seed=3)
    ref = jflakes.make_flakes_normal_map(size=64, flake_scale=8.0, seed=3)
    np.testing.assert_array_equal(got, ref)


# --- the ERA table and the counterparts of test_retroreflective_era.py --------


def test_era_theta_table_bitwise():
    th_t, era_t = tbrdf._era_theta_table()
    th_j, era_j = jbrdf._era_theta_table()
    np.testing.assert_array_equal(th_t, th_j)
    np.testing.assert_array_equal(era_t, era_j)
    assert era_t.dtype == np.float32 and era_t.shape == (91,)


def test_retro_era_table_shape():
    """High plateau near normal incidence, zero by ~65 degrees."""
    th, vals = tbrdf._era_theta_table()
    assert vals[0] > 0.5 and vals[:5].max() <= 0.75
    deg = np.degrees(th)
    assert vals[deg > 65].max() < 1e-3
    head = vals[deg < 10].mean()
    mid = vals[(deg > 25) & (deg < 35)].mean()
    assert head > mid > vals[deg > 55].mean()


def test_normal_incidence_era_two_thirds():
    v = tretro.era(np.float32(0.0), np.float32(0.0), n_orgs=100)
    assert v.shape == (1,)
    np.testing.assert_allclose(v[0], 2.0 / 3.0, atol=0.02)
    np.testing.assert_array_equal(v, np.asarray(jretro.era(np.float32(0.0), np.float32(0.0),
                                                           n_orgs=100, xp=np)))


def test_grazing_incidence_low_overlap():
    assert tretro.era(np.float32(np.pi / 2 - 0.05), np.float32(0.0), n_orgs=40)[0] < 0.2


def test_era_monotone_falloff_and_range():
    tt, pp = np.meshgrid(np.linspace(0.0, np.pi / 2, 12, endpoint=False),
                         np.linspace(0.0, np.pi, 12, endpoint=False), indexing="ij")
    table = tretro.era(tt.ravel(), pp.ravel(), n_orgs=30).reshape(12, 12)
    assert ((table >= 0) & (table <= 1)).all()
    prof = table.mean(axis=1)
    assert prof[0] > prof[-1]


def test_ray_frame_and_origins_match_reference():
    th = np.linspace(0.0, 1.5, 7).astype(np.float32)
    ph = np.linspace(0.0, 3.0, 7).astype(np.float32)
    np.testing.assert_array_equal(tretro.gen_ray(th, ph), jretro.gen_ray(th, ph, xp=np))
    np.testing.assert_array_equal(tretro.ray_origins(10), jretro.ray_origins(10))
    d = tretro.gen_ray(np.zeros(1, np.float32), np.zeros(1, np.float32))[0]
    n = np.cross(np.array([0, -1, 1.0]) / np.sqrt(2), np.array([1, -1, 0.0]) / np.sqrt(2))
    np.testing.assert_allclose(d, -n / np.linalg.norm(n), atol=1e-6)
