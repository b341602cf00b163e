"""aten_tpu_torch's material-partitioned dispatch (shading/dispatch.py)
against its branchless BSDF calls and against aten_tpu's dispatch.

The gate ATEN_TPU_PARTITION is read at import in both packages, so the
tests set the modules' `_ENV_PARTITION` with monkeypatch (a module
attribute at run time; no file changes).  On 16,384 lanes of the zoo's
families (roughness in [0.15, 0.9]; the flake fields from the
reference's carpaint_flake_fields) the port's partitioned `sample_brdf`
and `eval_bsdf_pdf` are bitwise its branchless ones, and they agree with
the reference's partitioned ones within test_torch_shading.py's
two-level bound (>= 99.5% of lanes within rtol 1e-5 / atol 1e-6, every
lane within rtol 5e-3 / atol 1e-4).  The reference's dispatch runs op by
op (`jax.disable_jit()`, ~16 s): jitted, its chunks' branches contract
multiply-adds, and 195 of its 16,384 sampled directions then differ from
its own branchless call by more than rtol 1e-5 (the port's: 3).  A zoo render with the gate on is
bitwise the render with it off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_shading import _close_but_peaks as _two_level
from test_torch_shading import _unit

from aten_tpu.scene import materials as jmaterials
from aten_tpu.scene.scene import SceneBuilder as JSceneBuilder
from aten_tpu.shading import brdf as jbrdf
from aten_tpu.shading import dispatch as jdispatch
from aten_tpu_torch.integrator.pathtracer import render_sample
from aten_tpu_torch.scene import scenedefs
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.scene.scene import SceneBuilder
from aten_tpu_torch.shading import brdf, dispatch

torch.set_num_threads(1)
N = 16384
FAMILIES = [t for t in MaterialType if t not in (MaterialType.TOON, MaterialType.STYLIZED_BRDF)]
USED = tuple(sorted(int(t) for t in FAMILIES))


def _tables(rng):
    """Both packages' material tables of two random rows per family."""
    b, jb = SceneBuilder(), JSceneBuilder()
    for t in FAMILIES:
        for _ in range(2):
            kw = {"base_color": tuple(rng.uniform(0.05, 1.0, 3)),
                  "roughness": float(rng.uniform(0.15, 0.9)),
                  "ior": float(rng.uniform(1.2, 2.6)),
                  **{k: float(rng.uniform(0, 1)) for k in (
                      "metallic", "clearcoat", "sheen", "specular", "subsurface")}}
            b.add_material(t, **kw)
            jb.add_material(jmaterials.MaterialType(int(t)), **kw)
    quad = ([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
    b.add_quad(*quad, 0)
    jb.add_quad(*quad, 0)
    return b.build("cpu"), jb.build()


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(30)
    scene, jscene = _tables(rng)
    ids = rng.integers(0, 2 * len(FAMILIES), N).astype(np.int32)
    jmat = dict(jmaterials.gather_material(jscene["materials"], jnp.asarray(ids)))
    uv, ns = rng.uniform(0, 1, (N, 2)).astype(np.float32), _unit(rng, N)
    jmat = dict(jbrdf.carpaint_flake_fields(jmat, jnp.asarray(uv), jnp.asarray(ns)))
    mat = gather_material(scene["materials"], torch.from_numpy(ids))
    mat["flake_a"] = torch.tensor(np.asarray(jmat["flake_a"]))
    mat["flake_nml"] = torch.tensor(np.asarray(jmat["flake_nml"]))
    wo, wi = _unit(rng, N), _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    return scene, jscene, mat, jmat, ns, wo, wi, u


def _partitioned(monkeypatch, on=True):
    monkeypatch.setattr(dispatch, "_ENV_PARTITION", on)
    monkeypatch.setattr(jdispatch, "_ENV_PARTITION", on)
    calls = []
    real = dispatch._dispatch
    monkeypatch.setattr(dispatch, "_dispatch", lambda *a: calls.append(1) or real(*a))
    return calls


def test_worth_partitioning_gate(monkeypatch):
    assert not dispatch.worth_partitioning(USED, N)  # off by default
    monkeypatch.setattr(dispatch, "_ENV_PARTITION", True)
    assert dispatch.worth_partitioning(USED, N)
    assert not dispatch.worth_partitioning(USED, dispatch.MIN_LANES - 1)
    assert not dispatch.worth_partitioning(None, N)
    cheap = tuple(int(t) for t in (MaterialType.DIFFUSE, MaterialType.SPECULAR,
                                   MaterialType.GGX))
    assert not dispatch.worth_partitioning(cheap, N)  # one expensive family


def test_partitioned_is_bitwise_branchless(monkeypatch, lanes):
    scene, _, mat, _, ns, wo, wi, u = lanes
    calls = _partitioned(monkeypatch)
    t = [torch.from_numpy(x) for x in (ns, wo, wi, *u)]
    got = dispatch.sample_brdf(scene, mat, t[0], t[1], *t[3:], used=USED)
    want = brdf.sample_brdf(mat, t[0], t[1], *t[3:], USED)
    f, p = dispatch.eval_bsdf_pdf(scene, mat, t[0], t[1], t[2], used=USED)
    wf, wp = brdf.eval_bsdf_pdf(mat, t[0], t[1], t[2], USED)
    assert len(calls) == 2
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(f, wf) and torch.equal(p, wp)
    assert len(torch.unique(mat["type"])) == len(FAMILIES)


def test_partitioned_matches_reference(monkeypatch, lanes):
    scene, jscene, mat, jmat, ns, wo, wi, u = lanes
    _partitioned(monkeypatch)
    assert jdispatch.worth_partitioning(USED, N)
    t = [torch.from_numpy(x) for x in (ns, wo, wi, *u)]
    j = [jnp.asarray(x) for x in (ns, wo, wi, *u)]
    got = dispatch.sample_brdf(scene, mat, t[0], t[1], *t[3:], used=USED)
    with jax.disable_jit():
        ref = jdispatch.sample_brdf(jscene, jmat, j[0], j[1], *j[3:], used=USED)
        jf, jp = jdispatch.eval_bsdf_pdf(jscene, jmat, j[0], j[1], j[2], used=USED)
    for k in ("singular", "transmission"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("wi", "pdf", "bsdf"):
        _two_level(got[k], ref[k], k)
    f, p = dispatch.eval_bsdf_pdf(scene, mat, t[0], t[1], t[2], used=USED)
    _two_level(f, jf, "f")
    _two_level(p, jp, "pdf")


def test_zoo_render_with_the_gate_on_is_bitwise_off(monkeypatch):
    scene, cam = scenedefs.material_test_scene(128, 128, device="cpu")
    ca = cam.arrays("cpu")
    off = render_sample(scene, ca, 128, 128, 0, 0, 1, 2, 1)
    calls = _partitioned(monkeypatch)
    on = render_sample(scene, ca, 128, 128, 0, 0, 1, 2, 1)
    assert len(calls) >= 2  # the BSDF sample and NEE went through the partition
    assert torch.equal(on, off) and float(on.mean()) > 0
