"""aten_tpu_torch's toon families against aten_tpu.shading.toon.

* The counterparts of the four tests of tests/test_toon.py, on the port.
* `stylized_half`, `rim_light` and `toon_term` against the reference on
  the same seeded lanes: a scene with a light of every kind and a dozen
  toon and stylized materials with seeded highlight, rim and remap
  settings, each keyed to one of the lights or to none.  Bound: at least
  99.5% of lanes within rtol 1e-5 / atol 1e-6, every lane within rtol
  5e-3 / atol 1e-4 (test_torch_shading.py's two levels): the remap reads
  the ramp at lum^(1/2.2) and the stylized highlight squares arccos
  powers, where an ulp of XLA's pow or arccos against torch's can move a
  lane.  Measured on these seeds: every lane of toon_term within the
  first level (max relative difference 2.8e-6).
* `toon_scene(32, 32)`, plain and stylized, 4 spp, depth 4, against
  aten_tpu's `render_image` on the same scene, with the full-image
  radiance bounds (fraction of pixels with rel > 2e-2 under 5e-3, mean
  rel under 3e-3).
* `bridge.from_numpy` carries the toon material fields, the remap
  texture and the point light across: the bridged scene equals the
  port's own build, array for array.
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
from aten_tpu.scene.materials import gather_material as jax_gather
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu.shading import toon as jtoon
from aten_tpu_torch.core import sampler as tsmp
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.scene.scene import SceneBuilder
from aten_tpu_torch.shading import toon as ttoon

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 1e-6
HL_KEYS = ("toon_hl_translation_t", "toon_hl_translation_b", "toon_hl_scale_t",
           "toon_hl_scale_b", "toon_hl_split_t", "toon_hl_split_b",
           "toon_hl_square_sharp", "toon_hl_square_magnitude")


def _unit(rng, n):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _two_level(got, ref, what):
    """RTOL/ATOL on >= 99.5% of lanes, every lane within rtol 5e-3 /
    atol 1e-4 (see the module docstring)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.isfinite(got).all(), what
    ok = np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)
    lanes = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert lanes.mean() >= 0.995, (what, int((~lanes).sum()))
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-4, err_msg=what)


# --- the counterparts of tests/test_toon.py ---------------------------------


def test_stylized_half_reduces_to_ggx_half():
    n = torch.tensor([[0.0, 1.0, 0.0]] * 4)
    v = torch.tensor([[0.3, 0.8, 0.1]] * 4)
    v = v / v.norm(dim=-1, keepdim=True)
    l = torch.tensor([[-0.4, 0.7, 0.2]] * 4)
    l = l / l.norm(dim=-1, keepdim=True)
    mat = {k: torch.zeros(4) for k in HL_KEYS}
    mat["toon_hl_square_sharp"] = torch.ones(4)
    h = ttoon.stylized_half(mat, n, v, l)
    h_ref = (v + l) / (v + l).norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=1e-5)


def test_rim_light_bright_at_grazing():
    mat = {
        "toon_rim_enable": torch.ones(2),
        "toon_rim_color": torch.tensor([[1.0, 0.5, 0.25]] * 2),
        "toon_rim_width": torch.full((2,), 0.5),
        "toon_rim_softness": torch.full((2,), 0.5),
        "toon_rim_spread": torch.ones(2),
    }
    n = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    # lane 0: grazing view; lane 1: head-on view
    rd = torch.tensor([[-0.995, 0.0, -0.0999], [0.0, 0.0, -1.0]])
    rd = rd / rd.norm(dim=-1, keepdim=True)
    rim = ttoon.rim_light(mat, n, rd).numpy()
    assert rim[0, 0] > 0.3
    assert rim[1].max() < 1e-3
    np.testing.assert_allclose(rim[0] / rim[0, 0], [1.0, 0.5, 0.25], atol=1e-5)


def test_toon_scene_bands_and_termination():
    """The toon sphere shows the remap's bands and ends at bounce 0."""
    scene, cam = tdefs.toon_scene(96, 96, device="cpu")
    img = render_image(scene, cam, spp=4, max_depth=3).numpy()
    assert np.isfinite(img).all()
    patch = img[30:45, 18:40]  # on the left sphere
    assert patch.max() > 0.05
    lum = (patch * [0.2126, 0.7152, 0.0722]).sum(-1)
    lit = lum[lum > 0.02]
    assert lit.size > 20
    levels = np.unique(np.round(lit / lum.max() * 20))
    assert levels.size <= 10


def test_stylized_scene_renders():
    scene, cam = tdefs.toon_scene(64, 64, stylized=True, device="cpu")
    img = render_image(scene, cam, spp=2, max_depth=2).numpy()
    assert np.isfinite(img).all()
    assert img.max() > 0.01


# --- the module against the reference, lane for lane -----------------------


def _populate_toon_lab(b, mt, seed=21):
    """A floor, an emissive sphere, a light of every kind, the toon ramp
    and 12 toon and stylized materials with seeded settings.  Returns the
    toon material ids."""
    rng = np.random.default_rng(seed)
    floor = b.add_material(mt.DIFFUSE, base_color=(0.6, 0.6, 0.6))
    emit = b.add_material(mt.EMISSIVE, base_color=(20.0, 18.0, 15.0))
    b.add_quad([-5, 0, 5], [5, 0, 5], [5, 0, -5], [-5, 0, -5], floor)
    ls, lc = b.add_quad([-1, 6, 1], [-1, 6, -1], [1, 6, -1], [1, 6, 1], emit)
    lights = [b.add_area_light_tris(ls, lc, le=(20.0, 18.0, 15.0))]
    sid = b.add_sphere((2.5, 4.0, 2.0), 0.3, emit)
    lights.append(b.add_area_light_sphere(sid, le=(30.0, 30.0, 30.0)))
    lights.append(b.add_point_light((-3.0, 3.0, 2.0), le=(150.0, 120.0, 100.0)))
    lights.append(b.add_spot_light((0.0, 5.0, 3.0), (0.0, -1.0, -0.5), le=(400.0, 400.0, 400.0),
                                   inner_angle=0.4, outer_angle=0.7))
    lights.append(b.add_directional_light((-0.3, -1.0, 0.2), le=(2.0, 2.0, 1.8)))
    ramp = np.zeros((1, 64, 3), np.float32)
    ramp[0] = np.repeat([0.18, 0.45, 0.8, 1.0], 16)[:, None] * rng.uniform(0.7, 1.0, 3)
    remap = b.add_texture(ramp)
    ids = []
    for i in range(12):
        kw = {k: float(rng.uniform(-0.3, 0.3)) for k in HL_KEYS[:6]}
        kw["toon_hl_square_sharp"] = float(rng.uniform(0.5, 3.0))
        kw["toon_hl_square_magnitude"] = float(rng.uniform(0.0, 0.5))
        target = lights[i % len(lights)] if i < 10 else -1
        ids.append(b.add_material(
            mt.STYLIZED_BRDF if i % 3 == 2 else mt.TOON,
            base_color=tuple(rng.uniform(0.2, 1.0, 3)),
            roughness=float(rng.uniform(0.15, 0.8)), ior=float(rng.uniform(1.3, 6.0)),
            toon_type=float(i % 2), toon_receive_shadow=float(i % 4 != 3),
            toon_remap_tex=remap if i != 7 else -1, toon_target_light=target,
            toon_rim_enable=float(i % 2 == 0), toon_rim_color=tuple(rng.uniform(0, 1, 3)),
            toon_rim_width=float(rng.uniform(0.1, 0.6)),
            toon_rim_softness=float(rng.uniform(0.1, 0.9)),
            toon_rim_spread=float(rng.uniform(0.5, 1.0)),
            toon_stylized_y_min=float(rng.uniform(0.0, 0.3)),
            toon_stylized_y_max=float(rng.uniform(0.4, 2.0)), **kw))
    return ids


@pytest.fixture(scope="module")
def toon_lab():
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    ids = _populate_toon_lab(jb, MaterialType)
    assert _populate_toon_lab(tb, MaterialType) == ids
    js = jb.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    return js, ts, tb.build("cpu"), ids


def test_bridge_carries_the_toon_scene():
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    tdefs.populate_toon_scene(jb, 16, 16, stylized=True)
    tdefs.populate_toon_scene(tb, 16, 16, stylized=True)
    js = jb.build()
    via = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    own = tb.build("cpu")
    assert via.static == own.static
    assert set(via.arrays) == set(own.arrays) and "tex_stack" in own
    for k, v in own.arrays.items():
        for f, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            other = via[k] if f is None else via[k][f]
            np.testing.assert_array_equal(t.numpy(), other.numpy(), err_msg=f"{k}.{f}")
    m = own["materials"]
    assert m["toon_target_light"][:2].tolist() == [0, 0]
    assert m["toon_remap_tex"][:2].tolist() == [0, 0]
    assert m["type"][:2].tolist() == [int(MaterialType.STYLIZED_BRDF)] * 2


def _lanes(js, ts, ids, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-4, 0, -4], [4, 3, 4], (N, 3)).astype(np.float32)
    ns, rd = _unit(rng, N), _unit(rng, N)
    mtl = rng.choice(ids, N).astype(np.int32)
    seeds = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    occ = rng.random(N) < 0.3
    mat_j = jax_gather(js["materials"], jnp.asarray(mtl))
    mat_t = gather_material(ts["materials"], torch.tensor(mtl))
    return p, ns, rd, seeds, occ, mat_j, mat_t


def test_stylized_half_and_rim_match_reference(toon_lab):
    js, ts, _, ids = toon_lab
    p, ns, rd, _, _, mat_j, mat_t = _lanes(js, ts, ids, 22)
    rng = np.random.default_rng(23)
    wi = _unit(rng, N)
    n = np.where((ns * -rd).sum(1, keepdims=True) < 0, -ns, ns)
    _two_level(ttoon.stylized_half(mat_t, *map(torch.tensor, (n, -rd, wi))),
               jtoon.stylized_half(mat_j, *map(jnp.asarray, (n, -rd, wi))), "stylized_half")
    for a, b, what in zip(ttoon.toon_specular_eval(mat_t, *map(torch.tensor, (n, -rd, wi))),
                          jtoon.toon_specular_eval(mat_j, *map(jnp.asarray, (n, -rd, wi))),
                          ("toon_specular bsdf", "toon_specular pdf")):
        _two_level(a, b, what)
    _two_level(ttoon.rim_light(mat_t, torch.tensor(n), torch.tensor(rd)),
               jtoon.rim_light(mat_j, jnp.asarray(n), jnp.asarray(rd)), "rim_light")


@pytest.mark.parametrize("stylized_lanes", [False, True])
def test_toon_term_matches_reference(toon_lab, stylized_lanes):
    js, ts, own, ids = toon_lab
    p, ns, rd, seeds, occ, mat_j, mat_t = _lanes(js, ts, ids, 24)
    sty = (np.asarray(mat_j["type"]) == int(MaterialType.STYLIZED_BRDF)) & stylized_lanes
    st_j = jsmp.make_state(jnp.asarray(seeds), 2, 3, 16, bounce=1)
    st_t = tsmp.make_state(torch.tensor(seeds.astype(np.int64)), 2, 3, 16, bounce=1)
    calls = {}

    def occ_j(o, d, dist):
        calls["jax"] = (o, d, dist)
        return jnp.asarray(occ)

    def occ_t(o, d, dist):
        calls["torch"] = (o, d, dist)
        return torch.tensor(occ)

    rgb_j, st_j = jtoon.toon_term(js, mat_j, *map(jnp.asarray, (p, ns, rd)), st_j, occ_j,
                                  stylized=jnp.asarray(sty))
    rgb_t, st_t = ttoon.toon_term(ts, mat_t, *map(torch.tensor, (p, ns, rd)), st_t, occ_t,
                                  stylized=torch.tensor(sty))
    np.testing.assert_array_equal(st_t["dim"].numpy(), np.asarray(st_j["dim"]).astype(np.int64))
    for name, a, b in zip(("ro", "rd", "dist"), calls["torch"], calls["jax"]):
        _two_level(a, b, "shadow " + name)
    _two_level(rgb_t, rgb_j, "toon rgb")
    # the port's own build of the same scene gives the same term
    rgb_o, _ = ttoon.toon_term(own, gather_material(own["materials"], torch.tensor(
        np.asarray(mat_j["mtl_id"]))), *map(torch.tensor, (p, ns, rd)),
        tsmp.make_state(torch.tensor(seeds.astype(np.int64)), 2, 3, 16, bounce=1), occ_t,
        stylized=torch.tensor(sty))
    np.testing.assert_array_equal(rgb_o.numpy(), rgb_t.numpy())
    lit = rgb_t.numpy().max(axis=1) > 1e-3
    assert lit.mean() > 0.3


# --- the scene against the reference's render ----------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["toon", "stylized"])
def toon_renders(request):
    """aten_tpu's render of toon_scene(32, 32) at 4 spp, depth 4, and the
    port's scene and camera."""
    jb = JaxSceneBuilder()
    cam = tdefs.populate_toon_scene(jb, 32, 32, stylized=request.param)
    js = jb.build()
    ref = np.asarray(jax_render_image(js, JaxPinholeCamera(**dataclasses.asdict(cam)),
                                      spp=4, max_depth=4))
    return ref, tdefs.toon_scene(32, 32, request.param, device="cpu")


def test_toon_scene_matches_reference(toon_renders):
    ref, (scene, cam) = toon_renders
    img = render_image(scene, cam, spp=4, max_depth=4).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3, (rel > 2e-2).mean()
    assert rel.mean() < 3e-3, rel.mean()
    # both toon spheres are lit, so the toon branch really ran
    assert img[12:20, 4:14].max() > 0.05 and img[12:20, 18:28].max() > 0.05
