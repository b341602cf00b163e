"""aten_tpu_torch's Plücker treelet traversal (kernel K3) against aten_tpu.

* Layout: the port's cut tree, row starts, slot2prim and slot records
  equal aten_tpu's `treelet_cut`, `build_treelet_layout` and the nonzero
  entries of `_build_plucker_emat` on a 2,004-prim knot; the pool rule
  picks K3 exactly where aten_tpu's build and `traverse_pallas` do.
* K3's plain version (impl "plk_plain", and impl "plk", which on the CPU
  is the plain version) against the TPU kernel `_traverse_plk_tiles`
  itself, run in TPU interpret mode on aten_tpu's layout: prim agreement
  >= 0.999; t within rtol = atol = 1e-4 where prims agree (the
  `_check_parity` bounds: surface rays end close to their origin, where
  the cancelling numerator leaves only absolute accuracy); the port's t
  has its 6 low mantissa bits clear; any-hit verdicts equal.  The two
  walk in different orders, so two leaves tied on the truncated t near a
  shared edge may resolve differently, hence agreement and not equality.
* The same rays against the oracle `traverse(impl="jax")` at the
  `_check_parity` bounds, u/v against `_recompute_uv` within 1e-5, and a
  render forced onto K3's plain version against aten_tpu's
  `render_image` within the full-image radiance bounds.
* Rays with a direction component in [-1e-12, 0): K3's safe inverse
  (1e12) and the oracle's (sign(d)*1e12 + 1e12 = 0) differ there; the
  port's K3 follows the TPU kernel, not the oracle.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aten_tpu.accel.traverse import traverse as jax_traverse
from aten_tpu.core import camera as jcam
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.ops import traverse_pallas as jtp
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.ops import bvh_layout, plk_cuda, plk_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.scene import Scene, SceneBuilder, with_plk_layout
from aten_tpu_torch.utils import spans
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

KNOT = {"n_u": 40, "n_v": 25}  # 2,000 knot triangles + 4: 2,004 prims
TILE_ROWS = 16  # the reference's K3 tile height (traverse_pallas.py:340)



def _np(h):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in h.items()}


def _with_plk(scene):
    """`scene` with the Plücker layout of its own BVH attached, as the
    builder attaches it above the pool line."""
    s = with_plk_layout(scene)
    return Scene(s.arrays, {**s.static, "traversal": "plk"}, s.device)


_SETUP = {}


def _setup():
    """(reference SceneData, its treelet layout, the port's scene with the
    Plücker layout, the port's camera) of the 2,004-prim knot."""
    if not _SETUP:
        b = JaxSceneBuilder()
        tcam = tdefs.populate_procedural_mesh_scene(b, 32, 32, **KNOT)
        js = b.build()
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        bvh = {k: np.asarray(js[k]) for k in bridge.BVH_KEYS}
        jl = jtp.build_treelet_layout(bvh, *(np.asarray(js[k]) for k in (
            "tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")), js["num_tris"])
        _SETUP["v"] = (js, jl, _with_plk(ts), tcam)
    return _SETUP["v"]


def _rays(kind):
    """1,024 rays: camera rays through 32x32 pixel centres, rays from
    random surface points in random directions, or axis-aligned rays
    (exact +-0 components, half of them -0.0) from random points."""
    js, _, _, cam = _setup()
    rng = np.random.default_rng({"camera": 0, "surface": 1, "axis": 2}[kind])
    n = 1024
    if kind == "camera":
        lp = np.arange(n)
        jc = jcam.PinholeCamera(**dataclasses.asdict(cam))
        ro, rd = jcam.generate_ray(jc.arrays(), jnp.asarray(((lp % 32) + 0.5) / 32, jnp.float32),
                                   jnp.asarray(((lp // 32) + 0.5) / 32, jnp.float32))
        return np.asarray(ro), np.asarray(rd)
    if kind == "surface":
        tid = rng.integers(0, js["num_tris"], n)
        b = rng.random((n, 2))
        b[b.sum(1) > 1] = 1.0 - b[b.sum(1) > 1]
        v0, e1, e2 = (np.asarray(js[k])[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
        ro = (v0 + b[:, :1] * e1 + b[:, 1:] * e2).astype(np.float32)
        d = rng.standard_normal((n, 3))
        return ro, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rd = np.zeros((n, 3), np.float32)
    rd[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    rd[n // 2:][rd[n // 2:] == 0.0] = -0.0
    ro = rng.uniform([-3.0, -0.5, -3.0], [3.0, 4.0, 3.0], (n, 3)).astype(np.float32)
    return ro, rd


def _reference_k3(ro, rd, t_max=None, any_hit=False, t_min=1e-4):
    """aten_tpu's K3 on its own layout, in TPU interpret mode, with the
    wrapping of traverse_pallas (:2074-2117): 2048-ray tiles, padded rays
    dead, dead any-hit lanes undone, slots through trl_slot2prim.
    Returns (t, prim)."""
    _, jl, _, _ = _setup()
    n = ro.shape[0]
    q = TILE_ROWS * jtp.LANES
    pad = -(-n // q) * q - n
    t0 = np.full(n, 3.4e38, np.float32) if t_max is None else t_max

    def prep(x, fill=0.0):
        return jnp.asarray(np.pad(x, (0, pad), constant_values=fill).reshape(-1, jtp.LANES))

    s2p = jl["trl_slot2prim"]
    ns = s2p.shape[0]
    with pltpu.force_tpu_interpret_mode():
        t, prim = jtp._traverse_plk_tiles(
            jnp.asarray(jl["trl_nodes"]), jnp.asarray(jl["trl_emat"]),
            prep(ro[:, 0]), prep(ro[:, 1]), prep(ro[:, 2]),
            prep(rd[:, 0]), prep(rd[:, 1]), prep(rd[:, 2], 1.0), prep(t0, -1.0),
            any_hit=any_hit, t_min=t_min, tile_rows=TILE_ROWS, n_slots=ns)
    raw = np.asarray(prim).reshape(-1)[:n]
    if any_hit:
        raw = np.where(t0 <= t_min, -1, raw)
    prim = np.where((raw >= 0) & (raw < ns), s2p[np.clip(raw, 0, ns - 1)], -1)
    return np.asarray(t).reshape(-1)[:n], prim


def _port(ro, rd, impl, **kw):
    _, _, ps, _ = _setup()
    kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return _np(ttrav.traverse(ps, torch.tensor(ro), torch.tensor(rd), impl=impl, **kw))


def _dist(n, seed):
    return np.random.default_rng(seed).uniform(0.0, 20.0, n).astype(np.float32)


# -- layout -------------------------------------------------------------------

def test_layout_matches_reference(reference_native):
    js, jl, ps, _ = _setup()
    bvh = {k: np.asarray(js[k]) for k in bridge.BVH_KEYS}
    ref = jtp.treelet_cut(bvh)
    got = plk_layout.treelet_cut(bvh)
    for name, r, g in zip(("bmin", "bmax", "hit", "miss", "start", "count", "keep"), ref, got):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    Kt = got[2].shape[0]
    ints = jl["trl_nodes"][:, 6:22].view(np.int32)
    row_start = ints[:Kt, 12]
    np.testing.assert_array_equal(ps["plk_slot_start"].numpy(),
                                  np.where(row_start >= 0, row_start * plk_layout.PACK, -1))
    np.testing.assert_array_equal(ps["plk_count"].numpy(), ints[:Kt, 13])
    np.testing.assert_array_equal(ps["plk_hit"].numpy(), got[2])
    np.testing.assert_array_equal(ps["plk_slot2prim"].numpy(), jl["trl_slot2prim"])
    # every nonzero entry of each leaf's E block is a field of a slot
    # record (the numerator rows hold -n), and nothing else is nonzero
    E = jl["trl_emat"].reshape(-1, 16, 4 * plk_layout.WINDOW).copy()
    W = plk_layout.WINDOW
    consts = ps["plk_consts"].numpy()
    fat = np.nonzero(ints[:Kt, 15] >= 0)[0]
    assert fat.shape[0] == E.shape[0] > 10
    for n in fat:
        e = E[ints[n, 15]]
        j = np.arange(ints[n, 13])
        rec = consts[row_start[n] * plk_layout.PACK + j]
        fields = [((slice(0, 3), j), rec[:, 0:3]), ((slice(3, 6), j), rec[:, 3:6]),
                  ((slice(0, 3), W + j), rec[:, 6:9]), ((slice(3, 6), W + j), rec[:, 9:12]),
                  ((slice(0, 3), 2 * W + j), rec[:, 12:15]),
                  ((slice(6, 9), 3 * W + j), -rec[:, 12:15]),
                  ((slice(9, 10), 3 * W + j), rec[:, 15:16])]
        for (rows, cols), want in fields:
            np.testing.assert_array_equal(e[rows][:, cols].T, want)
            e[rows, cols] = 0.0
    assert not E.any()
    used = ps["plk_slot2prim"].numpy() >= 0
    assert not consts[~used].any() and used.sum() == js["num_tris"] + js["num_spheres"]


def test_packed_cut_tree_unpacks_bit_for_bit():
    """K3's packed node records (`plk_nodes`) give back the cut tree's
    boxes, links, slot starts and counts bit for bit."""
    _, _, ps, _ = _setup()
    bmin, bmax, hit, miss, _, start, count = bvh_layout.unpack_nodes(
        ps["plk_nodes"].numpy(), shift=bvh_layout.TREELET_LEAF_SHIFT)
    for got, k in ((bmin, "plk_bmin"), (bmax, "plk_bmax")):
        np.testing.assert_array_equal(got.view(np.int32), ps[k].numpy().view(np.int32))
    for got, k in ((hit, "plk_hit"), (miss, "plk_miss"), (start, "plk_slot_start"),
                   (count, "plk_count")):
        np.testing.assert_array_equal(got, ps[k].numpy(), err_msg=k)
    fat = start >= 0
    assert 10 < fat.sum() < fat.shape[0] and (count[fat] <= plk_layout.WINDOW).all()
    assert (start[fat] % plk_layout.PACK == 0).all()


def test_large_mesh_scene_packs_its_cut_tree():
    """The 512,004-prim scene's fat leaves pack into the leaf word (slot
    start < 2^23, count <= 64), and it carries K3's records, not K1's."""
    s, _ = tdefs.large_mesh_scene(8, 8, device="cpu")
    assert s["traversal"] == "plk" and not any(k in s for k in bvh_layout.ARRAY_KEYS)
    _, _, hit, _, _, start, count = bvh_layout.unpack_nodes(
        s["plk_nodes"].numpy(), shift=bvh_layout.TREELET_LEAF_SHIFT)
    np.testing.assert_array_equal(hit, s["plk_hit"].numpy())
    np.testing.assert_array_equal(start, s["plk_slot_start"].numpy())
    np.testing.assert_array_equal(count, s["plk_count"].numpy())
    assert (start.max() + plk_layout.WINDOW <= s["plk_slot2prim"].shape[0]
            < bvh_layout.TREELET_MAX_START)


@pytest.mark.parametrize("n_u,n_v,picks", [(400, 128, False), (1000, 256, True)])
def test_pool_rule_picks_k3_where_reference_does(reference_native, n_u, n_v, picks):
    """aten_tpu's build of the scene and `traverse_pallas`'s rule
    (`trl_emat` present and the pools over 32 MB) against the port's:
    the same pool size and the same choice.  At the default 102,404
    prims the port's build carries nothing new; at 512,004 it carries
    the layout and the statics naming K3."""
    b = JaxSceneBuilder()
    tdefs.populate_procedural_mesh_scene(b, 16, 16, n_u=n_u, n_v=n_v)
    js = b.build()
    ref_mb = (js["trl_nodes"].size + js["trl_prims"].size) * 4e-6
    ref_picks = "trl_emat" in js and ref_mb > 32.0
    assert ref_picks == picks
    tb = SceneBuilder()
    tdefs.populate_procedural_mesh_scene(tb, 16, 16, n_u=n_u, n_v=n_v)
    arrays, static = tb.numpy_arrays()
    bvh = {k: arrays[k] for k in bridge.BVH_KEYS}
    lay = plk_layout.build_plk_layout(bvh, arrays["tri_v0"], arrays["tri_e1"],
                                      arrays["tri_e2"], static["num_tris"])
    assert lay["plk_pool_mb"] == ref_mb
    assert (static.get("traversal") == "plk") == picks
    assert all((k in arrays) == picks for k in plk_layout.ARRAY_KEYS)
    if picks:
        assert static["num_tris"] + static["num_spheres"] == 512004
        assert round(ref_mb, 2) == 46.89 and static["plk_window"] == 64
        np.testing.assert_array_equal(arrays["plk_slot2prim"], js["trl_slot2prim"])
    else:
        assert "plk_window" not in static
        own = tdefs.procedural_mesh_scene(16, 16, n_u=n_u, n_v=n_v, device="cpu")[0]
        assert sorted(own.static) == sorted(bridge.STATIC_KEYS)


def test_large_mesh_scene_runs_k3():
    spans.reset()
    scene, cam = tdefs.large_mesh_scene(16, 16, device="cpu")
    assert scene["num_tris"] + scene["num_spheres"] == 512004
    assert scene["traversal"] == "plk" and scene["num_spheres"] == 0
    ro = torch.tensor(np.tile(np.asarray([[0.0, 4.0, 14.0]], np.float32), (4, 1)))
    rd = torch.nn.functional.normalize(torch.tensor([[0.0, -0.2, -1.0], [0.1, -0.3, -1.0],
                                                     [0.0, 1.0, 0.0], [0.0, -0.25, -1.0]]), dim=1)
    a = ttrav.traverse(scene, ro, rd)
    b = ttrav.traverse(scene, ro, rd, impl="plk_plain")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["hit"].tolist() == [True, True, False, True]
    assert not [k for k in spans.counters() if k.startswith("launch.")]


# -- traversal ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["camera", "surface", "axis"])
def test_k3_matches_reference_kernel(reference_native, kind):
    ro, rd = _rays(kind)
    ref_t, ref_p = _reference_k3(ro, rd)
    got = _port(ro, rd, "plk")
    assert (got["prim"] == ref_p).mean() >= 0.999, (got["prim"] == ref_p).mean()
    m = (ref_p >= 0) & (got["prim"] == ref_p)
    assert m.mean() > 0.3
    np.testing.assert_allclose(got["t"][m], ref_t[m], rtol=1e-4, atol=1e-4)
    assert (got["t"][got["hit"]].view(np.int32) & 63 == 0).all()
    np.testing.assert_array_equal(got["hit"], got["prim"] >= 0)

    dist = _dist(ro.shape[0], 3)
    dist[::9] = 0.0  # dead lanes
    _, ref_a = _reference_k3(ro, rd, t_max=dist, any_hit=True, t_min=1e-3)
    got_a = _port(ro, rd, "plk", t_max=dist, any_hit=True, t_min=1e-3)
    np.testing.assert_array_equal(got_a["hit"], ref_a >= 0)
    assert 0.05 < got_a["hit"].mean() < 0.95
    assert not got_a["hit"][::9].any() and (got_a["u"] == 0).all()


@pytest.mark.parametrize("kind", ["camera", "surface", "axis"])
def test_k3_matches_oracle(reference_native, kind):
    js, _, _, _ = _setup()
    ro, rd = _rays(kind)
    ref = _np(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax"))
    got = _port(ro, rd, "plk_plain")
    assert (got["prim"] == ref["prim"]).mean() >= 0.999
    m = (ref["prim"] >= 0) & (got["prim"] == ref["prim"])
    np.testing.assert_allclose(got["t"][m], ref["t"][m], rtol=1e-4, atol=1e-4)

    dist = _dist(ro.shape[0], 4)
    ref_a = np.asarray(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), t_max=jnp.asarray(dist),
                                    any_hit=True, t_min=1e-3, impl="jax")["hit"])
    got_a = _port(ro, rd, "plk_plain", t_max=dist, any_hit=True, t_min=1e-3)
    np.testing.assert_array_equal(got_a["hit"], ref_a)
    _, _, ps, _ = _setup()
    occ = ttrav.occluded(ps, torch.tensor(ro), torch.tensor(rd), torch.tensor(dist),
                         impl="plk").numpy()
    occ_ref = ttrav.occluded(ps, torch.tensor(ro), torch.tensor(rd), torch.tensor(dist),
                             impl="plain").numpy()
    np.testing.assert_array_equal(occ, occ_ref)


@pytest.mark.parametrize("kind", ["camera", "surface"])
def test_recompute_uv_matches_reference(reference_native, kind):
    js, _, ps, _ = _setup()
    ro, rd = _rays(kind)
    got = _port(ro, rd, "plk")
    ref_u, ref_v = jtp._recompute_uv(js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(got["prim"]))
    np.testing.assert_allclose(got["u"], np.asarray(ref_u), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["v"], np.asarray(ref_v), rtol=0, atol=1e-5)
    assert (got["u"][~got["hit"]] == 0).all() and got["hit"].mean() > 0.3
    # the winner's u/v are those the oracle walk computes for that prim
    plain = _np(ttrav.traverse(ps, torch.tensor(ro), torch.tensor(rd), impl="plain"))
    same = plain["prim"] == got["prim"]
    np.testing.assert_array_equal(got["u"][same], plain["u"][same])
    np.testing.assert_array_equal(got["v"][same], plain["v"][same])


def test_tiny_negative_components_follow_the_reference_kernel(reference_native):
    """Direction components of -1e-13: K3's safe inverse gives 1e12, the
    oracle's 0, which empties every slab, so the oracle misses all these
    rays.  The port's K3 returns the TPU kernel's hits."""
    ro, rd = _rays("axis")
    rd = np.where(rd == 0.0, np.float32(-1e-13), rd).astype(np.float32)
    _, ref_p = _reference_k3(ro, rd)
    got = _port(ro, rd, "plk")
    assert (got["prim"] == ref_p).mean() >= 0.999 and got["hit"].mean() > 0.2
    js, _, _, _ = _setup()
    oracle = np.asarray(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax")["hit"])
    assert not oracle.any()
    np.testing.assert_array_equal(_port(ro, rd, "plain")["hit"], oracle)


def test_plain_stats_count_the_work(reference_native):
    _, _, ps, _ = _setup()
    ro, rd = (torch.tensor(a) for a in _rays("surface"))
    t0 = torch.full((ro.shape[0],), 3.4e38)
    h = ttrav._traverse_plk_plain(ps, ro, rd, t0, False, 1e-4)
    h2, st = ttrav._traverse_plk_plain(ps, ro, rd, t0, False, 1e-4, stats=True)
    for k in h:
        assert torch.equal(h[k], h2[k]), k
    assert st["node_steps"] >= ro.shape[0]
    assert int(h["prim"].ge(0).sum()) <= st["leaves"] <= st["node_steps"]
    assert st["leaves"] < st["slot_tests"] <= plk_layout.WINDOW * st["leaves"]


def test_leaf_chunks_change_nothing(reference_native, monkeypatch):
    """The plain leaf test takes (lane, slot) pairs in chunks; a chunk of
    one lane gives the same result."""
    _, _, ps, _ = _setup()
    ro, rd = (torch.tensor(a) for a in _rays("camera"))
    t0 = torch.full((ro.shape[0],), 3.4e38)
    a = ttrav._traverse_plk_plain(ps, ro, rd, t0, False, 1e-4)
    monkeypatch.setattr(ttrav, "_PLK_PAIRS", plk_layout.WINDOW)
    b = ttrav._traverse_plk_plain(ps, ro, rd, t0, False, 1e-4)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- dispatch, the wrapper and the slice -------------------------------------------

def test_dispatch(reference_native):
    """impl "auto" takes K3 on a scene that names it; "plk" and
    "plk_plain" need the layout; the wrapper's CPU path is the plain
    version and counts no launch."""
    spans.reset()
    js, _, ps, _ = _setup()
    ro, rd = (torch.tensor(a) for a in _rays("surface"))
    auto = ttrav.traverse(ps, ro, rd)
    forced = ttrav.traverse(ps, ro, rd, impl="plk_plain")
    for k in auto:
        assert torch.equal(auto[k], forced[k]), k
    for any_hit in (False, True):
        t0 = torch.full((ro.shape[0],), 7.5)
        t, prim = plk_cuda.plk_traverse(ps, ro, rd, t0, any_hit=any_hit)
        h = ttrav._traverse_plk_plain(ps, ro, rd, t0, any_hit, 1e-4)
        assert torch.equal(t, h["t"]) and torch.equal(prim, h["prim"])
    assert not [k for k in spans.counters() if k.startswith("launch.")]
    plain = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    for impl in ("plk", "plk_plain"):
        with pytest.raises(ValueError, match="Plücker layout"):
            ttrav.traverse(plain, ro, rd, impl=impl)


def test_wrapper_rejects_bad_arguments(reference_native):
    _, _, ps, _ = _setup()
    ro, rd = (torch.tensor(a[:64]) for a in _rays("surface"))
    t0 = torch.full((64,), 5.0)
    with pytest.raises(ValueError, match="ro"):
        plk_cuda.plk_traverse(ps, ro.double(), rd, t0)
    with pytest.raises(ValueError, match="contiguous"):
        plk_cuda.plk_traverse(ps, ro, rd.t().contiguous().t(), t0)
    with pytest.raises(ValueError, match="differ"):
        plk_cuda.plk_traverse(ps, ro, rd, t0[:10])
    with pytest.raises(ValueError, match="unsupported device"):
        plk_cuda.plk_traverse(ps, ro.to("meta"), rd.to("meta"), t0.to("meta"))
    bad = Scene({**ps.arrays, "plk_nodes": ps["plk_nodes"].double()}, ps.static, ps.device)
    with pytest.raises(ValueError, match="plk_nodes"):
        plk_cuda.plk_traverse(bad, ro, rd, t0)
    bad = Scene({**ps.arrays, "plk_consts": ps["plk_consts"][:, :12].contiguous()},
                ps.static, ps.device)
    with pytest.raises(ValueError, match="plk_consts"):
        plk_cuda.plk_traverse(bad, ro, rd, t0)
    bad = Scene(ps.arrays, {**ps.static, "plk_window": 256}, ps.device)
    with pytest.raises(ValueError, match="window"):
        plk_cuda.plk_traverse(bad, ro, rd, t0)


def _image_bounds(img, ref):
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    return (rel > 2e-2).mean(), rel.mean()


def test_render_on_k3_matches_reference(reference_native):
    """The slice at a reduced size: the 2,004-prim knot at 48x48, 4 spp,
    depth 3, every traversal forced onto K3's plain version, against
    aten_tpu's render_image of the same scene, within the full-image
    radiance bounds; impl "plk" (the wrapper, on the CPU its plain
    version) renders the same image."""
    js, _, ps, cam = _setup()
    tcam = dataclasses.replace(cam, width=48, height=48)
    ref = np.asarray(jax_render_image(
        js, jcam.PinholeCamera(**dataclasses.asdict(tcam)), spp=4, max_depth=3))
    img = render_image(ps, tcam, spp=4, max_depth=3, impl="plk_plain").numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    frac, mean_rel = _image_bounds(img, ref)
    assert frac < 5e-3, frac
    assert mean_rel < 3e-3, mean_rel
    small = dataclasses.replace(tcam, width=16, height=16)
    np.testing.assert_array_equal(
        render_image(ps, small, spp=2, max_depth=3, impl="plk").numpy(),
        render_image(ps, small, spp=2, max_depth=3, impl="plk_plain").numpy())


def test_entry_points_default_to_the_card():
    """The entry points build on "cuda" unless told otherwise, and that
    raises without a card instead of dropping to the CPU."""
    for fn in (tdefs.cornell_box, tdefs.procedural_mesh_scene,
               tdefs.instanced_mesh_scene, tdefs.large_mesh_scene, SceneBuilder.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tdefs.cornell_box(8, 8)
