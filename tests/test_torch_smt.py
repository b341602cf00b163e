"""aten_tpu_torch's multi-chain treelet traversal (kernel K4) against aten_tpu.

* Layout: the port's direction-ordered links equal `_directional_links`
  exactly, and its node and slot records equal the lanes of
  `build_treelet_layout`'s `trl_nodes` and `trl_prims` bit for bit, on a
  2,004-prim knot and on the Cornell box, whose leaves hold spheres
  (the layout built directly, as tests/test_torch_plk.py does); the
  treelet rule picks exactly the scenes aten_tpu's build gives
  `trl_nodes`.
* K4's plain version (impl "smt_plain", and impl "smt", which on the CPU
  is the plain version) against the TPU kernel `_traverse_smt_tiles`
  itself, run in TPU interpret mode on aten_tpu's layout, resident and
  streamed, at C = 2 and 4: prim agreement >= 0.999, because a TPU tile
  picks one link ordering for its 1024 rays and the port one per ray,
  so two prims at the same t may be found in another order; t within
  rtol = atol = 1e-4 where prims agree; any-hit verdicts equal.
* The same rays against the oracle `traverse(impl="jax")` at the
  `_check_parity` bounds (prim agreement >= 0.999, t within 1e-4), a
  render forced onto K4's plain version against aten_tpu's
  `render_image` within the full-image radiance bounds, and the kernel
  policy's dispatch.
* Rays with a direction component in [-1e-12, 0): K4's safe inverse
  (1e12) and the oracle's (0) differ there; the port's K4 follows the
  TPU kernel, not the oracle.
"""
import dataclasses
import inspect
import os
import subprocess
import sys

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
from aten_tpu.scene import scenedefs as jdefs
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.ops import plk_cuda, plk_layout, smt_cuda, traverse_cuda, trl_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.scene import Scene, SceneBuilder, with_trl_layout
from aten_tpu_torch.utils import spans
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT = {"n_u": 40, "n_v": 25}  # 2,000 knot triangles + 4: 2,004 prims
LAYOUT_ARGS = ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")



def _np(h):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in h.items()}


def _with_trl(scene, traversal="smt"):
    """`scene` with the treelet layout of its own BVH attached and the
    static naming K4, as the builder attaches it under the policy smt."""
    s = with_trl_layout(scene)
    assert "traversal" not in s and s["trl_window"] == trl_layout.WINDOW
    return Scene(s.arrays, {**s.static, "traversal": traversal}, s.device)


_SETUP = {}


def _setup(name):
    """(reference SceneData, its treelet layout, the port's scene with the
    K4 layout, the port's camera) of the 2,004-prim knot or the Cornell
    box."""
    if name not in _SETUP:
        if name == "knot":
            b = JaxSceneBuilder()
            tcam = tdefs.populate_procedural_mesh_scene(b, 32, 32, **KNOT)
            js = b.build()
        else:
            js, _ = jdefs.cornell_box(32, 32)
            tcam = tdefs.cornell_box(32, 32, device="cpu")[1]
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        bvh = {k: np.asarray(js[k]) for k in bridge.BVH_KEYS}
        jl = jtp.build_treelet_layout(bvh, *(np.asarray(js[k]) for k in LAYOUT_ARGS),
                                      js["num_tris"])
        _SETUP[name] = (js, jl, _with_trl(ts), tcam)
    return _SETUP[name]


def _rays(kind, name="knot", n=1024):
    """n rays: camera rays through pixel centres, rays from random
    surface points in random directions, or axis-aligned rays (exact
    +-0 components, half of them -0.0) from random points."""
    js, _, _, cam = _setup(name)
    rng = np.random.default_rng({"camera": 0, "surface": 1, "axis": 2}[kind])
    if kind == "camera":
        lp = np.arange(n)
        jc = jcam.PinholeCamera(**dataclasses.asdict(cam))
        w = cam.width
        ro, rd = jcam.generate_ray(
            jc.arrays(), jnp.asarray(((lp % w) + 0.5) / w, jnp.float32),
            jnp.asarray((((lp // w) % cam.height) + 0.5) / cam.height, jnp.float32))
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
    lo, hi = ([-3.0, -0.5, -3.0], [3.0, 4.0, 3.0]) if name == "knot" else ([-1, 0, -1], [1, 2, 1])
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return ro, rd


def _reference_k4(name, ro, rd, chains, resident, t_max=None, any_hit=False, t_min=1e-4):
    """aten_tpu's K4 on its own layout, in TPU interpret mode, with the
    wrapping of traverse_pallas (:2063-2064, :2079-2151): C*1024-ray
    tiles, padded rays dead, dead any-hit lanes undone.  (t, prim)."""
    js, jl, _, _ = _setup(name)
    n = ro.shape[0]
    q = jtp.TILE * chains
    pad = -(-n // q) * q - n
    t0 = np.full(n, 3.4e38, np.float32) if t_max is None else t_max

    def prep(x, fill=0.0):
        return jnp.asarray(np.pad(x, (0, pad), constant_values=fill).reshape(-1, jtp.LANES))

    with pltpu.force_tpu_interpret_mode():
        t, prim = jtp._traverse_smt_tiles(
            jnp.asarray(jl["trl_nodes"]), jnp.asarray(jl["trl_prims"]),
            prep(ro[:, 0]), prep(ro[:, 1]), prep(ro[:, 2]),
            prep(rd[:, 0]), prep(rd[:, 1]), prep(rd[:, 2], 1.0), prep(t0, -1.0),
            any_hit=any_hit, t_min=t_min, has_spheres=js["num_spheres"] > 0,
            resident=resident, chains=chains)
    prim = np.asarray(prim).reshape(-1)[:n]
    if any_hit:
        prim = np.where(t0 <= t_min, -1, prim)
    return np.asarray(t).reshape(-1)[:n], prim


def _port(name, ro, rd, impl, **kw):
    _, _, ps, _ = _setup(name)
    kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return _np(ttrav.traverse(ps, torch.tensor(ro), torch.tensor(rd), impl=impl, **kw))


def _dist(n, seed):
    return np.random.default_rng(seed).uniform(0.0, 20.0, n).astype(np.float32)


# -- layout -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["knot", "cornell"])
def test_directional_links_match_reference(reference_native, name):
    js, jl, ps, _ = _setup(name)
    bvh = {k: np.asarray(js[k]) for k in bridge.BVH_KEYS}
    bmin, bmax, hit, miss, start, _, _ = plk_layout.treelet_cut(bvh)
    cent = (bmin + bmax) * np.float32(0.5)
    want = jtp._directional_links(cent, hit, miss, start)
    got = trl_layout.directional_links(cent, hit, miss, start)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    Kt = hit.shape[0]
    ints = jl["trl_nodes"][:, 6:22].view(np.int32)
    np.testing.assert_array_equal(ps["trl_links"].numpy(), ints[:Kt, 0:12])
    if name == "knot":  # the orderings differ somewhere on a real tree
        assert Kt > 50 and len({got[o].tobytes() for o in range(6)}) == 6


@pytest.mark.parametrize("name", ["knot", "cornell"])
def test_records_match_reference(reference_native, name):
    js, jl, ps, _ = _setup(name)
    nodes = ps["trl_nodes"].numpy()
    Kt = nodes.shape[0]
    ints = jl["trl_nodes"][:, 6:22].view(np.int32)
    np.testing.assert_array_equal(nodes[:, 0:6], jl["trl_nodes"][:Kt, 0:6])
    ni = nodes[:, 6:8].view(np.int32)
    np.testing.assert_array_equal(ni[:, 0], np.where(ints[:Kt, 12] >= 0,
                                                     ints[:Kt, 12] * plk_layout.PACK, -1))
    np.testing.assert_array_equal(ni[:, 1], ints[:Kt, 13])
    slots = jl["trl_prims"].reshape(-1, plk_layout.PACK, 16)[:, :, :11].reshape(-1, 11)
    recs = ps["trl_recs"].numpy()
    assert recs.shape == (slots.shape[0], trl_layout.RECORD)
    np.testing.assert_array_equal(recs[:, :11].view(np.int32), slots.view(np.int32))
    assert not recs[:, 11].any()
    pid = recs[:, 9].view(np.int32)
    is_tri = recs[:, 10].view(np.int32)
    n_prims = js["num_tris"] + js["num_spheres"]
    assert sorted(pid[is_tri == 1].tolist() + pid[(is_tri == 0) & (pid > 0)].tolist()
                  + [0] * int(js["num_tris"] == 0)) == list(range(n_prims))
    if name == "cornell":
        assert js["num_spheres"] == 2 and (pid[is_tri == 0] >= js["num_tris"]).sum() == 2


@pytest.mark.parametrize("n_u,n_v,instanced,treelet", [
    (40, 25, False, False), (64, 48, False, False), (64, 50, False, True),
    (24, 12, True, False)])
def test_uses_trl_matches_reference_build(reference_native, monkeypatch, n_u, n_v, instanced,
                                         treelet):
    """aten_tpu's build gives a scene `trl_nodes` exactly where the
    port's rule holds and its build under the policy smt attaches the K4
    layout; under the default policy it attaches none."""
    jb = JaxSceneBuilder()
    fill = tdefs.populate_instanced_mesh_scene if instanced else tdefs.populate_procedural_mesh_scene
    fill(jb, 16, 16, n_u=n_u, n_v=n_v)
    js = jb.build()
    assert ("trl_nodes" in js) == treelet
    built = {}
    for policy in ("v3", "smt"):
        monkeypatch.setattr(ttrav, "KERNEL", policy)
        tb = SceneBuilder()
        fill(tb, 16, 16, n_u=n_u, n_v=n_v)
        built[policy] = tb.numpy_arrays()
    arrays, static = built["smt"]
    if instanced:
        n_nodes, n_prims = arrays["tl_hit"].shape[0], arrays["tl_prim_order"].shape[0]
    else:
        n_nodes, n_prims = arrays["nodes_hit"].shape[0], arrays["prim_order"].shape[0]
    assert trl_layout.uses_trl(n_nodes, n_prims, static["num_instances"]) == treelet
    assert all((k in arrays) == treelet for k in trl_layout.ARRAY_KEYS)
    assert (static.get("trl_window") == trl_layout.WINDOW) == treelet
    assert static.get("traversal") == ("smt" if treelet else None)
    arrays, static = built["v3"]  # the default policy runs K1 on these
    assert not any(k in arrays for k in trl_layout.ARRAY_KEYS)
    assert "traversal" not in static and "trl_window" not in static


# -- traversal ------------------------------------------------------------------

@pytest.mark.parametrize("kind,chains,resident", [
    ("camera", 2, True), ("surface", 4, False), ("axis", 2, False), ("surface", 2, True)])
def test_k4_matches_reference_kernel(reference_native, kind, chains, resident):
    ro, rd = _rays(kind)
    ref_t, ref_p = _reference_k4("knot", ro, rd, chains, resident)
    got = _port("knot", ro, rd, "smt")
    assert (got["prim"] == ref_p).mean() >= 0.999, (got["prim"] == ref_p).mean()
    m = (ref_p >= 0) & (got["prim"] == ref_p)
    assert m.mean() > 0.3
    np.testing.assert_allclose(got["t"][m], ref_t[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["hit"], got["prim"] >= 0)

    dist = _dist(ro.shape[0], 3)
    dist[::9] = 0.0  # dead lanes
    _, ref_a = _reference_k4("knot", ro, rd, chains, resident, t_max=dist, any_hit=True,
                             t_min=1e-3)
    got_a = _port("knot", ro, rd, "smt", t_max=dist, any_hit=True, t_min=1e-3)
    np.testing.assert_array_equal(got_a["hit"], ref_a >= 0)
    assert 0.05 < got_a["hit"].mean() < 0.95
    assert not got_a["hit"][::9].any() and (got_a["u"] == 0).all()


def test_k4_matches_reference_kernel_with_spheres(reference_native):
    """4,096 rays through the Cornell box (two spheres, one fat leaf),
    C = 4, resident: closest prims and any-hit verdicts."""
    ro, rd = _rays("axis", "cornell", n=4096)
    rng = np.random.default_rng(7)
    d = rng.standard_normal((4096, 3))
    rd[::2] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)[::2]
    ref_t, ref_p = _reference_k4("cornell", ro, rd, 4, True)
    got = _port("cornell", ro, rd, "smt_plain")
    assert (got["prim"] == ref_p).mean() >= 0.999
    js, _, _, _ = _setup("cornell")
    assert (ref_p >= js["num_tris"]).sum() > 50  # sphere hits
    m = (ref_p >= 0) & (got["prim"] == ref_p)
    np.testing.assert_allclose(got["t"][m], ref_t[m], rtol=1e-4, atol=1e-4)
    dist = _dist(4096, 4)
    _, ref_a = _reference_k4("cornell", ro, rd, 4, True, t_max=dist, any_hit=True, t_min=1e-3)
    got_a = _port("cornell", ro, rd, "smt_plain", t_max=dist, any_hit=True, t_min=1e-3)
    np.testing.assert_array_equal(got_a["hit"], ref_a >= 0)


@pytest.mark.parametrize("name,kind", [("knot", "camera"), ("knot", "surface"),
                                       ("knot", "axis"), ("cornell", "axis")])
def test_k4_matches_oracle(reference_native, name, kind):
    js, _, ps, _ = _setup(name)
    ro, rd = _rays(kind, name)
    ref = _np(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax"))
    got = _port(name, ro, rd, "smt_plain")
    assert (got["prim"] == ref["prim"]).mean() >= 0.999
    m = (ref["prim"] >= 0) & (got["prim"] == ref["prim"])
    np.testing.assert_allclose(got["t"][m], ref["t"][m], rtol=1e-4, atol=1e-4)
    # u/v of a shared winner are those the port's oracle walk computes
    # (JAX on the CPU contracts FMAs, so against it they are ulp-close)
    plain = _port(name, ro, rd, "plain")
    same = plain["prim"] == got["prim"]
    np.testing.assert_array_equal(got["u"][same], plain["u"][same])
    np.testing.assert_array_equal(got["v"][same], plain["v"][same])

    dist = _dist(ro.shape[0], 4)
    ref_a = np.asarray(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), t_max=jnp.asarray(dist),
                                    any_hit=True, t_min=1e-3, impl="jax")["hit"])
    got_a = _port(name, ro, rd, "smt_plain", t_max=dist, any_hit=True, t_min=1e-3)
    np.testing.assert_array_equal(got_a["hit"], ref_a)
    occ = ttrav.occluded(ps, torch.tensor(ro), torch.tensor(rd), torch.tensor(dist),
                         impl="smt").numpy()
    np.testing.assert_array_equal(occ, got_a["hit"])


def test_tiny_negative_components_follow_the_reference_kernel(reference_native):
    """Direction components of -1e-13: K4's safe inverse gives 1e12, the
    oracle's 0, which empties every slab, so the oracle misses all these
    rays.  The port's K4 returns the TPU kernel's hits."""
    ro, rd = _rays("axis")
    rd = np.where(rd == 0.0, np.float32(-1e-13), rd).astype(np.float32)
    _, ref_p = _reference_k4("knot", ro, rd, 2, True)
    got = _port("knot", ro, rd, "smt")
    assert (got["prim"] == ref_p).mean() >= 0.999 and got["hit"].mean() > 0.2
    js, _, _, _ = _setup("knot")
    oracle = np.asarray(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax")["hit"])
    assert not oracle.any()


def test_pick_ordering_rule():
    rd = torch.tensor([[1.0, 1.0, 1.0], [-2.0, 1.0, 1.0], [-0.0, 0.5, 0.5], [0.1, -0.5, 0.5],
                       [0.1, 0.2, -0.3], [0.0, 0.0, -0.0], [-0.0, 0.0, 0.0]])
    assert ttrav.pick_ordering(rd).tolist() == [0, 1, 2, 3, 5, 0, 0]
    rng = np.random.default_rng(3)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    for r in d:  # one ray per tile: the reference's tile rule on one ray
        want = int(jtp._pick_ordering(*(jnp.asarray(r[i:i + 1]) for i in range(3))))
        assert ttrav.pick_ordering(torch.tensor(r[None]))[0].item() == want


class _Chain:
    def __init__(self, ray, t0, t_min):
        self.ray, self.t, self.prim = ray, t0, -1
        self.cur = 0 if t0 > t_min else -1
        self.pend = self.next = None  # latched fat leaves (slot start, count)
        self.tested = False


def _k4_schedule(scene, ro, rd, t0, any_hit, t_min, chains, drain_first=False):
    """The redesigned K4's schedule (kernels/smt_traverse.cu) for one lane
    holding `chains` rays, in Python over the plain version's own box and
    leaf tests (`_slab_hit`, `_trl_leaves`): each chain steps until its
    step must drain the leaf latched on the step before, which it does
    after that step's box test; then the latched leaves drain and the
    waiting steps end.  `drain_first` drains before the box test
    instead.  Returns (t, prim, box tests)."""
    nodes, links, recs = scene["trl_nodes"], scene["trl_links"], scene["trl_recs"]
    ints = nodes.view(torch.int32)
    inv = ttrav._plk_safe_inv(rd)
    order2 = 2 * ttrav.pick_ordering(rd)
    t_out, p_out = t0.clone(), torch.full(t0.shape, -1, dtype=torch.int32)
    queue, lane, boxes = list(range(ro.shape[0]))[::-1], [None] * chains, 0

    def drain(h):
        ss, cnt = (torch.tensor([x]) for x in h.pend)
        tn, pn = ttrav._trl_leaves(recs, ss, cnt, ro[h.ray:h.ray + 1], rd[h.ray:h.ray + 1],
                                   h.t.view(1), t_min)
        if int(pn[0]) >= 0:
            h.t, h.prim = tn[0], int(pn[0])

    while True:
        for c in range(chains):
            if lane[c] is None and queue:
                i = queue.pop()
                lane[c] = _Chain(i, t0[i], t_min)
        live = [h for h in lane if h is not None]
        if not live:
            break
        while True:  # step the chains until each waits for a drain or has ended
            walking = [h for h in live if h.cur >= 0 and not h.tested]
            if not walking:
                break
            for h in walking:
                if drain_first and h.pend is not None:
                    drain(h)
                    h.pend = None
                k, i = h.cur, h.ray
                boxes += 1
                hitv = (not any_hit or h.prim < 0) and bool(ttrav._slab_hit(
                    nodes[k:k + 1, 0:3], nodes[k:k + 1, 3:6], ro[i:i + 1], inv[i:i + 1],
                    h.t.view(1))[0])
                ss = int(ints[k, 6])
                latch = (ss, int(ints[k, 7])) if hitv and ss >= 0 else None
                h.cur = int(links[k, order2[i] + (0 if hitv else 1)])
                if h.pend is None:
                    h.pend = latch
                    if any_hit and h.prim >= 0:
                        h.cur = -1
                else:
                    h.next, h.tested = latch, True
        for h in live:  # the drains, then the rest of the waiting steps
            if h.pend is not None and (h.tested or h.cur < 0):
                drain(h)
                h.pend = h.next if h.tested else None
                h.next, h.tested = None, False
                if any_hit and h.prim >= 0:
                    h.cur = -1
        for c, h in enumerate(lane):
            if h is not None and h.cur < 0 and h.pend is None:
                t_out[h.ray], p_out[h.ray] = h.t, h.prim
                lane[c] = None
    return t_out, p_out, boxes


@pytest.mark.parametrize("chains", [1, 3])
def test_k4_schedule_keeps_the_step_order(reference_native, chains):
    """The redesigned K4's schedule gives the plain version's t and prim
    bit for bit and tests the same boxes (its node steps), closest-hit and
    any-hit.  The rewrite that drains before the box test does not: on
    these surface rays it tests other boxes (closest-hit) and picks
    another any-hit winner.  On the card chip_smoke.py holds the kernel
    itself bitwise to the plain version."""
    _, _, ps, _ = _setup("knot")
    ro, rd = (torch.tensor(a) for a in _rays("surface"))
    for any_hit, rays, t_min in ((False, slice(0, 400), 1e-4), (True, slice(800, 960), 1e-3)):
        r, d = ro[rays], rd[rays]
        t0 = torch.full((r.shape[0],), 3.4e38)
        h, st = ttrav._traverse_trl_plain(ps, r, d, t0, any_hit, t_min, stats=True)
        t, prim, boxes = _k4_schedule(ps, r, d, t0, any_hit, t_min, chains)
        assert torch.equal(t, h["t"]) and torch.equal(prim, h["prim"]), any_hit
        assert boxes == st["node_steps"], (boxes, st)
        t, prim, boxes = _k4_schedule(ps, r, d, t0, any_hit, t_min, chains, drain_first=True)
        if any_hit:
            assert not torch.equal(prim, h["prim"])
        else:
            assert boxes != st["node_steps"]


def test_plain_stats_count_the_work(reference_native):
    _, _, ps, _ = _setup("knot")
    ro, rd = (torch.tensor(a) for a in _rays("surface"))
    t0 = torch.full((ro.shape[0],), 3.4e38)
    h = ttrav._traverse_trl_plain(ps, ro, rd, t0, False, 1e-4)
    h2, st = ttrav._traverse_trl_plain(ps, ro, rd, t0, False, 1e-4, stats=True)
    for k in h:
        assert torch.equal(h[k], h2[k]), k
    assert st["node_steps"] >= ro.shape[0]
    assert int(h["prim"].ge(0).sum()) <= st["leaves"] <= st["node_steps"]
    assert st["leaves"] < st["slot_tests"] <= trl_layout.WINDOW * st["leaves"]


def test_leaf_chunks_change_nothing(reference_native, monkeypatch):
    """The plain leaf test takes (lane, slot) pairs in chunks; a chunk of
    one lane gives the same result."""
    _, _, ps, _ = _setup("knot")
    ro, rd = (torch.tensor(a) for a in _rays("camera"))
    t0 = torch.full((ro.shape[0],), 3.4e38)
    a = ttrav._traverse_trl_plain(ps, ro, rd, t0, False, 1e-4)
    monkeypatch.setattr(ttrav, "_PLK_PAIRS", trl_layout.WINDOW)
    b = ttrav._traverse_trl_plain(ps, ro, rd, t0, False, 1e-4)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the kernel policy, the wrapper and the slice ----------------------------------

class _Spy:
    """Records which kernel wrapper `traverse` reached, then runs it."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, fn in ((traverse_cuda, "bvh_traverse"), (plk_cuda, "plk_traverse"),
                        (smt_cuda, "smt_traverse")):
            real = getattr(mod, fn)

            def spy(*a, _real=real, _fn=fn, **kw):
                self.calls.append((_fn, kw.get("chains")))
                return _real(*a, **kw)

            monkeypatch.setattr(mod, fn, spy)


@pytest.mark.parametrize("policy,scene,kernel", [
    ("v3", "mesh102k", "bvh_traverse"), ("smt", "mesh102k", "smt_traverse"),
    ("plk", "mesh102k", "plk_traverse"), ("mt", "mesh102k", "bvh_traverse"),
    ("smt", "mesh512k", "smt_traverse"), ("mt", "mesh512k", "bvh_traverse")])
def test_kernel_policy_dispatch(monkeypatch, policy, scene, kernel):
    """Each value of ATEN_TPU_KERNEL builds the layouts its kernel needs
    and `traverse(impl="auto")` reaches that kernel: v3 and mt K1 (K3 is
    the v3 choice over the pool line, tests/test_torch_plk.py), smt K4
    at ATEN_TPU_CHAINS rays per lane, plk K3 below the line too."""
    monkeypatch.setattr(ttrav, "KERNEL", policy)
    monkeypatch.setattr(ttrav, "CHAINS", 8)
    fn = tdefs.procedural_mesh_scene if scene == "mesh102k" else tdefs.large_mesh_scene
    s, _ = fn(8, 8, device="cpu")
    k4 = kernel == "smt_traverse"  # only K4's policy builds K4's layout
    assert ("trl_nodes" in s) == k4 and (s.get("trl_window") == trl_layout.WINDOW) == k4
    assert s.get("traversal") == {"smt_traverse": "smt", "plk_traverse": "plk"}.get(kernel)
    assert ("plk_consts" in s) == (kernel == "plk_traverse")
    spy = _Spy(monkeypatch)
    ro = torch.tensor([[0.0, 4.0, 14.0]] * 3)
    rd = torch.nn.functional.normalize(torch.tensor([[0.0, -0.2, -1.0], [0.0, 1.0, 0.0],
                                                     [0.05, -0.25, -1.0]]), dim=1)
    h = ttrav.traverse(s, ro, rd)
    assert h["hit"].tolist() == [True, False, True]
    assert ttrav.occluded(s, ro, rd, torch.full((3,), 100.0)).tolist() == [True, False, True]
    want = (kernel, 8 if kernel == "smt_traverse" else None)
    assert spy.calls == [want, want]


def test_kernel_policy_is_read_once_at_import():
    """The constants come from the environment when accel/traverse.py is
    imported; a value the port does not know raises there."""
    code = ("import sys; sys.path.insert(0, %r); from aten_tpu_torch.accel import traverse; "
            "print(traverse.KERNEL, traverse.CHAINS)" % ROOT)
    env = {**os.environ, "ATEN_TPU_KERNEL": "smt", "ATEN_TPU_CHAINS": "2"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["smt", "2"], out.stderr[-2000:]
    env["ATEN_TPU_KERNEL"] = "v4"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "ROADMAP" in out.stderr and "'v4'" in out.stderr


def test_dispatch_needs_the_layout(reference_native):
    spans.reset()
    js, _, ps, _ = _setup("knot")
    ro, rd = (torch.tensor(a) for a in _rays("surface"))
    auto = ttrav.traverse(ps, ro, rd)
    forced = ttrav.traverse(ps, ro, rd, impl="smt_plain")
    for k in auto:
        assert torch.equal(auto[k], forced[k]), k
    for any_hit in (False, True):
        t0 = torch.full((ro.shape[0],), 7.5)
        for c in smt_cuda.CHAIN_COUNTS:
            t, prim = smt_cuda.smt_traverse(ps, ro, rd, t0, any_hit=any_hit, chains=c)
            h = ttrav._traverse_trl_plain(ps, ro, rd, t0, any_hit, 1e-4)
            assert torch.equal(t, h["t"]) and torch.equal(prim, h["prim"])
    assert not [k for k in spans.counters() if k.startswith("launch.")]
    plain = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    for impl in ("smt", "smt_plain"):
        with pytest.raises(ValueError, match="treelet layout"):
            ttrav.traverse(plain, ro, rd, impl=impl)


def test_wrapper_rejects_bad_arguments(reference_native):
    _, _, ps, _ = _setup("knot")
    ro, rd = (torch.tensor(a[:64]) for a in _rays("surface"))
    t0 = torch.full((64,), 5.0)
    for c in (0, 3, 16, None):
        with pytest.raises(ValueError, match="chains"):
            smt_cuda.smt_traverse(ps, ro, rd, t0, chains=c)
    with pytest.raises(ValueError, match="ro"):
        smt_cuda.smt_traverse(ps, ro.double(), rd, t0)
    with pytest.raises(ValueError, match="contiguous"):
        smt_cuda.smt_traverse(ps, ro, rd.t().contiguous().t(), t0)
    with pytest.raises(ValueError, match="differ"):
        smt_cuda.smt_traverse(ps, ro, rd, t0[:10])
    with pytest.raises(ValueError, match="unsupported device"):
        smt_cuda.smt_traverse(ps, ro.to("meta"), rd.to("meta"), t0.to("meta"))
    bad = Scene({**ps.arrays, "trl_links": ps["trl_links"].long()}, ps.static, ps.device)
    with pytest.raises(ValueError, match="trl_links"):
        smt_cuda.smt_traverse(bad, ro, rd, t0)
    bad = Scene({**ps.arrays, "trl_recs": ps["trl_recs"][:, :8].contiguous()},
                ps.static, ps.device)
    with pytest.raises(ValueError, match="trl_recs"):
        smt_cuda.smt_traverse(bad, ro, rd, t0)
    bad = Scene(ps.arrays, {**ps.static, "trl_window": 256}, ps.device)
    with pytest.raises(ValueError, match="window"):
        smt_cuda.smt_traverse(bad, ro, rd, t0)


def test_chain_count_default_and_accepted_values():
    """K4 takes 1, 2, 4 or 8 rays per lane.  Without ATEN_TPU_CHAINS the
    port runs smt_cuda.DEFAULT_CHAINS, the count the card measured
    fastest (the reference's default is 4); the wrapper's default is the
    same; another count raises when accel/traverse.py is imported."""
    assert smt_cuda.CHAIN_COUNTS == (1, 2, 4, 8)
    assert smt_cuda.DEFAULT_CHAINS in smt_cuda.CHAIN_COUNTS
    default = inspect.signature(smt_cuda.smt_traverse).parameters["chains"].default
    assert default == smt_cuda.DEFAULT_CHAINS
    code = ("import sys; sys.path.insert(0, %r); from aten_tpu_torch.accel import traverse; "
            "print(traverse.CHAINS)" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "ATEN_TPU_CHAINS"}
    for value, want in ((None, smt_cuda.DEFAULT_CHAINS), ("8", 8), ("3", None)):
        if value is not None:
            env["ATEN_TPU_CHAINS"] = value
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120)
        if want is None:
            assert out.returncode != 0 and "ATEN_TPU_CHAINS" in out.stderr, out.stderr[-2000:]
        else:
            assert out.returncode == 0 and out.stdout.split() == [str(want)], out.stderr[-2000:]


def _image_bounds(img, ref):
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    return (rel > 2e-2).mean(), rel.mean()


def test_render_on_k4_matches_reference(reference_native):
    """The slice at a reduced size: the 2,004-prim knot at 48x48, 4 spp,
    depth 3, every traversal forced onto K4's plain version, against
    aten_tpu's render_image of the same scene, within the full-image
    radiance bounds; impl "auto" on a scene that names K4, and impl
    "smt" (the wrapper, on the CPU its plain version), render the same
    image."""
    js, _, ps, cam = _setup("knot")
    tcam = dataclasses.replace(cam, width=48, height=48)
    ref = np.asarray(jax_render_image(
        js, jcam.PinholeCamera(**dataclasses.asdict(tcam)), spp=4, max_depth=3))
    img = render_image(ps, tcam, spp=4, max_depth=3, impl="smt_plain").numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    frac, mean_rel = _image_bounds(img, ref)
    assert frac < 5e-3, frac
    assert mean_rel < 3e-3, mean_rel
    small = dataclasses.replace(tcam, width=16, height=16)
    a = render_image(ps, small, spp=2, max_depth=3, impl="smt_plain").numpy()
    np.testing.assert_array_equal(render_image(ps, small, spp=2, max_depth=3).numpy(), a)
    np.testing.assert_array_equal(
        render_image(ps, small, spp=2, max_depth=3, impl="smt").numpy(), a)
