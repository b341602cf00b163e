"""The drain window of the treelet kernels (ATEN_TRL_WINDOW) against aten_tpu.

* Layouts: the port's `treelet_cut`, K4's layout and K3's layout at
  windows 8, 16, 32 and 128 equal aten_tpu's `treelet_cut(bvh, W)` and
  `build_treelet_layout(treelet_max=W)` on a 2,004-prim knot: the cut
  tree, its links, each fat leaf's slot range, the slot records and the
  pool's tail pad of one window.
* K4's plain version at each window against aten_tpu's MT drain
  `_traverse_treelet_tiles(wrows=W // 8)`, the kernel the reference runs
  on a layout of a window other than its default, in TPU interpret
  mode: prim agreement >= 0.999 and t within rtol = atol = 1e-4 where
  prims agree (the `_check_parity` bounds), closest-hit; any-hit
  verdicts at W = 32.  A TPU tile walks one link ordering for its rays
  and the port one per ray, so two prims at one t may come in another
  order: hence agreement, not equality.
* K3's plain version at W = 32 against aten_tpu's Plücker kernel K3 at
  its window 32, run in a child process under ATEN_TRL_WINDOW=32 with
  JAX on the CPU (the reference fixes its E-block width at import):
  the same bounds.
* The windows the port refuses raise and name the rule, the default is
  64, and at 64 the layouts are those of before.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aten_tpu.ops import traverse_pallas as jtp
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.ops import plk_cuda, plk_layout, smt_cuda, trl_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.scene import kernel_layouts, with_plk_layout, with_trl_layout
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT = {"n_u": 40, "n_v": 25}  # 2,000 knot triangles + 4: 2,004 prims
GEO = ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")
WINDOWS = (8, 16, 32, 128)
PRIM_AGREE = 0.999
T_TOL = 1e-4
N_RAYS = 1024

_SETUP = {}


def _setup():
    """(reference SceneData, the port's scene, the BVH as numpy, rays
    (ro, rd): 512 camera rays and 512 rays from random surface points in
    random directions)."""
    if not _SETUP:
        b = JaxSceneBuilder()
        tdefs.populate_procedural_mesh_scene(b, 32, 32, **KNOT)
        js = b.build()
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        bvh = {k: np.asarray(js[k]) for k in bridge.BVH_KEYS}
        rng = np.random.default_rng(12)
        n = N_RAYS // 2
        tid = rng.integers(0, js["num_tris"], n)
        bc = rng.random((n, 2))
        bc[bc.sum(1) > 1] = 1.0 - bc[bc.sum(1) > 1]
        v0, e1, e2 = (np.asarray(js[k])[tid] for k in GEO[:3])
        sro = (v0 + bc[:, :1] * e1 + bc[:, 1:] * e2).astype(np.float32)
        d = rng.standard_normal((2 * n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        # camera-like rays: from a point in front of the knot toward it
        cro = np.tile(np.float32([0.0, 1.5, 6.0]), (n, 1))
        tgt = rng.uniform([-2.0, 0.0, -1.0], [2.0, 3.0, 1.0], (n, 3))
        cd = tgt - cro
        cd = (cd / np.linalg.norm(cd, axis=1, keepdims=True)).astype(np.float32)
        ro = np.concatenate([cro, sro]).astype(np.float32)
        rd = np.concatenate([cd, d[n:]]).astype(np.float32)
        _SETUP["v"] = (js, ts, bvh, ro, rd)
    return _SETUP["v"]


def _agree(name, t, prim, t_ref, prim_ref):
    """The parity bounds: prim agreement >= PRIM_AGREE, t within
    rtol = atol = T_TOL where prims agree and hit."""
    agree = float((prim == prim_ref).mean())
    assert agree >= PRIM_AGREE, (name, agree)
    m = (prim_ref >= 0) & (prim == prim_ref)
    assert m.sum() > 100, (name, int(m.sum()))
    np.testing.assert_allclose(t[m], t_ref[m], rtol=T_TOL, atol=T_TOL, err_msg=name)


# -- layouts --------------------------------------------------------------------

@pytest.mark.parametrize("window", WINDOWS + (64,))
def test_cut_and_layouts_match_reference(reference_native, window):
    js, _, bvh, _, _ = _setup()
    want = jtp.treelet_cut(bvh, window)
    got = plk_layout.treelet_cut(bvh, window=window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    Kt = got[2].shape[0]
    jl = jtp.build_treelet_layout(bvh, *(np.asarray(js[k]) for k in GEO), js["num_tris"],
                                  treelet_max=window)
    assert jl["_window"] == window
    ints = jl["trl_nodes"][:, 6:22].view(np.int32)
    k4 = trl_layout.build_trl_layout(bvh, *(np.asarray(js[k]) for k in GEO), js["num_tris"],
                                     window=window)
    assert k4["trl_window"] == window
    ni = k4["trl_nodes"][:, 6:8].view(np.int32)
    first = np.where(ints[:Kt, 12] >= 0, ints[:Kt, 12] * plk_layout.PACK, -1)
    np.testing.assert_array_equal(k4["trl_nodes"][:, 0:6], jl["trl_nodes"][:Kt, 0:6])
    np.testing.assert_array_equal(k4["trl_links"], ints[:Kt, 0:12])
    np.testing.assert_array_equal(ni[:, 0], first)
    np.testing.assert_array_equal(ni[:, 1], ints[:Kt, 13])
    assert int(ni[:, 1].max()) <= window
    slots = jl["trl_prims"].reshape(-1, plk_layout.PACK, 16)[:, :, :11].reshape(-1, 11)
    assert k4["trl_recs"].shape[0] == slots.shape[0]  # the tail pad: one window
    np.testing.assert_array_equal(k4["trl_recs"][:, :11].view(np.int32), slots.view(np.int32))
    k3 = plk_layout.build_plk_layout(bvh, *(np.asarray(js[k]) for k in GEO[:3]), js["num_tris"],
                                     window=window)
    assert k3["plk_window"] == window
    np.testing.assert_array_equal(k3["plk_slot_start"], first)
    np.testing.assert_array_equal(k3["plk_count"], ints[:Kt, 13])
    np.testing.assert_array_equal(k3["plk_hit"], got[2])
    np.testing.assert_array_equal(k3["plk_miss"], got[3])
    assert k3["plk_slot2prim"].shape[0] == slots.shape[0]
    np.testing.assert_array_equal(k3["plk_slot2prim"][k3["plk_slot2prim"] >= 0],
                                  slots[:, 9].view(np.int32)[slots[:, 10].view(np.int32) == 1])


@pytest.mark.parametrize("window,k3,k4", [
    (0, False, False), (4, False, False), (12, False, False), (24, False, True),
    (96, False, True), (136, False, False), (256, False, False), (64.5, False, False),
    (8, True, True), (128, True, True)])
def test_window_rules(reference_native, window, k3, k4):
    """K4 takes a multiple of 8 up to 128, K3 a power of two from 8 to
    128; a window either refuses raises ValueError naming its rule."""
    js, _, bvh, _, _ = _setup()
    geo = [np.asarray(js[k]) for k in GEO]
    for ok, rule, build in ((k3, "power of two", lambda: plk_layout.build_plk_layout(
            bvh, *geo[:3], js["num_tris"], window=window)),
                            (k4, "multiple of 8", lambda: trl_layout.build_trl_layout(
            bvh, *geo, js["num_tris"], window=window))):
        if ok:
            build()
        else:
            with pytest.raises(ValueError, match=rule):
                build()


def test_default_window_and_refused_environment():
    """The default is the reference's 64; ATEN_TRL_WINDOW is read at
    import, and a value K4 does not take raises there."""
    assert plk_layout.WINDOW == trl_layout.WINDOW == 64 and plk_layout.MAX_WINDOW == 128
    code = "import aten_tpu_torch.ops.plk_layout as p; print(p.WINDOW)"
    env = {**os.environ, "PYTHONPATH": ROOT}
    for value, ok in (("24", True), ("128", True), ("20", False)):
        out = subprocess.run([sys.executable, "-c", code], env={**env, "ATEN_TRL_WINDOW": value},
                             capture_output=True, text=True, timeout=120, cwd=ROOT)
        if ok:
            assert out.returncode == 0 and out.stdout.split() == [value], out.stderr[-2000:]
        else:
            assert out.returncode != 0 and "multiple of 8" in out.stderr


def test_default_window_unchanged_and_other_windows_go_to_k1(reference_native, monkeypatch):
    """At the default window the scene's layouts are those of before; a
    default window K3 does not take builds K1's records under "v3"."""
    js, ts, bvh, _, _ = _setup()
    s = with_plk_layout(ts)
    assert s["plk_window"] == 64 and int(s["plk_count"].max()) <= 64
    lay = plk_layout.build_plk_layout(bvh, *(np.asarray(js[k]) for k in GEO[:3]),
                                      js["num_tris"])
    for k in plk_layout.ARRAY_KEYS:
        np.testing.assert_array_equal(s[k].numpy(), lay[k])
    monkeypatch.setattr(ttrav, "KERNEL", "plk")
    # the knot as if it were past the treelet line
    monkeypatch.setattr(plk_layout, "TREELET_MIN_BYTES", 0)
    monkeypatch.setattr(trl_layout, "TREELET_MIN_BYTES", 0)
    geo = {k: np.asarray(js[k]) for k in GEO}
    arrays, static = kernel_layouts(bvh, geo, js["num_tris"])
    assert static == {"traversal": "plk", "plk_window": 64}
    monkeypatch.setattr(plk_layout, "WINDOW", 24)
    arrays, static = kernel_layouts(bvh, geo, js["num_tris"])
    assert static == {} and "bvh_nodes" in arrays


def test_kernel_wrappers_take_the_layout_window(reference_native):
    """The wrappers name each window's instantiation and refuse a window
    their kernel does not take, on every device."""
    _, ts, _, ro, rd = _setup()
    ro, rd = torch.from_numpy(ro[:64]), torch.from_numpy(rd[:64])
    t0 = torch.full((64,), 3.4e38)
    assert plk_cuda.kernel_names("", 32) == ("plk_traverse_closest_w32", "plk_traverse_any_w32")
    assert plk_cuda.kernel_names() == plk_cuda.KERNELS
    assert smt_cuda.kernel_name(False, 1, window=16) == "smt_traverse_closest_c1_w32"
    assert smt_cuda.kernel_name(True, 4, True, 128) == "smt_traverse_lod_any_c4_w128"
    assert smt_cuda.kernel_name(False, 1, window=64) == "smt_traverse_closest_c1"
    assert smt_cuda.kernel_name(False, 1, window=40) == "smt_traverse_closest_c1"
    assert all(k in plk_cuda.INSTANTIATIONS for w in plk_cuda.WINDOWS
               for v in plk_cuda.VARIANTS for k in plk_cuda.kernel_names(v, w))
    assert all(smt_cuda.kernel_name(a, c, lod, w) in smt_cuda.INSTANTIATIONS
               for a in (False, True) for c in smt_cuda.CHAIN_COUNTS
               for lod in (False, True) for w in range(8, 129, 8))
    s3 = with_plk_layout(ts, window=32)
    t, prim = plk_cuda.plk_traverse(s3, ro, rd, t0)
    assert (prim >= 0).any()
    s4 = with_trl_layout(ts, window=24)
    t, prim = smt_cuda.smt_traverse(s4, ro, rd, t0)
    assert (prim >= 0).any()
    for scene, key, fn in ((s3, "plk_window", plk_cuda.plk_traverse),
                           (s4, "trl_window", smt_cuda.smt_traverse)):
        bad = type(scene)(scene.arrays, {**scene.static, key: 12}, scene.device)
        with pytest.raises(ValueError, match="drain window 12"):
            fn(bad, ro, rd, t0)


# -- traversal against the reference --------------------------------------------

def _reference_mt(jl, ro, rd, t_max=None, any_hit=False, t_min=1e-4):
    """aten_tpu's MT drain on its own layout of window jl["_window"], in
    TPU interpret mode, with traverse_pallas's wrapping (:2079-2151):
    8-row tiles, padded rays dead, dead any-hit lanes undone."""
    js = _setup()[0]
    n = ro.shape[0]
    q = jtp.ROWS * jtp.LANES
    pad = -(-n // q) * q - n
    t0 = np.full(n, 3.4e38, np.float32) if t_max is None else t_max

    def prep(x, fill=0.0):
        return jax.numpy.asarray(np.pad(x, (0, pad), constant_values=fill).reshape(-1, jtp.LANES))

    with pltpu.force_tpu_interpret_mode():
        t, prim = jtp._traverse_treelet_tiles(
            jax.numpy.asarray(jl["trl_nodes"]), jax.numpy.asarray(jl["trl_prims"]),
            prep(ro[:, 0]), prep(ro[:, 1]), prep(ro[:, 2]),
            prep(rd[:, 0]), prep(rd[:, 1]), prep(rd[:, 2], 1.0), prep(t0, -1.0),
            any_hit=any_hit, t_min=t_min, has_spheres=js["num_spheres"] > 0,
            resident=True, tile_rows=jtp.ROWS, wrows=jl["_window"] // jtp.PACK)
    prim = np.asarray(prim).reshape(-1)[:n]
    if any_hit:
        prim = np.where(t0 <= t_min, -1, prim)
    return np.asarray(t).reshape(-1)[:n], prim


@pytest.mark.parametrize("window", WINDOWS)
def test_k4_plain_matches_reference_mt_drain(reference_native, window):
    js, ts, bvh, ro, rd = _setup()
    jl = jtp.build_treelet_layout(bvh, *(np.asarray(js[k]) for k in GEO), js["num_tris"],
                                  treelet_max=window)
    s = with_trl_layout(ts, window=window)
    h = ttrav.traverse(s, torch.from_numpy(ro), torch.from_numpy(rd), impl="smt_plain")
    t_ref, p_ref = _reference_mt(jl, ro, rd)
    _agree(f"K4 plain W={window}", h["t"].numpy(), h["prim"].numpy(), t_ref, p_ref)
    if window == 32:
        dist = np.random.default_rng(3).uniform(0.0, 20.0, ro.shape[0]).astype(np.float32)
        a = ttrav.traverse(s, torch.from_numpy(ro), torch.from_numpy(rd),
                           t_max=torch.from_numpy(dist), any_hit=True, t_min=1e-3,
                           impl="smt_plain")
        _, pa = _reference_mt(jl, ro, rd, t_max=dist, any_hit=True, t_min=1e-3)
        agree = float((a["hit"].numpy() == (pa >= 0)).mean())
        assert agree >= PRIM_AGREE, ("K4 plain any-hit W=32", agree)


_CHILD_K3 = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu
from aten_tpu.ops import traverse_pallas as jtp
from aten_tpu.scene.scene import SceneBuilder
from aten_tpu_torch.scene import scenedefs as tdefs

assert jtp.TREELET_MAX == 32 and jtp.PLK_EW == 128
b = SceneBuilder()
tdefs.populate_procedural_mesh_scene(b, 32, 32, n_u=40, n_v=25)
js = b.build()
bvh = {k: np.asarray(js[k]) for k in ("nodes_bmin", "nodes_bmax", "nodes_hit", "nodes_miss",
                                       "nodes_prim_start", "nodes_prim_count", "prim_order")}
jl = jtp.build_treelet_layout(bvh, *(np.asarray(js[k]) for k in (
    "tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")), js["num_tris"])
assert jl["_window"] == 32 and "trl_emat" in jl
rays = np.load(sys.argv[1])
ro, rd = rays["ro"], rays["rd"]
n = ro.shape[0]
q = 16 * jtp.LANES
pad = -(-n // q) * q - n
prep = lambda x, f=0.0: jnp.asarray(np.pad(x, (0, pad), constant_values=f).reshape(-1, jtp.LANES))
s2p = jl["trl_slot2prim"]
ns = s2p.shape[0]
with pltpu.force_tpu_interpret_mode():
    t, prim = jtp._traverse_plk_tiles(
        jnp.asarray(jl["trl_nodes"]), jnp.asarray(jl["trl_emat"]),
        prep(ro[:, 0]), prep(ro[:, 1]), prep(ro[:, 2]), prep(rd[:, 0]), prep(rd[:, 1]),
        prep(rd[:, 2], 1.0), prep(np.full(n, 3.4e38, np.float32), -1.0),
        any_hit=False, t_min=1e-4, tile_rows=16, n_slots=ns)
raw = np.asarray(prim).reshape(-1)[:n]
prim = np.where((raw >= 0) & (raw < ns), s2p[np.clip(raw, 0, ns - 1)], -1)
np.savez(sys.argv[2], t=np.asarray(t).reshape(-1)[:n], prim=prim)
"""


def test_k3_plain_matches_reference_at_window_32(reference_native, tmp_path):
    """aten_tpu's K3 fixes its E block's width (PLK_EW = 4 * TREELET_MAX)
    at import, so it runs at window 32 in a child process under
    ATEN_TRL_WINDOW=32, JAX on the CPU."""
    _, ts, _, ro, rd = _setup()
    np.savez(tmp_path / "rays.npz", ro=ro, rd=rd)
    env = {**os.environ, "ATEN_TRL_WINDOW": "32", "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", _CHILD_K3, str(tmp_path / "rays.npz"),
                          str(tmp_path / "ref.npz")], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = np.load(tmp_path / "ref.npz")
    s = with_plk_layout(ts, window=32)
    h = ttrav.traverse(s, torch.from_numpy(ro), torch.from_numpy(rd), impl="plk_plain")
    t, prim = h["t"].numpy(), h["prim"].numpy()
    _agree("K3 plain W=32", t, prim, ref["t"], ref["prim"])
    # t keeps 23 - 5 mantissa bits at window 32
    hit = prim >= 0
    assert not (t[hit].view(np.int32) & 31).any()
