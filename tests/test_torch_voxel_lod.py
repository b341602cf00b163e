"""aten_tpu_torch's voxel LOD against aten_tpu.

Two scenes, built the same in both packages: the reference's grid
(`_grid_scene` of tests/test_voxel_lod.py: 1,152 triangles, red left,
white right) and the 2,004-prim knot of `procedural_mesh_scene`.

* Host side, bit for bit: `node_depths`, `annotate_voxels` and
  `enable_voxel_lod`'s annotation; `bake_lod_tree`; `treelet_cut` with
  voxel protection; the voxel ids in the port's kernel layouts against
  lane 20 of the reference's `build_treelet_layout(voxid=, vox_base=)`.
* The oracle walk (`traverse(impl="plain")`, which reads
  scene["lod_depth"]) against `traverse(impl="jax")` at lod_depth 3, 6,
  9 and 99: prim agreement >= 0.999 and t within 1e-4 (the
  `_check_parity` bounds; the port rounds every op, XLA contracts FMAs);
  at 99 no node is that deep, and the walk equals the unannotated
  scene's, closest and any-hit.
* Each kernel's plain version (impl "cuda", "plk", "smt" on CPU tensors:
  the walks of the baked layouts) against the reference's own Pallas
  kernel with has_lod=True, run in TPU interpret mode on
  `enable_voxel_lod`'s layout: `_traverse_treelet_tiles` (K1),
  `_traverse_plk_tiles` (K3, ids translated), `_traverse_smt_tiles`
  (K4): prim agreement >= 0.999, t within 1e-4, more than 50 voxel
  winners (test_pallas_tpu.py:190), any-hit verdicts; and against the
  oracle at the same bounds.
* `eval_hit` on voxel hits, a render of the LOD grid against aten_tpu's
  within the full-image radiance bounds, the bridge, and the wrappers'
  refusal of a stale `lod_depth`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aten_tpu.accel import voxel as jvox
from aten_tpu.accel.traverse import traverse as jax_traverse
from aten_tpu.core import camera as jcam
from aten_tpu.integrator.pathtracer import eval_hit as jax_eval_hit
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.ops import traverse_pallas as jtp
from aten_tpu.scene.materials import MaterialType as JaxMaterialType
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.accel import voxel as tvox
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.pathtracer import eval_hit, render_image
from aten_tpu_torch.ops import bvh_layout, lod_layout, plk_layout, trl_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import (
    Scene, SceneBuilder, with_bvh_layout, with_plk_layout, with_trl_layout)
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

KNOT = {"n_u": 40, "n_v": 25}  # 2,000 knot triangles + 4: 2,004 prims
PRIM_AGREE = 0.999
T_TOL = 1e-4
KERNEL_LOD = 6  # the depth of the interpret-mode checks: ~290 voxel winners of 2,048 rays


def _populate_grid(b, mtype, n=24):
    """tests/test_voxel_lod.py::_grid_scene's geometry on builder `b`."""
    red = b.add_material(mtype.DIFFUSE, base_color=(0.8, 0.1, 0.1))
    white = b.add_material(mtype.DIFFUSE, base_color=(0.8, 0.8, 0.8))
    for i in range(n):
        for j in range(n):
            x0, x1 = i / n * 2 - 1, (i + 1) / n * 2 - 1
            y0, y1 = j / n * 2 - 1, (j + 1) / n * 2 - 1
            b.add_quad([x0, y0, 0], [x1, y0, 0], [x1, y1, 0], [x0, y1, 0],
                       red if i < n // 2 else white)
    return PinholeCamera(origin=(0, 0, 3), lookat=(0, 0, 0), vfov_deg=45, width=32, height=32)


_SETUP = {}


def _setup(name):
    """(reference SceneData, the port's scene of the same builder calls,
    the port's camera) of the grid or the knot."""
    if name not in _SETUP:
        jb, tb = JaxSceneBuilder(), SceneBuilder()
        if name == "grid":
            _populate_grid(jb, JaxMaterialType)
            cam = _populate_grid(tb, MaterialType)
        elif name == "cornell":
            tdefs.populate_cornell_box(jb, 64, 64)
            cam = tdefs.populate_cornell_box(tb, 64, 64)
        else:
            tdefs.populate_procedural_mesh_scene(jb, 32, 32, **KNOT)
            cam = tdefs.populate_procedural_mesh_scene(tb, 32, 32, **KNOT)
        _SETUP[name] = (jb.build(), tb.build("cpu"), cam)
    return _SETUP[name]


def _lod(name, lod_depth):
    """(reference LOD scene, the port's) at lod_depth."""
    key = (name, lod_depth)
    if key not in _SETUP:
        js, ts, _ = _setup(name)
        _SETUP[key] = (jvox.enable_voxel_lod(js, lod_depth=lod_depth),
                       tvox.enable_voxel_lod(ts, lod_depth=lod_depth))
    return _SETUP[key]


def _tree(scene):
    return {k: np.asarray(scene[k]) if not torch.is_tensor(scene[k]) else scene[k].numpy()
            for k in bridge.BVH_KEYS}


def _np(h):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in h.items()}


def _with_depth(scene, depth):
    """The port's scene with its lod_depth replaced (the layout unbaked)."""
    return Scene({**scene.arrays, "lod_depth": torch.tensor(depth, dtype=torch.int32)},
                 scene.static, scene.device)


def _rays(name, n=2048):
    """n rays: camera rays through pixel centres, then rays leaving the
    first hits of jittered camera rays (the port's oracle on the LOD
    scene at KERNEL_LOD), 1e-3 off the surface on the side the ray came
    from, in uniform directions over that hemisphere, as the path
    tracer's bounces leave (numpy seeded)."""
    _, ts, cam = _setup(name)
    rng = np.random.default_rng(7)
    jc = jcam.PinholeCamera(**dataclasses.asdict(cam))
    w, h = cam.width, cam.height
    lp = np.arange(n // 2)
    ro, rd = jcam.generate_ray(
        jc.arrays(), jnp.asarray(((lp % w) + 0.5) / w, jnp.float32),
        jnp.asarray((((lp // w) % h) + 0.5) / h, jnp.float32))
    ro, rd = np.asarray(ro), np.asarray(rd)
    jit = rng.random((n, 2))
    r2, d2 = jcam.generate_ray(jc.arrays(), jnp.asarray(((np.arange(n) % w) + jit[:, 0]) / w,
                                                        jnp.float32),
                               jnp.asarray((((np.arange(n) // w) % h) + jit[:, 1]) / h,
                                           jnp.float32))
    r2, d2 = torch.tensor(np.asarray(r2)), torch.tensor(np.asarray(d2))
    ls = _lod(name, KERNEL_LOD)[1]
    hit = ttrav.traverse(ls, r2, d2, impl="plain")
    e = eval_hit(ls, r2, d2, hit)
    pick = rng.choice(np.nonzero(hit["hit"].numpy())[0], n - n // 2)
    p, ns, din = e["p"][pick].numpy(), e["ns"][pick].numpy(), d2[pick].numpy()
    n_or = np.where((ns * din).sum(1, keepdims=True) < 0, ns, -ns)
    d = rng.standard_normal((pick.shape[0], 3))
    d = np.where((d * n_or).sum(1, keepdims=True) < 0, -d, d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = (p + n_or * 1e-3).astype(np.float32)
    return np.concatenate([ro, o]), np.concatenate([rd, d])


def _dist(n, seed):
    return np.random.default_rng(seed).uniform(0.0, 20.0, n).astype(np.float32)


def _port(scene, ro, rd, impl, **kw):
    kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return _np(ttrav.traverse(scene, torch.tensor(ro), torch.tensor(rd), impl=impl, **kw))


def _agree(name, got, want, vox_base, min_vox=None):
    """Hold `got` (t, prim) to `want` at the parity bounds, and `want`
    to more than min_vox voxel winners; returns their number."""
    agree = float((got["prim"] == want["prim"]).mean())
    assert agree >= PRIM_AGREE, (name, agree)
    m = (want["prim"] >= 0) & (got["prim"] == want["prim"])
    np.testing.assert_allclose(got["t"][m], want["t"][m], rtol=T_TOL, atol=T_TOL, err_msg=name)
    n_vox = int((want["prim"] >= vox_base).sum())
    assert min_vox is None or n_vox > min_vox, (name, n_vox)
    return n_vox


# -- host side ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grid", "knot"])
def test_annotation_matches_reference(reference_native, name):
    js, ts, _ = _setup(name)
    tree = _tree(js)
    want = jvox.node_depths(tree["nodes_hit"], tree["nodes_miss"], tree["nodes_prim_start"])
    got = tvox.node_depths(tree["nodes_hit"], tree["nodes_miss"], tree["nodes_prim_start"])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    nt = js["num_tris"]
    for vd in (2, 3):
        want = jvox.annotate_voxels(tree, np.asarray(js["tri_mtl"])[:nt],
                                    np.asarray(js["tri_area"])[:nt], vd)
        got = tvox.annotate_voxels(tree, np.asarray(js["tri_mtl"])[:nt],
                                   np.asarray(js["tri_area"])[:nt], vd)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    jl, tl = _lod(name, 3)
    for k in ("nodes_voxel_mtl", "nodes_depth", "lod_depth"):
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)
    assert tl["lod_depth"].dtype == torch.int32 and tl["lod_depth"].dim() == 0
    assert tl["has_voxel_lod"] and tl["lod_bake_depth"] == 3
    marked = tl["nodes_voxel_mtl"].numpy() >= 0
    assert marked.sum() > 5 and (tl["nodes_depth"].numpy()[marked] % 3 == 0).all()


@pytest.mark.parametrize("name,lod_depth", [("grid", 3), ("knot", 3), ("knot", 6), ("knot", 9)])
def test_bake_matches_reference(reference_native, name, lod_depth):
    js, _, _ = _setup(name)
    jl, _ = _lod(name, 3)
    tree = _tree(js)
    vox_mtl, depth = np.asarray(jl["nodes_voxel_mtl"]), np.asarray(jl["nodes_depth"])
    want, want_id = jtp.bake_lod_tree(tree, vox_mtl, depth, lod_depth)
    got, got_id = lod_layout.bake_lod_tree(tree, vox_mtl, depth, lod_depth)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_id.dtype == want_id.dtype
    np.testing.assert_array_equal(got_id, want_id)
    assert (got_id >= 0).sum() > 4
    # the cut keeps every voxel leaf a node of its own
    protect = got_id >= 0
    for g, w, what in zip(plk_layout.treelet_cut(got, protect),
                          jtp.treelet_cut(want, 64, protect=protect),
                          ("bmin", "bmax", "hit", "miss", "start", "count", "keep")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", ["grid", "knot"])
def test_layouts_carry_the_reference_voxel_ids(reference_native, name):
    """The voxel id of every node of the port's K3 and K4 layouts equals
    lane 20 of the reference's LOD layout, their boxes and fat-leaf slot
    counts its lanes; K1's baked records unpack to the baked tree."""
    jl, tl = _lod(name, KERNEL_LOD if name == "knot" else 3)
    ints = np.asarray(jl["trl_nodes"])[:, 6:22].view(np.int32)
    vb = tl["num_tris"] + tl["num_spheres"]
    word = lod_layout.VOXEL_WORD
    s4 = with_trl_layout(tl)
    Kt = s4["trl_nodes"].shape[0]
    assert ints.shape[0] == -(-Kt // 8) * 8  # the reference pads its rows to 8
    n4 = s4["trl_nodes"].numpy()
    w4 = n4[:, 6:8].view(np.int32)
    np.testing.assert_array_equal(n4[:, 0:6], np.asarray(jl["trl_nodes"])[:Kt, 0:6])
    np.testing.assert_array_equal(np.where(w4[:, 0] <= word, word - w4[:, 0], -1), ints[:Kt, 14])
    np.testing.assert_array_equal(s4["trl_links"].numpy(), ints[:Kt, 0:12])
    np.testing.assert_array_equal(w4[:, 1], ints[:Kt, 13])
    assert (ints[:Kt, 14] >= vb).sum() > 4
    if name == "knot":
        s3 = with_plk_layout(tl)
        ss = s3["plk_slot_start"].numpy()
        np.testing.assert_array_equal(np.where(ss <= word, word - ss, -1), ints[:Kt, 14])
        _, _, hit, miss, leaf, _, count = bvh_layout.unpack_nodes(
            s3["plk_nodes"].numpy(), shift=bvh_layout.TREELET_LEAF_SHIFT)
        np.testing.assert_array_equal(np.where(leaf <= word, word - leaf, -1), ints[:Kt, 14])
        np.testing.assert_array_equal(hit, s3["plk_hit"].numpy())
        np.testing.assert_array_equal(count, s3["plk_count"].numpy())
        used = s3["plk_slot2prim"].numpy() >= 0
        assert not s3["plk_consts"].numpy()[~used].any()
        # the reference gives every prim of a pruned subtree slot 0
        # (row_of_prim's default, traverse_pallas.py:640-651 with
        # :667 and :757): its slot 0 holds the last such prim in
        # prim_order, the port's the fat leaf's own first prim
        ref_s2p = np.asarray(jl["trl_slot2prim"])
        got_s2p = s3["plk_slot2prim"].numpy()
        assert np.nonzero(ref_s2p != got_s2p)[0].tolist() == [0]
        assert ref_s2p[0] not in set(got_s2p[used].tolist())
    tree, voxid = lod_layout.bake_lod_tree(_tree(tl), tl["nodes_voxel_mtl"].numpy(),
                                           tl["nodes_depth"].numpy(), tl["lod_bake_depth"])
    bmin, bmax, hit, miss, leaf, start, count = bvh_layout.unpack_nodes(tl["bvh_nodes"].numpy())
    np.testing.assert_array_equal(bmin, tree["nodes_bmin"])
    np.testing.assert_array_equal(hit, tree["nodes_hit"])
    np.testing.assert_array_equal(miss, tree["nodes_miss"])
    np.testing.assert_array_equal(start, tree["nodes_prim_start"])
    np.testing.assert_array_equal(count, tree["nodes_prim_count"])
    np.testing.assert_array_equal(np.where(leaf <= word, word - leaf, -1),
                                  np.where(voxid >= 0, vb + voxid, -1))


# -- the oracle walk ----------------------------------------------------------------

@pytest.mark.parametrize("lod_depth", [3, 6, 9, 99])
def test_oracle_matches_reference(reference_native, lod_depth):
    jl, tl = _lod("knot", 3)
    js, ts, _ = _setup("knot")
    jd = jl.replace(lod_depth=jnp.asarray(lod_depth, jnp.int32))
    td = _with_depth(tl, lod_depth)
    ro, rd = _rays("knot")
    vb = ts["num_tris"] + ts["num_spheres"]
    got = _port(td, ro, rd, "plain")
    want = _np(jax_traverse(jd, jnp.asarray(ro), jnp.asarray(rd), impl="jax"))
    n_vox = _agree(f"oracle lod {lod_depth}", got, want, vb)
    np.testing.assert_array_equal(got["u"][got["prim"] >= vb], 0.0)
    dist = _dist(ro.shape[0], lod_depth)
    ga = _port(td, ro, rd, "plain", t_max=dist, any_hit=True, t_min=1e-3)
    wa = _np(jax_traverse(jd, jnp.asarray(ro), jnp.asarray(rd), t_max=jnp.asarray(dist),
                          any_hit=True, t_min=1e-3, impl="jax"))
    assert float((ga["hit"] == wa["hit"]).mean()) >= PRIM_AGREE
    if lod_depth == 99:  # nothing that deep: the unannotated scene's walk
        assert n_vox == 0
        for k, v in _port(ts, ro, rd, "plain").items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        plain = _port(ts, ro, rd, "plain", t_max=dist, any_hit=True, t_min=1e-3)
        for k, v in plain.items():
            np.testing.assert_array_equal(ga[k], v, err_msg=k)
    else:
        assert n_vox > 50 and float((ga["prim"] >= vb).mean()) > 0.0


@pytest.mark.parametrize("lod_depth", [1, 2, 3, 4, 5])
def test_cornell_spheres_lod_walks_match_reference(lod_depth):
    """Voxel LOD over spheres: the Cornell box (12 triangles, 2 spheres)
    at lod_depth 1 to 5, 4,096 camera rays through pixel centres.  The
    oracle walk and K1's plain version (impl "cuda" on CPU tensors, the
    baked tree) agree with traverse(impl="jax"), run eagerly, on every
    ray's prim, t within 1e-4, and every any-hit verdict."""
    jl, tl = _lod("cornell", lod_depth)
    _, _, cam = _setup("cornell")
    jc = jcam.PinholeCamera(**dataclasses.asdict(cam))
    lp = np.arange(64 * 64)
    ro, rd = jcam.generate_ray(jc.arrays(), jnp.asarray(((lp % 64) + 0.5) / 64, jnp.float32),
                               jnp.asarray(((lp // 64) + 0.5) / 64, jnp.float32))
    ro, rd = np.asarray(ro), np.asarray(rd)
    vb = tl["num_tris"] + tl["num_spheres"]
    dist = _dist(ro.shape[0], lod_depth)
    # eagerly: the jitted walk contracts FMAs, which moves the winner at
    # the box's edges (6 of these rays at lod_depth 4); eager XLA rounds
    # every op as the port does
    with jax.disable_jit():
        want = _np(jax_traverse(jl, jnp.asarray(ro), jnp.asarray(rd), impl="jax"))
        wa = _np(jax_traverse(jl, jnp.asarray(ro), jnp.asarray(rd), t_max=jnp.asarray(dist),
                              any_hit=True, t_min=1e-3, impl="jax"))
    # the 14 prims' tree is 4 levels deep: voxels win down to lod_depth 3
    assert (want["prim"] >= 0).mean() > 0.9
    assert (want["prim"] >= vb).any() == (lod_depth <= 3), int((want["prim"] >= vb).sum())
    for impl in ("plain", "cuda"):
        got = _port(tl, ro, rd, impl)
        np.testing.assert_array_equal(got["prim"], want["prim"], err_msg=impl)
        m = want["prim"] >= 0
        np.testing.assert_allclose(got["t"][m], want["t"][m], rtol=T_TOL, atol=T_TOL,
                                   err_msg=impl)
        ga = _port(tl, ro, rd, impl, t_max=dist, any_hit=True, t_min=1e-3)
        np.testing.assert_array_equal(ga["hit"], wa["hit"], err_msg=impl)


def test_lod_scene_never_takes_the_dense_test():
    """A voxel-LOD scene under the dense line walks its tree (reference
    :165-176); impl="dense" is refused."""
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE)
    for i in range(40):
        x = i / 20.0 - 1.0
        b.add_quad([x, -1, 0], [x + 0.05, -1, 0], [x + 0.05, 1, 0], [x, 1, 0], m)
    scene = b.build("cpu")
    assert scene["num_tris"] <= ttrav.DENSE_MAX_PRIMS
    lod = tvox.enable_voxel_lod(scene, lod_depth=3)
    ro = torch.tensor([[x / 20.0 - 0.975, 0.0, 2.0] for x in range(40)], dtype=torch.float32)
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 40)
    h = ttrav.traverse(lod, ro, rd)
    assert bool((h["prim"] >= scene["num_tris"]).all())
    np.testing.assert_array_equal(h["prim"].numpy(),
                                  ttrav.traverse(lod, ro, rd, impl="plain")["prim"].numpy())
    with pytest.raises(ValueError, match="dense"):
        ttrav.traverse(lod, ro, rd, impl="dense")


# -- the kernels' plain versions against the reference kernels -------------------

def _prep(x, q, fill=0.0):
    pad = -(-x.shape[0] // q) * q - x.shape[0]
    return jnp.asarray(np.pad(x, (0, pad), constant_values=fill).reshape(-1, jtp.LANES))


def _reference_kernel(kind, ro, rd, t_max=None, any_hit=False, t_min=1e-4):
    """aten_tpu's LOD kernel `kind` (K1, K3, K4) on the knot's
    enable_voxel_lod layout at KERNEL_LOD, in TPU interpret mode, wrapped
    as traverse_pallas does (:2074-2151): padded rays dead, dead any-hit
    lanes undone, K3's slots and shifted voxel ids translated.
    Returns {"t", "prim"}."""
    jl, _ = _lod("knot", KERNEL_LOD)
    n = ro.shape[0]
    t0 = np.full(n, 3.4e38, np.float32) if t_max is None else t_max
    q = 16 * jtp.LANES  # K1's and K3's 16-row tiles, K4's two 8-row chains
    rays = (_prep(ro[:, 0], q), _prep(ro[:, 1], q), _prep(ro[:, 2], q), _prep(rd[:, 0], q),
            _prep(rd[:, 1], q), _prep(rd[:, 2], q, 1.0), _prep(t0, q, -1.0))
    nodes = jnp.asarray(jl["trl_nodes"])
    with pltpu.force_tpu_interpret_mode():
        if kind == "K1":
            t, prim = jtp._traverse_treelet_tiles(
                nodes, jnp.asarray(jl["trl_prims"]), *rays, any_hit=any_hit, t_min=t_min,
                has_spheres=False, resident=True, has_lod=True, tile_rows=16, wrows=8)
        elif kind == "K3":
            ns = jl["trl_slot2prim"].shape[0]
            t, prim = jtp._traverse_plk_tiles(
                nodes, jnp.asarray(jl["trl_emat"]), *rays, any_hit=any_hit, t_min=t_min,
                has_lod=True, tile_rows=16, n_slots=ns)
        else:
            t, prim = jtp._traverse_smt_tiles(
                nodes, jnp.asarray(jl["trl_prims"]), *rays, any_hit=any_hit, t_min=t_min,
                has_spheres=False, resident=True, has_lod=True, chains=2)
    raw = np.asarray(prim).reshape(-1)[:n]
    if kind == "K3":
        s2p = np.asarray(jl["trl_slot2prim"])
        ns = s2p.shape[0]
        raw = np.where((raw >= 0) & (raw < ns), s2p[np.clip(raw, 0, ns - 1)],
                       np.where(raw >= ns, raw - ns, -1))
    if any_hit:
        raw = np.where(t0 <= t_min, -1, raw)
    return {"t": np.asarray(t).reshape(-1)[:n], "prim": raw}


_PORT = {"K1": ("cuda", lambda s: s), "K3": ("plk", with_plk_layout),
         "K4": ("smt", with_trl_layout)}


@pytest.mark.parametrize("kind", ["K1", "K3", "K4"])
def test_kernel_plain_matches_reference_kernel(reference_native, kind):
    impl, attach = _PORT[kind]
    _, tl = _lod("knot", KERNEL_LOD)
    scene = attach(tl)
    ro, rd = _rays("knot")
    vb = tl["num_tris"] + tl["num_spheres"]
    got = _port(scene, ro, rd, impl)
    _agree(f"{kind} closest", got, _reference_kernel(kind, ro, rd), vb, min_vox=50)
    _agree(f"{kind} against the oracle", got, _port(tl, ro, rd, "plain"), vb, min_vox=50)
    dist = _dist(ro.shape[0], 3)
    ga = _port(scene, ro, rd, impl, t_max=dist, any_hit=True, t_min=1e-3)
    wa = _reference_kernel(kind, ro, rd, t_max=dist, any_hit=True, t_min=1e-3)
    assert float(((ga["prim"] >= 0) == (wa["prim"] >= 0)).mean()) >= PRIM_AGREE
    assert int((wa["prim"] >= vb).sum()) > 50
    if kind != "K1":  # the plain versions named by impl agree with the wrappers' CPU path
        for k, v in _port(scene, ro, rd, impl + "_plain").items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_voxel_ids_get_zero_barycentrics():
    _, tl = _lod("knot", KERNEL_LOD)
    vb = tl["num_tris"] + tl["num_spheres"]
    ro = torch.zeros((4, 3))
    rd = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    prim = torch.tensor([vb, vb + 7, 3, -1], dtype=torch.int32)
    u, v = ttrav.recompute_uv(tl, ro, rd, prim)
    assert float(u[[0, 1, 3]].abs().sum() + v[[0, 1, 3]].abs().sum()) == 0.0


def test_stale_lod_depth_raises():
    """Every kernel wrapper refuses a scene whose lod_depth is no longer
    the depth its layout was baked at; a new bake runs."""
    _, tl = _lod("knot", KERNEL_LOD)
    ro, rd = _rays("knot", n=64)
    ro, rd = torch.tensor(ro), torch.tensor(rd)
    stale = _with_depth(tl, KERNEL_LOD + 3)
    for impl, attach in _PORT.values():
        with pytest.raises(ValueError, match="baked"):
            ttrav.traverse(attach(stale), ro, rd, impl=impl)
    ttrav.traverse(stale, ro, rd, impl="plain")  # the oracle reads lod_depth
    fresh = tvox.enable_voxel_lod(_setup("knot")[1], lod_depth=KERNEL_LOD + 3)
    for impl, attach in _PORT.values():
        ttrav.traverse(attach(fresh), ro, rd, impl=impl)


@pytest.mark.parametrize("n_u,n_v,treelet", [(40, 25, False), (80, 64, True)])
def test_kernel_policy_picks_the_baked_layout(reference_native, monkeypatch, n_u, n_v, treelet):
    """enable_voxel_lod attaches the layout the kernel policy runs, by the
    baked tree's sizes (uses_trl, uses_plk): on the treelet branch (the
    10,244-prim knot) K1's records under "v3" (its pools are far under the
    32 MB line) and "mt", K3's under "plk", K4's under "smt"; below it
    (the 2,004-prim knot) K1's under every policy."""
    tb = SceneBuilder()
    tdefs.populate_procedural_mesh_scene(tb, 16, 16, n_u=n_u, n_v=n_v)
    ts = tb.build("cpu")
    for policy, traversal, keys in (("v3", None, bvh_layout.ARRAY_KEYS),
                                    ("mt", None, bvh_layout.ARRAY_KEYS),
                                    ("plk", "plk", plk_layout.ARRAY_KEYS),
                                    ("smt", "smt", trl_layout.ARRAY_KEYS)):
        if not treelet:
            traversal, keys = None, bvh_layout.ARRAY_KEYS
        monkeypatch.setattr(ttrav, "KERNEL", policy)
        ls = tvox.enable_voxel_lod(ts, lod_depth=KERNEL_LOD)
        assert ls.get("traversal") == traversal, policy
        kernel_keys = [k for k in ls.arrays if k.startswith(("bvh_", "plk_", "trl_"))]
        assert sorted(kernel_keys) == sorted(keys), policy
        ro, rd = _rays("knot", n=64)
        h = ttrav.traverse(ls, torch.tensor(ro), torch.tensor(rd))
        assert bool(torch.isfinite(h["t"]).all())


# -- shading, render, bridge ------------------------------------------------------

def test_eval_hit_on_voxels_matches_reference(reference_native):
    jl, tl = _lod("knot", KERNEL_LOD)
    ro, rd = _rays("knot")
    want_hit = jax_traverse(jl, jnp.asarray(ro), jnp.asarray(rd), impl="jax")
    hit = {k: torch.tensor(np.asarray(v)) for k, v in want_hit.items() if k != "steps"}
    want = jax_eval_hit(jl, jnp.asarray(ro), jnp.asarray(rd), want_hit)
    got = eval_hit(tl, torch.tensor(ro), torch.tensor(rd), hit)
    vox = got["is_voxel"].numpy()
    np.testing.assert_array_equal(vox, np.asarray(want["is_voxel"]))
    assert vox.sum() > 50
    for k in ("mtl", "light", "mesh"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("ns", "ng", "p"):
        np.testing.assert_allclose(got[k].numpy()[vox], np.asarray(want[k])[vox], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    n = got["ns"].numpy()[vox]
    assert ((np.abs(n) == 1.0).sum(1) == 1).all()  # an axis normal
    assert ((n * rd[vox]).sum(1) < 0).all()  # facing the ray


def test_lod_render_matches_reference(reference_native):
    """The LOD grid (lod_depth 6, background 2.0, as
    test_lod_render_is_finite_and_close) rendered by both packages: finite,
    not black, and within the full-image radiance bounds."""
    js, ts, cam = _setup("grid")
    js = js.replace(bg=jnp.asarray([2.0, 2.0, 2.0], jnp.float32))
    ts = Scene({**ts.arrays, "bg": torch.tensor([2.0, 2.0, 2.0])}, ts.static, ts.device)
    jl = jvox.enable_voxel_lod(js, lod_depth=6)
    tl = tvox.enable_voxel_lod(ts, lod_depth=6)
    jc = jcam.PinholeCamera(**dataclasses.asdict(cam))
    want = np.asarray(jax_render_image(jl, jc, spp=4, max_depth=3, rr_depth=2))
    got = render_image(tl, cam, spp=4, max_depth=3, rr_depth=2).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.0
    rel = np.abs(got - want) / (np.abs(want) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3, (rel > 2e-2).mean()
    assert rel.mean() < 3e-3, rel.mean()
    # the voxels are there: the same render without LOD differs
    assert np.abs(render_image(ts, cam, spp=4, max_depth=3, rr_depth=2).numpy() - got).max() > 0.0


def test_bridge_carries_a_lod_scene(reference_native):
    """A JAX LOD scene comes across with its annotation and lod_depth, and
    K1's records of the tree the port bakes from them: the same scene as
    the port's own enable_voxel_lod."""
    jl, tl = _lod("knot", KERNEL_LOD)
    via = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jl.arrays), jl.static, "cpu")
    assert via.static == tl.static
    assert sorted(via.arrays) == sorted(tl.arrays)
    for k in ("nodes_voxel_mtl", "nodes_depth", "lod_depth", "bvh_nodes", "bvh_prims"):
        assert via[k].dtype == tl[k].dtype, k
        np.testing.assert_array_equal(via[k].numpy(), tl[k].numpy(), err_msg=k)
    ro, rd = _rays("knot", n=256)
    for k, v in _port(via, ro, rd, "auto").items():
        np.testing.assert_array_equal(v, _port(tl, ro, rd, "auto")[k], err_msg=k)
    # a bake of another depth through the bridge, and K1's records of it
    j9 = jl.replace(lod_depth=jnp.asarray(9, jnp.int32))
    via9 = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, j9.arrays), j9.static, "cpu")
    assert via9["lod_bake_depth"] == 9
    own9 = tvox.enable_voxel_lod(_setup("knot")[1], lod_depth=9)
    np.testing.assert_array_equal(via9["bvh_nodes"].numpy(), own9["bvh_nodes"].numpy())
    # with_bvh_layout rebuilds the same records from the scene's own bake
    np.testing.assert_array_equal(with_bvh_layout(own9)["bvh_nodes"].numpy(),
                                  own9["bvh_nodes"].numpy())
