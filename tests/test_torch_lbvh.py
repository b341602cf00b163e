"""aten_tpu_torch's LBVH (accel/lbvh.py) and its K1 records
(ops/bvh_layout.py::lbvh_preorder, lbvh_layout) against aten_tpu's LBVH.

- `tri_boxes`, `morton3d` and every `build_lbvh` array equal the
  reference's bitwise (the reference run op by op, which gives its
  jitted arrays: integer work, min/max and no contractible product), on
  a random soup, on duplicate centroids, on groups of equal centroids
  and on P = 2;
- the preorder renumbering passes `pack_nodes`'s own checks, and the
  records packed on the tensors' device equal the numpy packing;
- K1's plain version on the renumbered records walks the oracle walk's
  node sequence over the LBVH's own arrays: hits and step counts equal;
- `apply_pose` then `traverse(impl="auto")` on a skinned knot of more
  than 512 prims agrees with the reference's `apply_pose` then
  `traverse(impl="jax")` (prim agreement >= 0.999, t within 1e-4), and no
  kernel layout of the bind pose survives."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aten_tpu.accel import lbvh as jlbvh
from aten_tpu.accel.traverse import traverse as jtraverse
from aten_tpu.anim import animation as janim
from aten_tpu.anim import skeleton as jskel
from aten_tpu.anim import skinning as jskin
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import lbvh
from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plain, traverse
from aten_tpu_torch.anim import animation as tanim
from aten_tpu_torch.anim import skeleton as tskel
from aten_tpu_torch.anim.skeleton import skinning_palette
from aten_tpu_torch.anim.skinning import DeformableMesh, apply_pose
from aten_tpu_torch.core.camera import generate_ray
from aten_tpu_torch.ops import bvh_layout
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import (
    BVH_KEYS, SceneBuilder, with_bvh_layout, with_plk_layout, with_trl_layout)

torch.set_num_threads(1)


def _soup(n=300, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tris = c[:, None, :] + rng.uniform(-0.4, 0.4, (n, 3, 3)).astype(np.float32)
    return tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]


def _boxes(case):
    """(bmin, bmax) float32 of each case; the soup's from tri_boxes."""
    if case == "soup":
        v0, e1, e2 = _soup()
        got = lbvh.tri_boxes(*(torch.from_numpy(a) for a in (v0, e1, e2)))
        ref = jlbvh.tri_boxes(*(jnp.asarray(a) for a in (v0, e1, e2)))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return tuple(a.numpy() for a in got)
    if case == "duplicates":  # all centroids equal: the index-bit fallback
        return np.zeros((64, 3), np.float32), np.ones((64, 3), np.float32)
    if case == "pairs":  # groups of equal centroids among distinct ones
        rng = np.random.default_rng(8)
        c = np.repeat(rng.uniform(-3, 3, (50, 3)), 3, axis=0).astype(np.float32)
        return c - 0.1, c + 0.1
    return (np.array([[0, 0, 0], [2, 0, 0]], np.float32),
            np.array([[1, 1, 1], [3, 1, 1]], np.float32))


CASES = ["soup", "duplicates", "pairs", "two"]


@pytest.mark.parametrize("case", CASES)
def test_build_lbvh_matches_reference(case):
    bmin, bmax = _boxes(case)
    cent = (bmin + bmax) * 0.5
    lo, hi = bmin.min(0), bmax.max(0)
    codes = lbvh.morton3d(*(torch.from_numpy(a) for a in (cent, lo, hi)))
    ref_codes = jlbvh.morton3d(*(jnp.asarray(a) for a in (cent, lo, hi)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes).astype(np.int64))
    got = lbvh.build_lbvh(torch.from_numpy(bmin), torch.from_numpy(bmax))
    ref = jlbvh.build_lbvh(jnp.asarray(bmin), jnp.asarray(bmax))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        r = np.asarray(ref[k])
        assert v.numpy().dtype == r.dtype, k
        np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
    P = bmin.shape[0]
    assert sorted(got["prim_order"].tolist()) == list(range(P))


def test_build_lbvh_refuses_one_prim():
    with pytest.raises(ValueError, match="at least 2"):
        lbvh.build_lbvh(torch.zeros(1, 3), torch.ones(1, 3))


@pytest.mark.parametrize("case", CASES)
def test_preorder_renumbering_passes_pack_nodes(case):
    bmin, bmax = _boxes(case)
    P = bmin.shape[0]
    tree = lbvh.build_lbvh(torch.from_numpy(bmin), torch.from_numpy(bmax))
    pre = {k: v.numpy() for k, v in bvh_layout.lbvh_preorder(tree, lbvh.depth_bound(P)).items()}
    K = 2 * P - 1
    inner = pre["nodes_prim_start"] < 0
    np.testing.assert_array_equal(pre["nodes_hit"][inner], np.nonzero(inner)[0] + 1)
    # the same boxes and leaves, renumbered: a permutation of the LBVH's nodes
    key = np.concatenate([pre["nodes_bmin"], pre["nodes_bmax"]], 1)
    ref_key = np.concatenate([tree["nodes_bmin"].numpy(), tree["nodes_bmax"].numpy()], 1)
    assert sorted(map(tuple, key)) == sorted(map(tuple, ref_key))
    assert (pre["nodes_miss"] == -1).sum() >= 1 and pre["nodes_miss"].max() < K
    # pack_nodes raises unless internal hit links are i + 1 and leaves' hit
    # equal miss; the device packing equals it word for word
    geo = _soup(P)
    sph = (np.zeros((1, 3), np.float32), np.zeros(1, np.float32))
    rec = bvh_layout.build_bvh_layout(pre, *geo, *sph, P)
    lay = bvh_layout.lbvh_layout(tree, lbvh.depth_bound(P),
                                 *(torch.from_numpy(a) for a in geo + sph), P)
    for k in bvh_layout.ARRAY_KEYS:
        np.testing.assert_array_equal(lay[k].numpy().view(np.int32), rec[k].view(np.int32))
    _, _, hit, miss, _, start, count = bvh_layout.unpack_nodes(lay["bvh_nodes"].numpy())
    np.testing.assert_array_equal(hit, pre["nodes_hit"])
    np.testing.assert_array_equal(miss, pre["nodes_miss"])
    np.testing.assert_array_equal(start, pre["nodes_prim_start"])


def _mixed_scene(n=600, seed=5):
    """A soup of n triangles and 40 spheres, built on the CPU."""
    v0, e1, e2 = _soup(n, seed)
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    tris = np.stack([v0, v0 + e1, v0 + e2], 1)
    b.add_mesh(tris.reshape(-1, 3), np.arange(3 * n).reshape(-1, 3), m)
    rng = np.random.default_rng(seed + 1)
    for c in rng.uniform(-4, 4, (40, 3)):
        b.add_sphere(c, float(rng.uniform(0.1, 0.4)), m)
    return b.build("cpu")


def _rays(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro), torch.from_numpy(rd)


def test_k1_plain_on_the_records_walks_the_lbvh_oracle():
    scene = lbvh.rebuild_scene_bvh(_mixed_scene())
    assert "traversal" not in scene
    ro, rd = _rays()
    dist = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 8, ro.shape[0]).astype(
        np.float32))
    for any_hit, t_max, t_min in ((False, None, 1e-4), (True, dist, 1e-3)):
        t0 = _t0_of(t_max, ro.shape[0], ro.device)
        oracle = _traverse_plain(scene, ro, rd, t0, any_hit, t_min)  # the LBVH's own arrays
        k1 = _traverse_plain(scene, ro, rd, t0, any_hit, t_min, baked=True)  # the records
        for k in ("t", "prim", "u", "v", "steps"):
            assert torch.equal(oracle[k], k1[k]), (any_hit, k)
        assert int((oracle["prim"] >= scene["num_tris"]).sum()) > 20  # spheres hit
    h = traverse(scene, ro, rd)  # K1's wrapper on CPU tensors
    assert torch.equal(h["prim"], _traverse_plain(scene, ro, rd, _t0_of(None, 3000, "cpu"),
                                                  False, 1e-4)["prim"])


def test_lbvh_matches_sah_traversal():
    scene = _mixed_scene()
    rebuilt = lbvh.rebuild_scene_bvh(scene)
    ro, rd = _rays()
    h_sah, h_lb = traverse(scene, ro, rd), traverse(rebuilt, ro, rd)
    assert torch.equal(h_sah["prim"], h_lb["prim"])
    np.testing.assert_allclose(h_lb["t"].numpy(), h_sah["t"].numpy(), rtol=1e-6)
    # the rebuilt tree's records are K1's of the LBVH of the same prims
    assert not torch.equal(rebuilt["nodes_hit"], scene["nodes_hit"])
    for k in ("tri_v0", "sph_center", "materials"):
        assert rebuilt[k] is scene[k]


def _rig_objects(mods, rig):
    skel_mod, anim_mod = mods
    skel = skel_mod.Skeleton(rig["parents"], rig["bind_t"], rig["bind_q"], rig["bind_s"])
    return skel, anim_mod.AnimationClip.from_tracks(rig["tracks"])


def test_apply_pose_matches_reference_and_drops_bind_layouts():
    rig = chip_smoke.knot_rig(40, 10)
    b, jb = SceneBuilder(), JaxSceneBuilder()
    dm, cam = chip_smoke.populate_skinned_knot(b, DeformableMesh.attach, rig, 32, 32)
    jdm, _ = chip_smoke.populate_skinned_knot(jb, jskin.DeformableMesh.attach, rig, 32, 32)
    scene = b.build("cpu")
    assert scene["num_tris"] == 804 and "traversal" not in scene
    # every kernel layout of the bind pose: K1's (the build's), K3's, K4's
    bind = with_trl_layout(with_plk_layout(scene))
    assert all(k in bind for k in ("bvh_nodes", "plk_nodes", "trl_nodes"))
    bind = type(bind)(bind.arrays, {**bind.static, "traversal": "smt", "trl_window": 64},
                      bind.device)
    skel, clip = _rig_objects((tskel, tanim), rig)
    jsk, jclip = _rig_objects((jskel, janim), rig)
    inv = skel.inverse_bind()
    t = 0.37
    pal = skinning_palette(skel, *clip.sample(t), torch.from_numpy(inv))
    jpal = jskel.skinning_palette(jsk, *jclip.sample(t), jnp.asarray(inv))
    np.testing.assert_allclose(pal.numpy(), np.asarray(jpal), rtol=1e-6, atol=1e-6)
    posed = apply_pose(bind, dm, pal)
    js = jskin.apply_pose(jb.build().drop("pl_nodes", "pl_prims", "pl_meta"), jdm, jpal)
    # no layout of the bind pose survives; K1's records describe the pose
    assert not any(k.startswith(("plk_", "trl_")) for k in posed.arrays)
    assert not any(k in posed for k in ("traversal", "plk_window", "trl_window"))
    host = {k: posed[k].numpy() for k in BVH_KEYS}
    rec = bvh_layout.build_bvh_layout(
        {k: v.numpy() for k, v in bvh_layout.lbvh_preorder(
            {k: posed[k] for k in BVH_KEYS}, lbvh.depth_bound(808)).items()},
        *(posed[k].numpy() for k in ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")),
        804)
    for k in bvh_layout.ARRAY_KEYS:
        np.testing.assert_array_equal(posed[k].numpy().view(np.int32), rec[k].view(np.int32))
    assert not np.array_equal(posed["bvh_prims"].numpy(), bind["bvh_prims"].numpy())
    for name in ("tri_v0", "tri_e1", "tri_e2"):
        np.testing.assert_allclose(posed[name].numpy(), np.asarray(js[name]),
                                   rtol=1e-5, atol=1e-5)
    moved = np.abs(posed["tri_v0"].numpy()[:800] - scene["tri_v0"].numpy()[:800]).max()
    assert moved > 0.05  # the pose moves the knot
    # the layouts of the tree are refused, not built over it
    for attach in (with_plk_layout, with_trl_layout, with_bvh_layout):
        with pytest.raises(ValueError, match="not in preorder"):
            attach(posed)
    # traversal: the port's K1 path against the reference's threaded walk
    w, h = 32, 32
    s, tt = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
    ro, rd = generate_ray(cam.arrays("cpu"), torch.tensor(s.reshape(-1), dtype=torch.float32),
                          torch.tensor(tt.reshape(-1), dtype=torch.float32))
    sro, srd = _rays(2000, 3)
    ro, rd = torch.cat([ro, sro * 0.5 + torch.tensor([0.0, 1.7, 0.0])]), torch.cat([rd, srd])
    got = traverse(posed, ro, rd)
    ref = jtraverse(js, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), impl="jax")
    gp, rp = got["prim"].numpy(), np.asarray(ref["prim"])
    assert (gp == rp).mean() >= 0.999, (gp == rp).mean()
    both = (gp == rp) & (rp >= 0)
    np.testing.assert_allclose(got["t"].numpy()[both], np.asarray(ref["t"])[both],
                               rtol=1e-4, atol=1e-4)
    assert (rp[:w * h] >= 0).mean() > 0.2 and (rp[:w * h] < 800).any()
    # bitwise: K1's plain version on the records against the oracle walk
    t0 = _t0_of(None, ro.shape[0], "cpu")
    a = _traverse_plain(posed, ro, rd, t0, False, 1e-4)
    b2 = _traverse_plain(posed, ro, rd, t0, False, 1e-4, baked=True)
    assert all(torch.equal(a[k], b2[k]) for k in ("t", "prim", "u", "v", "steps"))


def test_rebuild_refuses_instanced_and_lod_scenes():
    from aten_tpu_torch.accel.voxel import enable_voxel_lod

    scene = _mixed_scene(100)
    with pytest.raises(ValueError, match="voxel-LOD"):
        lbvh.rebuild_scene_bvh(enable_voxel_lod(scene, lod_depth=2))
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    o = b.create_object()
    b.add_sphere((0, 0, 0), 1.0, m, obj=o)
    b.add_instance(o, np.eye(4))
    with pytest.raises(ValueError, match="instances"):
        lbvh.rebuild_scene_bvh(b.build("cpu"))
