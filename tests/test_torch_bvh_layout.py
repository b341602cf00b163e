"""The packed node and prim records of K1 and K3 (ops/bvh_layout.py).

* Unpacking gives back the arrays they were packed from, bit for bit:
  `nodes_*`, `prim_order`, `tri_*` and `sph_*` of K1's layout on the
  2,004-prim knot (built by aten_tpu and handed over by the bridge, and
  by the port's own builder) and on the Cornell box (spheres).  K3's
  packed cut tree is held to its `plk_*` arrays in
  tests/test_torch_plk.py.
* The packer raises on a tree that breaks the preorder link facts the
  records rely on (an inner node's hit link is i + 1, a leaf's equals its
  miss link) and on a leaf range that does not pack.  K1's and K5's leaf
  word keeps its 7-bit count and starts up to 2^24 - 1; only K3's (and
  K4's, packed in its kernel) takes 8 bits for windows of 128 slots, and
  so starts below 2^23.
* The scene builder and the bridge attach the records exactly where the
  kernel policy runs K1 (`bvh_*`) or K3 (`plk_nodes`); `with_bvh_layout`
  attaches K1's to a scene built for K3 or K4, as the lab's tables do.
"""
import jax
import numpy as np
import pytest
import torch

from aten_tpu.scene import scenedefs as jdefs
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.ops import bvh_layout, plk_layout, tlas_layout, traverse_cuda, trl_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.scene import Scene, with_bvh_layout, with_trl_layout
from aten_tpu_torch.tools import first_design_ab, kernel_lab
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

KNOT = {"n_u": 40, "n_v": 25}  # 2,000 knot triangles + 4: 2,004 prims


def _np(scene, k):
    return scene[k].numpy()


def _scene(name):
    if name == "knot2k":
        return tdefs.procedural_mesh_scene(16, 16, **KNOT, device="cpu")[0]
    if name == "knot2k_bridge":
        b = JaxSceneBuilder()
        tdefs.populate_procedural_mesh_scene(b, 16, 16, **KNOT)
        js = b.build()
        return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    return tdefs.cornell_box(16, 16, device="cpu")[0]


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["knot2k", "knot2k_bridge", "cornell"])
def test_k1_records_unpack_bit_for_bit(name):
    s = _scene(name)
    nodes, prims = _np(s, "bvh_nodes"), _np(s, "bvh_prims")
    K, P = s["nodes_hit"].shape[0], s["prim_order"].shape[0]
    assert nodes.shape == (K, bvh_layout.NODE_WORDS) and nodes.dtype == np.float32
    assert prims.shape == (P, bvh_layout.PRIM_WORDS) and prims.dtype == np.float32
    bmin, bmax, hit, miss, leaf, start, count = bvh_layout.unpack_nodes(nodes)
    np.testing.assert_array_equal(_bits(bmin), _bits(_np(s, "nodes_bmin")))
    np.testing.assert_array_equal(_bits(bmax), _bits(_np(s, "nodes_bmax")))
    np.testing.assert_array_equal(hit, _np(s, "nodes_hit"))
    np.testing.assert_array_equal(miss, _np(s, "nodes_miss"))
    ps = _np(s, "nodes_prim_start")
    np.testing.assert_array_equal(start, np.where(ps >= 0, ps, -1))
    np.testing.assert_array_equal(count, np.where(ps >= 0, _np(s, "nodes_prim_count"), 0))
    assert ((leaf >= 0) == (ps >= 0)).all()
    # prim records in leaf order, ids resolved at build time
    ids = prims.view(np.int32)[:, 3]
    np.testing.assert_array_equal(ids, _np(s, "prim_order"))
    T = s["num_tris"]
    tri, sph = ids < T, ids >= T
    for k, cols in (("tri_v0", slice(0, 3)), ("tri_e1", slice(4, 7)), ("tri_e2", slice(8, 11))):
        np.testing.assert_array_equal(_bits(prims[tri, cols]), _bits(_np(s, k)[ids[tri]]))
    np.testing.assert_array_equal(_bits(prims[sph, 0:3]), _bits(_np(s, "sph_center")[ids[sph] - T]))
    np.testing.assert_array_equal(_bits(prims[sph, 4]), _bits(_np(s, "sph_radius")[ids[sph] - T]))
    assert sph.sum() == s["num_spheres"] and tri.sum() == T
    # the words the records leave free are zero
    free = np.ones(bvh_layout.PRIM_WORDS, bool)
    free[[0, 1, 2, 3]] = False
    free[[4, 5, 6, 8, 9, 10]] = False
    assert not prims[:, free].any()
    assert not prims[sph][:, [5, 6, 8, 9, 10]].any()


def _chain():
    """A four-node tree in preorder: root, leaf, inner, leaf (the inner
    node holding one leaf), with valid links and ranges."""
    bmin = np.zeros((4, 3), np.float32)
    bmax = np.ones((4, 3), np.float32)
    hit = np.array([1, 2, 3, -1])
    miss = np.array([-1, 2, -1, -1])
    start = np.array([-1, 0, -1, 1])
    count = np.array([0, 1, 0, 2])
    return bmin, bmax, hit, miss, start, count, start >= 0


def test_packer_accepts_a_preorder_tree():
    rec = bvh_layout.pack_nodes(*_chain())
    bmin, bmax, hit, miss, leaf, start, count = bvh_layout.unpack_nodes(rec)
    np.testing.assert_array_equal(hit, [1, 2, 3, -1])
    np.testing.assert_array_equal(leaf, [-1, 1, -1, (1 << bvh_layout.LEAF_SHIFT) | 2])
    np.testing.assert_array_equal(start, [-1, 0, -1, 1])
    np.testing.assert_array_equal(count, [0, 1, 0, 2])


@pytest.mark.parametrize("fault,match", [
    ("inner_hit", "not the next node"),
    ("leaf_hit", "must be equal"),
    ("count", "does not pack"),
    ("start", "does not pack"),
])
def test_packer_raises_on_broken_links(fault, match):
    bmin, bmax, hit, miss, start, count, is_leaf = _chain()
    if fault == "inner_hit":
        hit[2] = 1  # an inner node whose hit link is not i + 1
    elif fault == "leaf_hit":
        hit[1] = 3  # a leaf whose hit link is not its miss link
    elif fault == "count":
        count[3] = bvh_layout.LEAF_COUNT + 1
    else:
        start[3] = bvh_layout.MAX_START
    with pytest.raises(ValueError, match=match):
        bvh_layout.pack_nodes(bmin, bmax, hit, miss, start, count, is_leaf)


@pytest.mark.parametrize("shift,max_start,max_count", [
    (bvh_layout.LEAF_SHIFT, 1 << 24, 127),          # K1, K5: prim ranges
    (bvh_layout.TREELET_LEAF_SHIFT, 1 << 23, 255),  # K3, K4: up to 128 slots
])
def test_packer_start_and_count_limits(shift, max_start, max_count):
    """A leaf at the last start and count that pack round-trips bit for
    bit; one start or one count past them raises."""
    assert (1 << (31 - shift), (1 << shift) - 1) == (max_start, max_count)
    bmin, bmax, hit, miss, start, count, is_leaf = _chain()
    start[3], count[3] = max_start - 1, max_count
    rec = bvh_layout.pack_nodes(bmin, bmax, hit, miss, start, count, is_leaf, shift=shift)
    _, _, _, _, leaf, got_start, got_count = bvh_layout.unpack_nodes(rec, shift=shift)
    assert (leaf[3], got_start[3], got_count[3]) == (
        ((max_start - 1) << shift) | max_count, max_start - 1, max_count)
    for field, value in (("start", max_start), ("count", max_count + 1)):
        s, c = start.copy(), count.copy()
        (s if field == "start" else c)[3] = value
        with pytest.raises(ValueError, match="does not pack"):
            bvh_layout.pack_nodes(bmin, bmax, hit, miss, s, c, is_leaf, shift=shift)
    if shift == bvh_layout.LEAF_SHIFT:
        assert bvh_layout.MAX_START == max_start  # K1's and K5's capacity
    else:
        assert bvh_layout.TREELET_MAX_START == max_start


def test_builder_checks_every_tree_it_packs():
    """build_bvh_layout raises on a BVH whose links break preorder."""
    s = _scene("knot2k")
    bvh = {k: _np(s, k).copy() for k in bridge.BVH_KEYS}
    inner = int(np.nonzero(bvh["nodes_prim_start"] < 0)[0][1])
    bvh["nodes_hit"][inner] = bvh["nodes_miss"][inner]
    with pytest.raises(ValueError, match="not the next node"):
        bvh_layout.build_bvh_layout(bvh, _np(s, "tri_v0"), _np(s, "tri_e1"), _np(s, "tri_e2"),
                                    _np(s, "sph_center"), _np(s, "sph_radius"), s["num_tris"])


# (policy, scene): whether K1's records, K3's and K4's layout or K5's
# records are attached
_POLICY_CASES = [
    ("v3", "mesh102k", "k1"), ("mt", "mesh102k", "k1"), ("plk", "mesh102k", "k3"),
    ("smt", "mesh102k", "k4"), ("v3", "knot2k", "k1"), ("smt", "knot2k", "k1"),
    ("plk", "knot2k", "k1"), ("v3", "cornell", "k1"), ("v3", "instanced", "k5"),
    ("smt", "instanced", "k5"),
]


@pytest.mark.parametrize("policy,name,kernel", _POLICY_CASES)
def test_builder_attaches_records_where_the_policy_runs_the_kernel(monkeypatch, policy, name,
                                                                   kernel):
    monkeypatch.setattr(ttrav, "KERNEL", policy)
    s = {"mesh102k": lambda: tdefs.procedural_mesh_scene(8, 8, device="cpu"),
         "knot2k": lambda: tdefs.procedural_mesh_scene(8, 8, **KNOT, device="cpu"),
         "cornell": lambda: tdefs.cornell_box(8, 8, device="cpu"),
         "instanced": lambda: tdefs.instanced_mesh_scene(8, 8, n_u=40, n_v=25, device="cpu"),
         }[name]()[0]
    assert all((k in s) == (kernel == "k1") for k in bvh_layout.ARRAY_KEYS)
    assert ("plk_nodes" in s) == (kernel == "k3")
    assert ("trl_nodes" in s) == (kernel == "k4")
    assert all((k in s) == (kernel == "k5") for k in tlas_layout.ARRAY_KEYS)
    assert s.get("traversal") == {"k3": "plk", "k4": "smt"}.get(kernel)
    # the original arrays stay: the plain walks and the first design read them
    first = {"k1": first_design_ab.BVH_ARRAYS, "k3": first_design_ab.PLK_ARRAYS,
             "k4": first_design_ab.TRL_ARRAYS, "k5": first_design_ab.TLAS_ARRAYS}
    assert all(k in s for k in first.get(kernel, ()))
    if kernel == "k1":
        assert ttrav.traverse(s, torch.zeros(1, 3), torch.tensor([[0.0, 0.0, -1.0]]),
                              impl="cuda")["t"].shape == (1,)


@pytest.mark.parametrize("name", ["cornell", "instanced"])
def test_bridge_attaches_records_to_single_level_scenes(name):
    if name == "cornell":
        js = jdefs.cornell_box(16, 16)[0]
    else:
        b = JaxSceneBuilder()
        tdefs.populate_instanced_mesh_scene(b, 8, 8, n_u=40, n_v=25)
        js = b.build()
    s = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    single = name == "cornell"
    assert all((k in s) == single for k in bvh_layout.ARRAY_KEYS)
    assert all((k in s) != single for k in tlas_layout.ARRAY_KEYS)
    assert not any(k in s for k in plk_layout.ARRAY_KEYS + trl_layout.ARRAY_KEYS)


@pytest.mark.parametrize("policy", ["smt", "plk"])
def test_lab_tables_attach_k1_records_to_a_k3_or_k4_scene(monkeypatch, policy):
    """The lab's scene built under `smt` (K4) or `plk` (K3) carries no K1
    records; its tables attach them, equal bit for bit to those of the
    default build, and the wrapper accepts them."""
    monkeypatch.setattr(ttrav, "KERNEL", "v3")
    ref = tdefs.procedural_mesh_scene(8, 8, device="cpu")[0]
    monkeypatch.setattr(ttrav, "KERNEL", policy)
    s = tdefs.procedural_mesh_scene(8, 8, device="cpu")[0]
    assert s["traversal"] == policy and not any(k in s for k in bvh_layout.ARRAY_KEYS)
    lab = kernel_lab.tables(s if policy == "smt" else with_trl_layout(s))["scene"]
    assert lab.get("traversal") == policy
    for k in bvh_layout.ARRAY_KEYS:
        np.testing.assert_array_equal(_bits(_np(lab, k)), _bits(_np(ref, k)), err_msg=k)
    assert len(traverse_cuda._packed(lab, traverse_cuda._SCENE_FIELDS, lab.device)) == 2


def test_with_bvh_layout_refuses_instanced_scenes():
    s = tdefs.instanced_mesh_scene(8, 8, n_u=40, n_v=25, device="cpu")[0]
    with pytest.raises(ValueError, match="single-level"):
        with_bvh_layout(s)


def test_wrapper_checks_the_records():
    """The wrapper names missing or misaligned records (the checks it
    makes before a launch; on the CPU it then runs the plain walk)."""
    s = _scene("knot2k")
    dev = torch.device("cpu")
    assert len(traverse_cuda._packed(s, traverse_cuda._SCENE_FIELDS, dev)) == 2
    missing = Scene({k: v for k, v in s.arrays.items() if k != "bvh_prims"}, s.static, dev)
    with pytest.raises(ValueError, match="bvh_prims"):
        traverse_cuda._packed(missing, traverse_cuda._SCENE_FIELDS, dev)
    nodes = s["bvh_nodes"]
    shifted = torch.empty(nodes.numel() + 1)[1:].view(nodes.shape)
    shifted.copy_(nodes)
    bad = Scene({**s.arrays, "bvh_nodes": shifted}, s.static, dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        traverse_cuda._packed(bad, traverse_cuda._SCENE_FIELDS, dev)
    wrong = Scene({**s.arrays, "bvh_prims": s["bvh_prims"][:, :8].contiguous()}, s.static, dev)
    with pytest.raises(ValueError, match="bvh_prims"):
        traverse_cuda._packed(wrong, traverse_cuda._SCENE_FIELDS, dev)
