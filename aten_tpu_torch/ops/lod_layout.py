"""The voxel-LOD tree the kernels walk (the `has_lod` variants of K1, K3, K4).

Counterpart of aten_tpu/ops/traverse_pallas.py::bake_lod_tree
(:396-454), in numpy.  The oracle walk tests a voxel's depth against the
scene's `lod_depth` on every visit (accel/voxel.py); the kernels walk a
tree baked at one threshold instead: every annotated node with depth
>= lod_depth becomes a zero-prim *voxel leaf* and its subtree is gone.
The baked tree stays in preorder, its interior nodes' hit link the next
node and a voxel leaf's hit link its miss link (both = the skip link),
so ops/bvh_layout.py::pack_nodes takes it as it takes any tree.

A voxel leaf carries the global id of its voxel, `vox_base + voxid`
with vox_base = num_tris + num_spheres and voxid the node's index in the
*original* tree (the oracle's id).  Each layout stores it as the word
`VOXEL_WORD - id` (<= -2) where it otherwise keeps a leaf's range: K1's
and K3's packed leaf word (-1 on interior nodes, `start << shift | count`
>= 0 on leaves), K3's `plk_slot_start` and K4's slot-start word (-1 on
interior nodes, a slot >= 0 on fat leaves).

The prims of pruned subtrees stay in `prim_order`: a baked tree's leaf
ranges index the original order, with holes where subtrees were pruned.
"""
from __future__ import annotations

import numpy as np

VOXEL_WORD = -2  # a voxel leaf's word is VOXEL_WORD - id


def bake_lod_tree(bvh, vox_mtl, depth, lod_depth):
    """Prune a threaded BVH at its voxels of depth >= lod_depth.

    bvh: `nodes_*` and `prim_order` arrays; vox_mtl, depth [K] from
    accel/voxel.py::annotate_voxels.  Returns (baked, voxid): `baked`
    the pruned tree's `nodes_bmin`/`nodes_bmax` [K',3] float32, `nodes_hit`,
    `nodes_miss`, `nodes_prim_start`, `nodes_prim_count` [K'] int64 and
    the unchanged `prim_order` (int64); voxid [K'] int64 the original
    index of each voxel leaf, -1 elsewhere.  The same arrays, dtypes and
    values as the reference's."""
    nmiss = np.asarray(bvh["nodes_miss"], np.int64)
    nps = np.asarray(bvh["nodes_prim_start"], np.int64)
    npc = np.asarray(bvh["nodes_prim_count"], np.int64)
    K = nmiss.shape[0]
    is_vox = (np.asarray(vox_mtl) >= 0) & (np.asarray(depth) >= lod_depth)

    # the walk that skips voxels and leaves and enters every other node
    miss_l, stop_l = nmiss.tolist(), (is_vox | (nps >= 0)).tolist()
    keep = []
    i = 0
    while i != -1:
        keep.append(i)
        i = miss_l[i] if stop_l[i] else i + 1
    keep = np.asarray(keep, np.int64)
    new_of = np.full(K, -1, np.int64)
    new_of[keep] = np.arange(keep.shape[0])

    ms = nmiss[keep]
    skip = np.where(ms < 0, -1, new_of[np.maximum(ms, 0)])
    vox, leaf = is_vox[keep], nps[keep] >= 0
    inner = ~vox & ~leaf
    hit = np.where(inner, new_of[np.minimum(keep + 1, K - 1)], skip)
    return {
        "nodes_bmin": np.asarray(bvh["nodes_bmin"], np.float32)[keep],
        "nodes_bmax": np.asarray(bvh["nodes_bmax"], np.float32)[keep],
        "prim_order": np.asarray(bvh["prim_order"], np.int64),
        "nodes_hit": hit,
        "nodes_miss": skip,
        "nodes_prim_start": np.where(leaf & ~vox, nps[keep], -1),
        "nodes_prim_count": np.where(leaf & ~vox, npc[keep], 0),
    }, np.where(vox, keep, -1)


def voxel_ids(voxid, vox_base):
    """[K'] int64 global id `vox_base + voxid` of each voxel leaf, -1
    elsewhere; raises unless every word VOXEL_WORD - id fits int32."""
    voxid = np.asarray(voxid, np.int64)
    ids = np.where(voxid >= 0, vox_base + voxid, -1)
    if ids.size and int(ids.max()) > np.iinfo(np.int32).max + VOXEL_WORD:
        raise ValueError(f"voxel id {int(ids.max())} does not fit an int32 word")
    return ids


def voxel_words(words, vox):
    """`words` with each voxel leaf's (vox >= 0) replaced by VOXEL_WORD - id."""
    if vox is None:
        return words
    return np.where(vox >= 0, VOXEL_WORD - np.asarray(vox, np.int64), words)


def baked_tree(bvh, vox_mtl, depth, lod_depth, vox_base):
    """(baked tree, voxel ids) of `bake_lod_tree` with the ids of
    `voxel_ids`: the inputs of the kernel layouts' builders."""
    baked, voxid = bake_lod_tree(bvh, vox_mtl, depth, lod_depth)
    return baked, voxel_ids(voxid, vox_base)


def lod_of(scene):
    """Whether a kernel walks `scene`'s voxel-LOD tree: True for a scene
    with `has_voxel_lod`, after checking that its `lod_depth` is still the
    depth its layout was baked at (`lod_bake_depth`); raises if not,
    rather than walk a stale bake."""
    if not scene.get("has_voxel_lod"):
        return False
    depth = int(scene["lod_depth"])
    if depth != scene["lod_bake_depth"]:
        raise ValueError(f"the scene's lod_depth is {depth}, but its kernel layout was baked "
                         f"at {scene['lod_bake_depth']}: call accel.voxel.enable_voxel_lod "
                         "again to bake the new depth")
    return True
