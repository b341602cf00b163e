"""BVH voxel LOD: interior nodes that hit as solid boxes.

Counterpart of aten_tpu/accel/voxel.py (the reference's SBVH voxels,
sbvh.h:11-14 and sbvh_voxel.cpp:14-148, and the traverser's LOD hit,
threaded_bvh_traverser.h:221-277), on numpy, host-side.

An interior node at a depth that is a non-zero multiple of
`voxel_depth` is a voxel: it carries the material covering the largest
area of its subtree (`nodes_voxel_mtl` [K] int32, -1 elsewhere), and
`nodes_depth` [K] int32 holds every node's depth.  A ray that hits a
voxel whose depth is at least the scene's `lod_depth` records a hit on
the box at its entry t, with the global id `num_tris + num_spheres +
node`, and skips the subtree.

The oracle walk (accel/traverse.py::_traverse_plain) reads the threshold
from the scene's `lod_depth` tensor.  The kernels read a layout baked at
one threshold (ops/lod_layout.py::bake_lod_tree): `enable_voxel_lod`
builds it and records the depth in the static `lod_bake_depth`, and a
kernel wrapper raises when `lod_depth` no longer equals it.  Call
`enable_voxel_lod` again to bake another threshold.
"""
from __future__ import annotations

import time

import numpy as np

VOXEL_DEPTH = 3  # reference sbvh.h:11 VoxelDepth

# the Scene arrays the annotation adds
ARRAY_KEYS = ("nodes_voxel_mtl", "nodes_depth", "lod_depth")


def node_depths(nodes_hit, nodes_miss, nodes_prim_start):
    """[K] int32 depth of every node of a preorder threaded tree.

    The children of internal node i are i + 1 and miss(i + 1) (the left
    child's skip link is its right sibling, accel/build.py)."""
    miss = np.asarray(nodes_miss).tolist()
    internal = (np.asarray(nodes_prim_start) < 0).tolist()
    K = len(miss)
    depth = [-1] * K
    stack = [(0, 0)]
    while stack:
        i, d = stack.pop()
        if i < 0 or i >= K or depth[i] >= 0:
            continue
        depth[i] = d
        if internal[i]:
            left = i + 1
            stack.append((left, d + 1))
            right = miss[left]
            if right >= 0:
                stack.append((right, d + 1))
    return np.asarray(depth, np.int32)


def annotate_voxels(tree, prim_mtl, prim_area, voxel_depth=VOXEL_DEPTH):
    """(nodes_voxel_mtl, nodes_depth), both [K] int32, of a threaded BVH
    (`nodes_*` and `prim_order`), in the reference's arithmetic
    (accel/voxel.py:55-122).

    prim_mtl [P] int32 and prim_area [P] float32 per global prim id.  A
    node is a voxel iff it is internal, its depth is a non-zero multiple
    of voxel_depth, and its subtree holds prims; its material is the one
    with the largest summed area there, each prim reference weighted by
    area / its reference count (an SBVH split may list a prim twice)."""
    miss = np.asarray(tree["nodes_miss"], np.int64)
    ps = np.asarray(tree["nodes_prim_start"], np.int64)
    pc = np.asarray(tree["nodes_prim_count"], np.int64)
    order = np.asarray(tree["prim_order"])
    K = miss.shape[0]
    depth = node_depths(tree["nodes_hit"], miss, ps)
    vox_mtl = np.full(K, -1, np.int32)

    prim_mtl = np.asarray(prim_mtl)
    prim_area = np.asarray(prim_area, np.float64)
    num_mtl = int(prim_mtl.max()) + 1 if prim_mtl.size else 1
    slot_mtl = prim_mtl[order]
    ref_count = np.bincount(order, minlength=prim_area.shape[0]).astype(np.float64)
    slot_area = prim_area[order] / np.maximum(ref_count[order], 1.0)
    # first prim slot of each node's subtree: the leaves' ranges in preorder
    first_slot = np.zeros(K + 1, np.int64)
    first_slot[1:] = np.cumsum(np.where(ps >= 0, pc, 0))
    acc = int(first_slot[K])
    cum = np.zeros((acc + 1, num_mtl), np.float64)
    np.add.at(cum[1:], (np.arange(acc), slot_mtl), slot_area)
    cum = np.cumsum(cum, axis=0)

    node = np.arange(K)
    cand = np.nonzero((node > 0) & (ps < 0) & (depth > 0) & (depth % voxel_depth == 0))[0]
    end = np.where(miss[cand] >= 0, miss[cand], K)
    lo, hi = first_slot[cand], first_slot[end]
    cand, lo, hi = cand[hi > lo], lo[hi > lo], hi[hi > lo]
    vox_mtl[cand] = np.argmax(cum[hi] - cum[lo], axis=1)
    return vox_mtl, depth


def prim_materials(scene):
    """(prim_mtl [P] int32, prim_area [P] float32) per global prim id of a
    built scene: triangles, then spheres (area 4 pi r^2)."""
    nt, ns = scene["num_tris"], scene["num_spheres"]
    host = {k: scene[k].cpu().numpy() for k in ("tri_mtl", "tri_area", "sph_mtl", "sph_radius")}
    r = host["sph_radius"][:ns]
    mtl = np.concatenate([host["tri_mtl"][:nt], host["sph_mtl"][:ns]]).astype(np.int32)
    area = np.concatenate([host["tri_area"][:nt], 4.0 * np.pi * r * r]).astype(np.float32)
    return mtl, area


def enable_voxel_lod(scene, lod_depth=VOXEL_DEPTH, voxel_depth=VOXEL_DEPTH, log=None):
    """A new Scene with the voxel annotation (ARRAY_KEYS, `lod_depth` an
    int32 scalar tensor), the statics `has_voxel_lod` and
    `lod_bake_depth`, and, in place of the scene's own kernel layout, the
    one the kernel policy runs (scene/scene.py::kernel_layouts) over the
    tree baked at `lod_depth`.  Single-level scenes only, as in the
    reference.  `log`, if given, receives a line with the annotation's
    and the bake's seconds."""
    from aten_tpu_torch.ops.lod_layout import baked_tree
    from aten_tpu_torch.scene.scene import (
        Scene, host_bvh, kernel_layouts, to_tensors, without_kernel_layouts)

    t0 = time.perf_counter()
    host = host_bvh(scene, "voxel LOD")
    vox_mtl, depth = annotate_voxels(host, *prim_materials(scene), voxel_depth)
    t1 = time.perf_counter()
    baked, vox = baked_tree(host, vox_mtl, depth, int(lod_depth),
                            scene["num_tris"] + scene["num_spheres"])
    lay, lay_static = kernel_layouts(baked, host, scene["num_tris"], vox=vox)
    t2 = time.perf_counter()
    if log is not None:
        log(f"voxel LOD at lod_depth {int(lod_depth)}: annotation {t1 - t0:.2f} s over "
            f"{depth.shape[0]} nodes ({int((vox_mtl >= 0).sum())} voxels); bake and "
            f"{lay_static.get('traversal', 'K1')} layout {t2 - t1:.2f} s: "
            f"{int((vox >= 0).sum())} voxel leaves in {vox.shape[0]} baked nodes")
    scene = without_kernel_layouts(scene)
    arrays = {**scene.arrays, **to_tensors(
        {"nodes_voxel_mtl": vox_mtl, "nodes_depth": depth,
         "lod_depth": np.asarray(int(lod_depth), np.int32), **lay}, scene.device)}
    static = {**scene.static, **lay_static, "has_voxel_lod": True,
              "lod_bake_depth": int(lod_depth)}
    return Scene(arrays, static, scene.device)
