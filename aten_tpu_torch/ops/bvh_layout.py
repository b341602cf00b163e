"""Packed node and prim records of the threaded BVH (kernels K1 and K3).

The K1 kernel (kernels/bvh_traverse.cu) and the K3 kernel
(kernels/plk_traverse.cu) read their tree as one 32-byte record per node,
16-byte aligned and read as two float4s:

    (bmin.x, bmin.y, bmin.z, miss)  (bmax.x, bmax.y, bmax.z, leaf)

`miss` and `leaf` are int32 bits.  The record needs no hit link: the tree
is laid out in preorder (accel/build.py), so an internal node's hit link
is the next node, i + 1, and a leaf's hit link equals its miss link.
`pack_nodes` checks both facts on every tree it packs and raises if one
fails.  `leaf` is -1 on an internal node; on a leaf it packs the start
and count of its range as `start << shift | count`: for K1 (and K5's
pool, ops/tlas_layout.py) the leaf's prim range in leaf order (count <=
LEAF_MAX, shift LEAF_SHIFT, starts below MAX_START = 2^24), for K3 the
fat leaf's slot range (count <= its window, at most 128, so shift
TREELET_LEAF_SHIFT, slot starts below TREELET_MAX_START = 2^23; K4
packs the same word in its kernel).  A voxel leaf of a tree baked for
voxel LOD (ops/lod_layout.py) holds `VOXEL_WORD - id` (<= -2) there
instead.

K1 also reads one 48-byte record per prim in leaf order, three float4s,
so a leaf's prims are contiguous and the kernel makes no dependent load
through `prim_order`:

    triangle  (v0.xyz, id)  (e1.xyz, 0)  (e2.xyz, 0)
    sphere    (centre.xyz, id)  (radius, 0, 0, 0)  (0, 0, 0, 0)

`id` is the global prim id as int32 bits (triangles first, then
spheres); the floats are the bits of tri_v0, tri_e1, tri_e2, sph_center
and sph_radius.  The original arrays stay in the scene: the plain walks,
`eval_hit` and the two-level kernel read them.

An LBVH (accel/lbvh.py) numbers its internal nodes [0, P-1) and its
leaves [P-1, 2P-1), not in preorder.  `lbvh_preorder` renumbers such a
tree into preorder on its device with fixed-count loops (subtree sizes
bottom-up, positions top-down, a node's miss link its position plus its
size), and `lbvh_layout` packs K1's records of the renumbered tree with
torch ops, gathering the prim records from the current triangle and
sphere arrays.  The threaded walk visits the nodes in preorder in both
numberings, so K1 on these records walks the LBVH's own arrays' node
sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.ops.lod_layout import voxel_words

NODE_WORDS = 8     # float32 words of a node record (32 B)
PRIM_WORDS = 12    # float32 words of a K1 prim record (48 B)
LEAF_SHIFT = 7     # K1's and K5's leaf counts fill the low 7 bits
LEAF_COUNT = (1 << LEAF_SHIFT) - 1
MAX_START = 1 << (31 - LEAF_SHIFT)  # starts below this pack into an int32
TREELET_LEAF_SHIFT = 8  # a fat leaf's slot count (<= 128) fills 8 bits
TREELET_MAX_START = 1 << (31 - TREELET_LEAF_SHIFT)

# the Scene arrays of K1's layout
ARRAY_KEYS = ("bvh_nodes", "bvh_prims")


def pack_nodes(bmin, bmax, hit, miss, start, count, is_leaf, vox=None, shift=LEAF_SHIFT):
    """[K, NODE_WORDS] float32 records of a tree in preorder.

    bmin, bmax [K,3]; hit, miss [K] int links; is_leaf [K] bool; start,
    count [K] the range of each leaf, packed as `start << shift | count`
    (LEAF_SHIFT for K1 and K5, TREELET_LEAF_SHIFT for K3); vox [K] the
    global id of each voxel leaf (also in is_leaf), -1 elsewhere, or None.
    Raises ValueError unless every internal node's hit link is i + 1 and
    every leaf's equals its miss link, or if a leaf's range does not
    pack."""
    hit = np.asarray(hit, np.int64)
    miss = np.asarray(miss, np.int64)
    start = np.asarray(start, np.int64)
    count = np.asarray(count, np.int64)
    is_leaf = np.asarray(is_leaf, bool)
    K = hit.shape[0]
    bad_inner = np.nonzero(~is_leaf & (hit != np.arange(1, K + 1)))[0]
    if bad_inner.size:
        raise ValueError(f"internal node {int(bad_inner[0])} has hit link "
                         f"{int(hit[bad_inner[0]])}, not the next node in preorder")
    bad_leaf = np.nonzero(is_leaf & (hit != miss))[0]
    if bad_leaf.size:
        raise ValueError(f"leaf {int(bad_leaf[0])} has hit link {int(hit[bad_leaf[0]])} "
                         f"and miss link {int(miss[bad_leaf[0]])}; they must be equal")
    ranged = is_leaf if vox is None else is_leaf & (np.asarray(vox) < 0)
    s, c = start[ranged], count[ranged]
    max_start, max_count = 1 << (31 - shift), (1 << shift) - 1
    if ((s < 0) | (s >= max_start) | (c < 0) | (c > max_count)).any():
        raise ValueError("a leaf range does not pack into start << "
                         f"{shift} | count (start < {max_start}, count <= {max_count})")
    leaf = voxel_words(np.where(is_leaf, (start << shift) | count, -1), vox)
    rec = np.zeros((K, NODE_WORDS), np.float32)
    rec[:, 0:3] = bmin
    rec[:, 4:7] = bmax
    ints = rec.view(np.int32)
    ints[:, 3] = miss
    ints[:, 7] = leaf
    return rec


def unpack_nodes(rec, shift=LEAF_SHIFT):
    """The arrays `pack_nodes` packed with `shift`: (bmin, bmax, hit, miss,
    leaf, start, count), the ints int32; start and count are -1 and 0 on
    internal nodes and voxel leaves."""
    ints = np.ascontiguousarray(rec).view(np.int32)
    miss, leaf = ints[:, 3].copy(), ints[:, 7].copy()
    is_leaf = leaf >= 0
    hit = np.where(leaf != -1, miss, np.arange(1, rec.shape[0] + 1)).astype(np.int32)
    start = np.where(is_leaf, leaf >> shift, -1).astype(np.int32)
    count = np.where(is_leaf, leaf & ((1 << shift) - 1), 0).astype(np.int32)
    return rec[:, 0:3].copy(), rec[:, 4:7].copy(), hit, miss, leaf, start, count


def prim_records(order, tri_v0, tri_e1, tri_e2, sph_center, sph_radius, num_tris):
    """[P, PRIM_WORDS] float32 records of the prims in leaf order `order`
    (global ids)."""
    order = np.asarray(order, np.int64)
    rec = np.zeros((order.shape[0], PRIM_WORDS), np.float32)
    tri = order < num_tris
    t = order[tri]
    rec[tri, 0:3] = np.asarray(tri_v0, np.float32)[t]
    rec[tri, 4:7] = np.asarray(tri_e1, np.float32)[t]
    rec[tri, 8:11] = np.asarray(tri_e2, np.float32)[t]
    s = order[~tri] - num_tris
    rec[~tri, 0:3] = np.asarray(sph_center, np.float32)[s]
    rec[~tri, 4] = np.asarray(sph_radius, np.float32)[s]
    rec.view(np.int32)[:, 3] = order
    return rec


def build_bvh_layout(bvh, tri_v0, tri_e1, tri_e2, sph_center, sph_radius, num_tris,
                     vox=None):
    """K1's layout of a single-level threaded BVH: a dict of numpy arrays
    under ARRAY_KEYS, bvh_nodes [K, NODE_WORDS] and bvh_prims
    [P, PRIM_WORDS] float32.  vox [K]: the voxel leaves' global ids of a
    tree baked for voxel LOD (ops/lod_layout.py), -1 elsewhere."""
    ps = np.asarray(bvh["nodes_prim_start"], np.int64)
    is_leaf = ps >= 0 if vox is None else (ps >= 0) | (np.asarray(vox) >= 0)
    nodes = pack_nodes(bvh["nodes_bmin"], bvh["nodes_bmax"], bvh["nodes_hit"],
                       bvh["nodes_miss"], ps, bvh["nodes_prim_count"], is_leaf, vox)
    prims = prim_records(bvh["prim_order"], tri_v0, tri_e1, tri_e2, sph_center,
                         sph_radius, num_tris)
    return {"bvh_nodes": nodes, "bvh_prims": prims}


def lbvh_preorder(tree, iters):
    """The LBVH `tree` (torch, accel/lbvh.py's layout) renumbered into
    preorder: the same schema, node n of the LBVH at position pre[n].
    iters: at least the tree's height (lbvh.depth_bound)."""
    hit = tree["nodes_hit"].long()
    miss = tree["nodes_miss"].long()
    P = tree["prim_order"].shape[0]
    n_int, K = P - 1, 2 * P - 1
    dev = hit.device
    left = hit[:n_int]
    right = miss[left]  # a left child's miss link is its sibling
    size = torch.ones(K, dtype=torch.int64, device=dev)
    for _ in range(iters):
        size = torch.cat([1 + size[left] + size[right], size[n_int:]])
    pre = torch.zeros(K, dtype=torch.int64, device=dev)
    for _ in range(iters):
        base = pre[:n_int] + 1
        pre = pre.index_put((left,), base).index_put((right,), base + size[left])
    node = torch.arange(K, dtype=torch.int64, device=dev)
    inv = torch.empty_like(pre).index_put_((pre,), node)  # position -> LBVH node
    end = (pre + size)[inv]
    new_miss = torch.where(end < K, end, -1)
    is_leaf = inv >= n_int
    return {
        "nodes_bmin": tree["nodes_bmin"][inv],
        "nodes_bmax": tree["nodes_bmax"][inv],
        "nodes_hit": torch.where(is_leaf, new_miss, node + 1).to(torch.int32),
        "nodes_miss": new_miss.to(torch.int32),
        "nodes_prim_start": tree["nodes_prim_start"][inv],
        "nodes_prim_count": tree["nodes_prim_count"][inv],
        "prim_order": tree["prim_order"],
    }


def lbvh_layout(tree, iters, tri_v0, tri_e1, tri_e2, sph_center, sph_radius, num_tris):
    """K1's layout of the LBVH `tree`, renumbered into preorder, as
    tensors on its device: {"bvh_nodes" [2P-1, NODE_WORDS], "bvh_prims"
    [P, PRIM_WORDS]}, bitwise what build_bvh_layout packs from the
    renumbered tree's arrays."""
    P = tree["prim_order"].shape[0]
    if P > MAX_START:
        raise ValueError(f"{P} leaves do not pack into start << {LEAF_SHIFT} | count")
    pre = lbvh_preorder(tree, iters)
    K = 2 * P - 1
    ps = pre["nodes_prim_start"]
    leaf = torch.where(ps >= 0, (ps << LEAF_SHIFT) | pre["nodes_prim_count"], -1)
    nodes = torch.zeros((K, NODE_WORDS), dtype=torch.int32, device=ps.device)
    nodes[:, 0:3] = pre["nodes_bmin"].contiguous().view(torch.int32)
    nodes[:, 3] = pre["nodes_miss"]
    nodes[:, 4:7] = pre["nodes_bmax"].contiguous().view(torch.int32)
    nodes[:, 7] = leaf.to(torch.int32)
    order = tree["prim_order"].long()
    tri = (order < num_tris)[:, None]
    t = torch.clamp(order, max=tri_v0.shape[0] - 1)
    s = torch.clamp(order - num_tris, 0, sph_center.shape[0] - 1)
    zero = torch.zeros((P, 3), dtype=torch.float32, device=ps.device)
    radius = torch.cat([sph_radius[s][:, None], zero[:, :2]], 1)
    prims = torch.zeros((P, PRIM_WORDS), dtype=torch.float32, device=ps.device)
    prims[:, 0:3] = torch.where(tri, tri_v0[t], sph_center[s])
    prims[:, 4:7] = torch.where(tri, tri_e1[t], radius)
    prims[:, 8:11] = torch.where(tri, tri_e2[t], zero)
    prims.view(torch.int32)[:, 3] = order.to(torch.int32)
    return {"bvh_nodes": nodes.view(torch.float32), "bvh_prims": prims}
