"""The treelet layout of the multi-chain walk (kernel K4).

Counterpart of the layout half of aten_tpu/ops/traverse_pallas.py for
`_make_smt_kernel`, in numpy: `build_treelet_layout` (:590-687),
`_directional_links` (:358-455) and `_pack_prims_8` (:555-588).  The cut
and the fat-leaf row alignment are ops/plk_layout.py's `treelet_cut` and
`align_rows`, so both treelet kernels number their slots the same way.

The cut tree keeps six sets of (hit, miss) links, one per traversal
ordering o = 2*axis + neg (rays travelling toward -axis have neg = 1):
at an interior node the child whose box centre lies nearer the side the
rays come from is visited first.  A ray picks its ordering from its own
direction (`pick_ordering`).

Per node the layout stores one record of TRL_NODE float32s (32 B): bmin,
bmax, and the int32 bits of the first slot of a fat leaf (a voxel leaf's
word, see below, or -1 elsewhere) and of its slot count.  Per slot it stores one record of RECORD float32s
(48 B, three float4s): lanes 0-10 of the reference's 16-lane slot,
v0 | sphere centre, e1 (lane 3 = sphere radius), e2, the global prim id
and a triangle flag as int32 bits, then one zero pad lane.

A tree baked for voxel LOD (ops/lod_layout.py) is cut as K3's is
(voxel leaves stay nodes, no slots), and a voxel leaf's slot-start word
holds its id as `VOXEL_WORD - id`.

The drain window travels with the layout as `trl_window`: any multiple
of PACK up to MAX_WINDOW (ops/plk_layout.py::k4_window), by default
ops/plk_layout.py's WINDOW.

`uses_trl` is the reference's choice of the treelet branch
(scene/scene.py:420-438): a single-level scene whose BVH, counted at
512 B per node and per prim, reaches plk_layout.TREELET_MIN_BYTES.
"""
from __future__ import annotations

import numpy as np

from aten_tpu_torch.ops.lod_layout import voxel_words
from aten_tpu_torch.ops.plk_layout import (
    PACK, TREELET_MIN_BYTES, WINDOW, align_rows, k4_window, treelet_cut)

TRL_NODE = 8   # float32s per node record
RECORD = 12    # float32s per slot record
ORDERINGS = 6  # direction-ordered link sets

# the Scene arrays of the layout
ARRAY_KEYS = ("trl_nodes", "trl_links", "trl_recs")


def directional_links(cent, hit, miss, start):
    """[6, K, 2] int32 (hit, miss) links of a preorder threaded tree per
    ordering o = 2*axis + neg (traverse_pallas.py:358-393): the child
    whose centre is nearer the rays' origin side first.  A node is a leaf
    when it carries prims or when hit == miss (an interior node's hit is
    its first child, never its skip)."""
    K = hit.shape[0]
    links = np.full((ORDERINGS, K, 2), -1, np.int32)
    c = cent.tolist()
    hit_l, miss_l, start_l = hit.tolist(), miss.tolist(), start.tolist()
    for o in range(ORDERINGS):
        axis, neg = o >> 1, bool(o & 1)
        h = [-1] * K
        m = [-1] * K
        stack = [(0, -1)]
        while stack:
            n, skip = stack.pop()
            if start_l[n] >= 0 or hit_l[n] == miss_l[n]:
                h[n] = skip
                m[n] = skip
                continue
            c1 = n + 1
            c2 = miss_l[c1]
            first, second = c1, c2
            if (c[c2][axis] < c[c1][axis]) != neg:
                first, second = c2, c1
            h[n] = first
            m[n] = skip
            stack.append((second, skip))
            stack.append((first, second))
        links[o, :, 0] = h
        links[o, :, 1] = m
    return links


def slot_records(order, tri_v0, tri_e1, tri_e2, sph_center, sph_radius,
                 num_tris, slot_of_prim, n_slots):
    """[n_slots, RECORD] float32 records of the prims `order` placed at
    slots `slot_of_prim`, lane for lane as `_pack_prims_8` packs them;
    unused slots are zero."""
    recs = np.zeros((n_slots, RECORD), np.float32)
    is_tri = order < num_tris
    tid = np.clip(order, 0, max(len(tri_v0) - 1, 0))
    sid = np.clip(order - num_tris, 0, max(len(sph_center) - 1, 0))
    geo0 = np.where(is_tri[:, None], np.asarray(tri_v0, np.float32)[tid],
                    np.asarray(sph_center, np.float32)[sid] if len(sph_center)
                    else 0.0)
    geo1 = np.where(is_tri[:, None], np.asarray(tri_e1, np.float32)[tid], 0.0)
    if len(sph_radius):
        geo1 = geo1.copy()
        geo1[~is_tri, 0] = np.asarray(sph_radius, np.float32)[sid[~is_tri]]
    geo2 = np.where(is_tri[:, None], np.asarray(tri_e2, np.float32)[tid], 0.0)
    recs[slot_of_prim, 0:3] = geo0
    recs[slot_of_prim, 3:6] = geo1
    recs[slot_of_prim, 6:9] = geo2
    recs[slot_of_prim, 9] = np.asarray(order, np.int32).view(np.float32)
    recs[slot_of_prim, 10] = is_tri.astype(np.int32).view(np.float32)
    return recs


def build_trl_layout(bvh, tri_v0, tri_e1, tri_e2, sph_center, sph_radius,
                     num_tris, vox=None, window=WINDOW):
    """The K4 layout of a single-level threaded BVH with drain window
    `window` (`k4_window`'s rule).

    Returns numpy arrays under ARRAY_KEYS plus the scalar `trl_window`
    (the window): trl_nodes [Kt, TRL_NODE] f32, trl_links [Kt, 12] int32
    ((hit, miss) of orderings 0..5, as the reference's node lanes 6-17),
    trl_recs [n_slots, RECORD] f32.  vox [K]: the voxel leaves' global
    ids of a tree baked for voxel LOD, -1 elsewhere."""
    window = k4_window(window)
    order = np.asarray(bvh["prim_order"], np.int64)
    bmin, bmax, hit, miss, start, count, keep = treelet_cut(
        bvh, None if vox is None else np.asarray(vox) >= 0, window)
    links = directional_links((bmin + bmax) * np.float32(0.5), hit, miss, start)
    row_start, slot_of_prim, n_rows = align_rows(start, count, order.shape[0], window)
    placed = slot_of_prim >= 0
    Kt = hit.shape[0]
    nodes = np.zeros((Kt, TRL_NODE), np.float32)
    nodes[:, 0:3] = bmin
    nodes[:, 3:6] = bmax
    first = np.where(row_start >= 0, row_start * PACK, -1)
    first = voxel_words(first, None if vox is None else np.asarray(vox, np.int64)[keep])
    nodes[:, 6:8] = np.stack([first, count], 1).astype(np.int32).view(np.float32)
    return {
        "trl_nodes": nodes,
        "trl_links": np.ascontiguousarray(links.transpose(1, 0, 2).reshape(Kt, 2 * ORDERINGS)),
        "trl_recs": slot_records(order[placed], tri_v0, tri_e1, tri_e2, sph_center, sph_radius,
                                 num_tris, slot_of_prim[placed], n_rows * PACK),
        "trl_window": window,
    }


def uses_trl(n_nodes, n_prims, num_instances):
    """The reference's treelet branch for a scene with BVH size
    (n_nodes, n_prims) and `num_instances` instances."""
    return num_instances == 0 and (n_nodes + n_prims) * 512 >= TREELET_MIN_BYTES
