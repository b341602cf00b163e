"""The Plücker leaf layout of the treelet traversal (kernel K3).

Counterpart of the layout half of aten_tpu/ops/traverse_pallas.py, in
numpy: `treelet_cut` (:457-531), the fat-leaf row alignment of
`build_treelet_layout` (:640-651), and the Plücker constants of
`_build_plucker_emat` (:722-758).

The threaded BVH is cut at subtrees of at most `window` prims; each such
subtree becomes one fat leaf of the cut tree, with the default threaded
hit/miss links.  Fat leaves start on PACK-slot row boundaries, which
fixes the slot namespace `slot = row_start * PACK + j` and `slot2prim`.

Per slot the layout stores one record of 16 float32s (64 B):
the edge lines (a x b, b - a) of the edges v0->v1 and v1->v2, the plane
normal n = e1 x e2, and n.v0.  Each is computed in float64 and rounded
to float32, so the values equal the nonzero entries of the reference's
E block bit for bit; the block's numerator rows hold -n, which the
kernel gets by an exact negation.  The block itself, [16, 4*window] per
leaf laid out for the TPU's matrix unit, holds 19 nonzero entries of 64
per slot and is not built.

A tree baked for voxel LOD (ops/lod_layout.py) keeps each voxel leaf as
a node of its own: the cut never folds a subtree that holds one into a
fat leaf, and the voxel leaf carries no slots; `plk_slot_start` and the
packed leaf word hold its id as `VOXEL_WORD - id`
(`build_treelet_layout(voxid=, vox_base=)`, :622, :634-637, :668-669).
Its leaf ranges index the original prim order, which keeps the prims of
pruned subtrees: only the prims of fat leaves get slots.

The K3 kernel reads the cut tree as packed 32-byte node records
(ops/bvh_layout.py::pack_nodes), `plk_nodes`, with a fat leaf's
`slot_start` and `count` in the record's leaf word; the separate node
arrays stay for the plain version.

The drain window, the most slots a fat leaf holds, travels with each
layout as `plk_window`.  `build_plk_layout(window=)` takes a power of
two from PACK to MAX_WINDOW (the slot id fills the low log2(window)
mantissa bits of t, traverse_pallas.py:1074); K4's layout
(ops/trl_layout.py) takes any multiple of PACK up to MAX_WINDOW
(:619-620).  WINDOW, the default, is read once at import from
ATEN_TRL_WINDOW (default 64), as the reference reads TREELET_MAX
(:334); this is the one module of the port that reads it.

`uses_plk` is the reference's choice of the kernel (traverse_pallas.py
:2054-2058, scene/scene.py:426-438): a single-level, triangle-only scene
whose build takes the treelet branch and, under the default kernel
policy, whose packed pools, counted as the reference stores them, exceed
RESIDENT_MB; the policy "plk" takes every such scene, "smt" and "mt"
none.
"""
from __future__ import annotations

import os

import numpy as np

from aten_tpu_torch.ops.bvh_layout import TREELET_LEAF_SHIFT, pack_nodes
from aten_tpu_torch.ops.lod_layout import voxel_words

PACK = 8           # slots per row: fat leaves start on PACK-slot boundaries
MAX_WINDOW = 128   # the widest drain window the port's kernels are built for
RESIDENT_MB = 32.0  # reference pools up to this size stay resident (K1)
TREELET_MIN_BYTES = 5 * 1024 * 1024  # (K + P) * 512 B: treelet branch
ROW_FLOATS = 128   # reference pool rows are 128 float32 lanes
NODE_ROWS = 8      # reference node pool rows are padded to a multiple of 8
RECORD = 16        # float32s per slot record


def k4_window(window):
    """`window` as an int if K4's layout takes it (a multiple of PACK from
    PACK to MAX_WINDOW, the reference's rule at traverse_pallas.py:619-620
    with the port's cap); raises ValueError else."""
    w = int(window)
    if w != window or w % PACK or not PACK <= w <= MAX_WINDOW:
        raise ValueError(f"drain window {window!r}: K4 takes a multiple of {PACK} from "
                         f"{PACK} to {MAX_WINDOW}")
    return w


def is_k3_window(window):
    """Whether K3's layout takes `window`: a power of two from PACK to
    MAX_WINDOW (the slot id rides in t's low bits, traverse_pallas.py
    :1074)."""
    w = int(window)
    return w == window and PACK <= w <= MAX_WINDOW and not w & (w - 1)


def k3_window(window):
    """`window` as an int if K3's layout takes it (`is_k3_window`);
    raises ValueError else."""
    if not is_k3_window(window):
        raise ValueError(f"drain window {window!r}: K3 takes a power of two from "
                         f"{PACK} to {MAX_WINDOW}")
    return int(window)


# the default window, read once (ATEN_TRL_WINDOW, traverse_pallas.py:334)
WINDOW = k4_window(int(os.environ.get("ATEN_TRL_WINDOW", "64")))

# the Scene arrays of the layout
ARRAY_KEYS = ("plk_bmin", "plk_bmax", "plk_hit", "plk_miss",
              "plk_slot_start", "plk_count", "plk_consts", "plk_slot2prim",
              "plk_nodes")


def treelet_cut(bvh, protect=None, window=WINDOW):
    """Cut a threaded BVH at subtrees of <= window prims.

    Returns (bmin [Kt,3] f32, bmax [Kt,3] f32, hit, miss, start, count,
    keep), the int arrays int64: the kept nodes in preorder with their
    default threaded links; fat leaves carry their subtree's contiguous
    prim range (start, count) in prim_order, interior nodes (-1, 0);
    keep is the original index of each kept node.

    protect [K] bool (voxel leaves): nodes that stay nodes of their own.
    A subtree with a protected node strictly below its root is never
    folded into a fat leaf, and a protected node becomes a fat leaf of
    its own (zero prims: start -1, count 0)."""
    nmiss = np.asarray(bvh["nodes_miss"], np.int64)
    nps = np.asarray(bvh["nodes_prim_start"], np.int64)
    npc = np.asarray(bvh["nodes_prim_count"], np.int64)
    K = nmiss.shape[0]
    leaf_prims = np.where(nps >= 0, npc, 0)
    P = int(leaf_prims.sum())
    prefix = np.zeros(K + 1, np.int64)
    prefix[1:] = np.cumsum(leaf_prims)

    if protect is None:
        protect = np.zeros(K, bool)
    pcum = np.zeros(K + 1, np.int64)
    pcum[1:] = np.cumsum(protect)

    miss_l, nps_l, prefix_l = nmiss.tolist(), nps.tolist(), prefix.tolist()
    prot_l, pcum_l = protect.tolist(), pcum.tolist()
    keep, is_fat = [], []
    i = 0
    while i != -1:
        skip = miss_l[i]
        cnt = (P if skip < 0 else prefix_l[skip]) - prefix_l[i]
        below = pcum_l[K if skip < 0 else skip] - pcum_l[i + 1]
        fat = prot_l[i] or nps_l[i] >= 0 or (cnt <= window and below == 0)
        keep.append(i)
        is_fat.append(fat)
        i = skip if fat else i + 1  # past the subtree, or its first child
    keep = np.asarray(keep, np.int64)
    is_fat = np.asarray(is_fat, bool)
    Kt = keep.shape[0]
    new_of = np.full(K, -1, np.int64)
    new_of[keep] = np.arange(Kt)

    # prim_order offset of the first leaf at or after each node
    leaf_at = np.where(nps >= 0, np.arange(K), K)
    first = np.minimum.accumulate(leaf_at[::-1])[::-1]
    next_leaf = np.where(first < K, nps[np.minimum(first, K - 1)], -1)

    ms = nmiss[keep]
    ms_new = np.where(ms < 0, -1, new_of[np.maximum(ms, 0)])
    end = np.where(ms < 0, P, prefix[np.maximum(ms, 0)])
    count = np.where(is_fat, end - prefix[keep], 0)
    start = np.where(is_fat & (count > 0), next_leaf[keep], -1)
    child = new_of[np.minimum(keep + 1, K - 1)]
    hit = np.where(is_fat, ms_new, child)
    bmin = np.asarray(bvh["nodes_bmin"], np.float32)[keep]
    bmax = np.asarray(bvh["nodes_bmax"], np.float32)[keep]
    return bmin, bmax, hit, ms_new, start, count, keep


def align_rows(start, count, n_prims, window):
    """Row-align the fat leaves' prim ranges (build_treelet_layout
    :640-651).  Returns (row_start [Kt] (-1 off fat leaves), row_of_prim
    [P] = the slot of each prim_order position (-1 at a position no fat
    leaf holds: the prims of a voxel's pruned subtree), n_rows_padded),
    the pool carrying one window of tail rows."""
    fat = np.nonzero((start >= 0) & (count > 0))[0]
    c = count[fat]
    rows = -(-c // PACK)
    row_start = np.full(start.shape[0], -1, np.int64)
    row_start[fat] = np.cumsum(rows) - rows
    row_of_prim = np.full(n_prims, -1, np.int64)
    j = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
    row_of_prim[np.repeat(start[fat], c) + j] = np.repeat(row_start[fat] * PACK, c) + j
    return row_start, row_of_prim, int(rows.sum()) + window // PACK


def pool_mb(n_cut_nodes, n_rows_padded):
    """The reference's pool size in MB (traverse_pallas.py:2055): its node
    rows padded to NODE_ROWS plus its packed prim rows, 128 float32s
    each, at 4e-6 MB per float."""
    kp = -(-n_cut_nodes // NODE_ROWS) * NODE_ROWS
    return (kp + n_rows_padded) * ROW_FLOATS * 4e-6


def plucker_records(tri_v0, tri_e1, tri_e2, tid):
    """[n, RECORD] float32 records of triangles tid: m0 = a x b, d0 = b - a
    (edge v0->v1), m1, d1 (edge v1->v2), n = e1 x e2, n.v0; computed in
    float64 as _build_plucker_emat does, then rounded."""
    v0 = np.asarray(tri_v0, np.float64)[tid]
    e1 = np.asarray(tri_e1, np.float64)[tid]
    e2 = np.asarray(tri_e2, np.float64)[tid]
    A, B, C = v0, v0 + e1, v0 + e2
    n = np.cross(e1, e2)
    return np.concatenate([
        np.cross(A, B), B - A, np.cross(B, C), C - B, n,
        np.einsum("ij,ij->i", n, v0)[:, None],
    ], axis=1).astype(np.float32)


def build_plk_layout(bvh, tri_v0, tri_e1, tri_e2, num_tris, vox=None, window=WINDOW):
    """The K3 layout of a single-level threaded BVH with drain window
    `window` (`k3_window`'s rule), or None when a leaf holds a sphere
    (the Plücker test is for triangles only).  vox [K]:
    the voxel leaves' global ids of a tree baked for voxel LOD, -1
    elsewhere; plk_slot_start and the leaf word then hold VOXEL_WORD - id.

    Returns a dict of numpy arrays under ARRAY_KEYS, plus the scalars
    `plk_window` (the window) and `plk_pool_mb` (the reference's pool size):
    plk_bmin/bmax [Kt,3] f32, plk_hit/miss [Kt] i32 (default threaded
    links of the cut tree), plk_slot_start [Kt] i32 (row_start * PACK on
    fat leaves, VOXEL_WORD - id on voxel leaves, else -1), plk_count [Kt]
    i32 (<= window), plk_consts [n_slots, RECORD] f32 (zero on padding
    slots), plk_slot2prim [n_slots] i32 (-1 on padding slots), plk_nodes
    [Kt, NODE_WORDS] f32 (the packed records of the cut tree, with each
    fat leaf's slot start and count)."""
    window = k3_window(window)
    order = np.asarray(bvh["prim_order"], np.int64)
    if (order >= num_tris).any():
        return None
    bmin, bmax, hit, miss, start, count, keep = treelet_cut(
        bvh, None if vox is None else np.asarray(vox) >= 0, window)
    P = order.shape[0]
    row_start, row_of_prim, n_rows = align_rows(start, count, P, window)
    n_slots = n_rows * PACK
    placed = row_of_prim >= 0
    consts = np.zeros((n_slots, RECORD), np.float32)
    consts[row_of_prim[placed]] = plucker_records(tri_v0, tri_e1, tri_e2, order[placed])
    slot2prim = np.full(n_slots, -1, np.int32)
    slot2prim[row_of_prim[placed]] = order[placed]
    slot_start = np.where(row_start >= 0, row_start * PACK, -1)
    vox_cut = None if vox is None else np.asarray(vox, np.int64)[keep]
    if vox_cut is not None and int(vox_cut.max(initial=-1)) + n_slots > np.iinfo(np.int32).max:
        raise ValueError("K3 shifts voxel ids by the slot count: they must fit int32")
    is_leaf = slot_start >= 0 if vox_cut is None else (slot_start >= 0) | (vox_cut >= 0)
    nodes = pack_nodes(bmin, bmax, hit, miss, slot_start, count, is_leaf, vox_cut,
                       shift=TREELET_LEAF_SHIFT)
    slot_start = voxel_words(slot_start, vox_cut)
    return {
        "plk_bmin": bmin, "plk_bmax": bmax,
        "plk_hit": hit.astype(np.int32), "plk_miss": miss.astype(np.int32),
        "plk_slot_start": slot_start.astype(np.int32),
        "plk_count": count.astype(np.int32),
        "plk_consts": consts, "plk_slot2prim": slot2prim, "plk_nodes": nodes,
        "plk_window": window,
        "plk_pool_mb": pool_mb(hit.shape[0], n_rows),
    }


def uses_plk(n_nodes, n_prims, layout, kernel):
    """The reference's kernel choice for a single-level scene with BVH
    size (n_nodes, n_prims) and layout `build_plk_layout`'s result under
    the kernel policy `kernel` (accel/traverse.py::KERNEL)."""
    return (layout is not None
            and (n_nodes + n_prims) * 512 >= TREELET_MIN_BYTES
            and (kernel == "plk"
                 or (layout["plk_pool_mb"] > RESIDENT_MB and kernel not in ("smt", "mt"))))
