"""Packed records of the two-level instanced pool (kernel K5).

The K5 kernel (kernels/tlas_traverse.cu) reads the pool of
accel/tlas.py::build_two_level as three tables of 16-byte-aligned
records, read as float4s.

One 32-byte node record per pool node, as K1's (ops/bvh_layout.py):

    (bmin.x, bmin.y, bmin.z, miss)  (bmax.x, bmax.y, bmax.z, leaf)

`miss` and `leaf` are int32 bits.  The pool is the TLAS followed by each
object's BLAS, each tree in preorder (accel/tlas.py), so the record
needs no hit link:

* an inner node of either level has `leaf` = -1 and hit link i + 1;
* a BLAS leaf has `leaf` = start << LEAF_SHIFT | count, its range of
  prim records, and a hit link equal to its miss link (-2, back to the
  top level, after the last node of its tree);
* a TLAS leaf has `leaf` = -2 - instance, and its hit link is its
  instance's BLAS root, kept in the instance record.

One 64-byte instance record per instance, four float4s: the three rows
of its 3x4 world-to-local matrix (`inst_w2l`), then (root, 0, 0, 0) with
the root as int bits.  Entering an instance is four independent loads.

The prim records are K1's 48-byte records (bvh_layout.prim_records) in
`tl_prim_order` order, so a leaf's prims are contiguous and the kernel
makes no dependent load through `tl_prim_order`.

`pack_two_level` checks the facts the kernel relies on, on every pool it
packs, and raises ValueError if one fails.  The original `tl_*` and
`inst_w2l` arrays stay in the scene: the plain walk and `eval_hit` read
them.
"""
from __future__ import annotations

import numpy as np

from aten_tpu_torch.ops.bvh_layout import LEAF_COUNT, LEAF_SHIFT, pack_nodes, prim_records

INST_WORDS = 16  # float32 words of an instance record (64 B)

# the Scene arrays of K5's layout
ARRAY_KEYS = ("tl_nodes", "tl_insts", "tl_prims")


def blas_roots(tl_hit, tl_miss, tl_ps, tl_inst):
    """(Kt, roots): the TLAS's node count and the root of each object's
    BLAS, in object order, read off the pool's structure.  The TLAS's last
    node in preorder is its one leaf with miss link -1; each BLAS ends at
    its one leaf with hit link -2 and the next object's tree starts after
    it.  Raises ValueError where the pool has another shape."""
    hit = np.asarray(tl_hit, np.int64)
    miss = np.asarray(tl_miss, np.int64)
    tlas_leaf = np.asarray(tl_inst) >= 0
    blas_leaf = np.asarray(tl_ps) >= 0
    K = hit.shape[0]
    last = np.nonzero(tlas_leaf & (miss == -1))[0]
    if last.size != 1:
        raise ValueError(f"the pool's TLAS has {last.size} leaves with miss link -1, "
                         "not one (its last node in preorder)")
    kt = int(last[0]) + 1
    top, low = np.arange(K) < kt, np.arange(K) >= kt
    if (blas_leaf & top).any() or (tlas_leaf & low).any():
        raise ValueError(f"the pool's first {kt} nodes must be the TLAS (instance leaves, "
                         "no prims) and the rest BLAS nodes (no instances)")
    ends = np.nonzero(blas_leaf & (hit == -2))[0]
    if ends.size == 0 or ends[-1] != K - 1:
        raise ValueError("the pool's last node must end a BLAS (a leaf with hit link -2)")
    return kt, np.concatenate([[kt], ends[:-1] + 1])


def pack_two_level(tl_bmin, tl_bmax, tl_hit, tl_miss, tl_ps, tl_pc, tl_inst, inst_obj,
                   inst_w2l):
    """(nodes [K, NODE_WORDS], insts [I, INST_WORDS]) float32 records of
    the pool.  Raises ValueError unless every inner node's hit link is
    i + 1, every BLAS leaf's equals its miss link, every instance has one
    TLAS leaf and that leaf's hit link is the root of its object's BLAS,
    and every BLAS leaf's range packs."""
    hit = np.asarray(tl_hit, np.int64)
    miss = np.asarray(tl_miss, np.int64)
    inst = np.asarray(tl_inst, np.int64)
    inst_obj = np.asarray(inst_obj, np.int64)
    n_inst = inst_obj.shape[0]
    w2l = np.asarray(inst_w2l, np.float32)
    if w2l.shape != (n_inst + 1, 3, 4):
        raise ValueError(f"inst_w2l has shape {w2l.shape} for {n_inst} instances "
                         "(expected instances + 1 rows of 3x4)")
    _, roots = blas_roots(hit, miss, tl_ps, inst)
    tlas_leaf = inst >= 0
    if (inst >= n_inst).any() or (inst_obj < 0).any() or (inst_obj >= roots.shape[0]).any():
        raise ValueError(f"an instance id is out of range: {n_inst} instances over "
                         f"{roots.shape[0]} objects' trees")
    per_inst = np.bincount(inst[tlas_leaf], minlength=n_inst)
    if (per_inst != 1).any():
        raise ValueError(f"instance {int(np.nonzero(per_inst != 1)[0][0])} has "
                         f"{int(per_inst[per_inst != 1][0])} TLAS leaves, not one")
    want = roots[inst_obj]
    bad = np.nonzero(tlas_leaf & (hit != want[np.maximum(inst, 0)]))[0]
    if bad.size:
        k = int(bad[0])
        raise ValueError(f"TLAS leaf {k} of instance {int(inst[k])} has hit link "
                         f"{int(hit[k])}, not its object's BLAS root {int(want[inst[k]])}")
    # a TLAS leaf passes pack_nodes' leaf check with its hit link set to its
    # miss link, and gets its own leaf word below
    ps = np.asarray(tl_ps, np.int64)
    nodes = pack_nodes(tl_bmin, tl_bmax, np.where(tlas_leaf, miss, hit), miss,
                       np.maximum(ps, 0), np.where(ps >= 0, tl_pc, 0),
                       (ps >= 0) | tlas_leaf)
    nodes.view(np.int32)[tlas_leaf, 7] = -2 - inst[tlas_leaf]
    insts = np.zeros((n_inst, INST_WORDS), np.float32)
    insts[:, :12] = w2l[:n_inst].reshape(n_inst, 12)
    insts.view(np.int32)[:, 12] = want
    return nodes, insts


def unpack_two_level(nodes, insts):
    """The arrays `pack_two_level` packed: {tl_bmin, tl_bmax, tl_hit,
    tl_miss, tl_ps, tl_pc, tl_inst, inst_w2l (the I instances' rows),
    inst_root}, the ints int32."""
    ints = np.ascontiguousarray(nodes).view(np.int32)
    miss, leaf = ints[:, 3].copy(), ints[:, 7].copy()
    root = np.ascontiguousarray(insts).view(np.int32)[:, 12].copy()
    blas_leaf, tlas_leaf = leaf >= 0, leaf <= -2
    inst = np.where(tlas_leaf, -2 - leaf, -1).astype(np.int32)
    hit = np.where(blas_leaf, miss, np.arange(1, nodes.shape[0] + 1))
    hit = np.where(tlas_leaf, root[np.maximum(inst, 0)], hit).astype(np.int32)
    return {
        "tl_bmin": nodes[:, 0:3].copy(), "tl_bmax": nodes[:, 4:7].copy(),
        "tl_hit": hit, "tl_miss": miss,
        "tl_ps": np.where(blas_leaf, leaf >> LEAF_SHIFT, -1).astype(np.int32),
        "tl_pc": np.where(blas_leaf, leaf & LEAF_COUNT, 0).astype(np.int32),
        "tl_inst": inst,
        "inst_w2l": insts[:, :12].reshape(-1, 3, 4).copy(), "inst_root": root,
    }


def build_tlas_layout(pool, tri_v0, tri_e1, tri_e2, sph_center, sph_radius, num_tris):
    """K5's layout of a two-level pool (the dict of build_two_level): a
    dict of numpy arrays under ARRAY_KEYS, tl_nodes [K, NODE_WORDS],
    tl_insts [I, INST_WORDS] and tl_prims [P, PRIM_WORDS] float32
    (bvh_layout's NODE_WORDS and PRIM_WORDS)."""
    nodes, insts = pack_two_level(
        pool["tl_bmin"], pool["tl_bmax"], pool["tl_hit"], pool["tl_miss"], pool["tl_ps"],
        pool["tl_pc"], pool["tl_inst"], pool["inst_obj"], pool["inst_w2l"])
    prims = prim_records(pool["tl_prim_order"], tri_v0, tri_e1, tri_e2, sph_center,
                         sph_radius, num_tris)
    return {"tl_nodes": nodes, "tl_insts": insts, "tl_prims": prims}
