"""Threaded BVH construction (host side, NumPy) -> hit/miss-link arrays.

Counterpart of aten_tpu/accel/build.py: a binned-SAH binary BVH over the
primitive boxes, flattened in pre-order with hit/miss links so traversal
is `next = aabb_hit ? hit : miss` with no stack.  Scenes above 512
primitives use the C++ builder `native/bvh_builder.cpp`, compiled with
the reference's g++ flags into `build/aten_tpu_torch/` and loaded with
ctypes; a failed build raises.  Smaller scenes take the NumPy build below,
exactly as the reference does, so both packages hold the same tree.
`build_sbvh` runs the same library's spatial-split builder.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

from aten_tpu_torch import native

LEAF_MAX = 4
N_BINS = 16
NATIVE_MIN_PRIMS = 512

_SRC = os.path.join(native.REPO_ROOT, "native", "bvh_builder.cpp")
_SO = os.path.join(native.BUILD_DIR, "libbvh.so")
_GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _load_native():
    """Build (once per source change) and load the C++ builder."""
    with native.build_lock("libbvh"):
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            tmp = _SO + f".{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", *_GXX_FLAGS, "-o", tmp, _SRC],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {_SRC} failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, _SO)
    lib = ctypes.CDLL(_SO)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.aten_build_bvh.restype = ctypes.c_int64
    lib.aten_build_bvh.argtypes = [
        fp, fp, ctypes.c_int64, ctypes.c_int32,
        fp, fp, ip, ip, ip, ip, ip,
    ]
    lib.aten_build_sbvh.restype = ctypes.c_int64
    lib.aten_build_sbvh.argtypes = [
        fp, fp, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
        ctypes.c_int64, ctypes.c_int64,
        fp, fp, ip, ip, ip, ip, ip, ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _build_bvh_native(bmin, bmax, leaf_max):
    lib = _load_native()
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    P = bmin.shape[0]
    Kmax = 2 * P
    nbmin = np.empty((Kmax, 3), np.float32)
    nbmax = np.empty((Kmax, 3), np.float32)
    hit = np.empty(Kmax, np.int32)
    miss = np.empty(Kmax, np.int32)
    ps = np.empty(Kmax, np.int32)
    pc = np.empty(Kmax, np.int32)
    order = np.empty(P, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    K = lib.aten_build_bvh(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        ctypes.c_int64(P), ctypes.c_int32(leaf_max),
        nbmin.ctypes.data_as(fp), nbmax.ctypes.data_as(fp),
        hit.ctypes.data_as(ip), miss.ctypes.data_as(ip),
        ps.ctypes.data_as(ip), pc.ctypes.data_as(ip),
        order.ctypes.data_as(ip),
    )
    if not 0 < K <= Kmax:
        raise RuntimeError(f"native BVH build returned {K} nodes for {P} prims")
    return {
        "nodes_bmin": nbmin[:K].copy(),
        "nodes_bmax": nbmax[:K].copy(),
        "nodes_hit": hit[:K].copy(),
        "nodes_miss": miss[:K].copy(),
        "nodes_prim_start": ps[:K].copy(),
        "nodes_prim_count": pc[:K].copy(),
        "prim_order": order,
    }


def build_sbvh(bmin, bmax, leaf_max: int = LEAF_MAX, alpha: float = 1e-5):
    """Spatial-split BVH (the reference's sbvh.cpp:278-324) from the C++
    builder's `aten_build_sbvh`: a prim's reference may be duplicated
    into both children with clipped boxes where that lowers the SAH
    cost, which tightens trees over large, axis-spanning triangles.  The
    schema is build_bvh's, with prim_order [R] (R >= P) repeating ids.
    Below 4 prims, or where the duplicates outgrow the builder's
    capacity (2P references, 4P nodes: it returns K < 0), this is
    build_bvh's tree, as in the reference; a native library that fails
    to build raises."""
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    P = bmin.shape[0]
    if P < 4:
        return build_bvh(bmin, bmax, leaf_max)
    lib = _load_native()
    cap_prims = 2 * P
    cap_nodes = 4 * P
    nbmin = np.empty((cap_nodes, 3), np.float32)
    nbmax = np.empty((cap_nodes, 3), np.float32)
    hit = np.empty(cap_nodes, np.int32)
    miss = np.empty(cap_nodes, np.int32)
    ps = np.empty(cap_nodes, np.int32)
    pc = np.empty(cap_nodes, np.int32)
    order = np.empty(cap_prims, np.int32)
    nrefs = np.zeros(1, np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    K = lib.aten_build_sbvh(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        ctypes.c_int64(P), ctypes.c_int32(leaf_max), ctypes.c_float(alpha),
        ctypes.c_int64(cap_nodes), ctypes.c_int64(cap_prims),
        nbmin.ctypes.data_as(fp), nbmax.ctypes.data_as(fp),
        hit.ctypes.data_as(ip), miss.ctypes.data_as(ip),
        ps.ctypes.data_as(ip), pc.ctypes.data_as(ip),
        order.ctypes.data_as(ip), nrefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if K < 0:
        return build_bvh(bmin, bmax, leaf_max)
    R = int(nrefs[0])
    return {
        "nodes_bmin": nbmin[:K].copy(),
        "nodes_bmax": nbmax[:K].copy(),
        "nodes_hit": hit[:K].copy(),
        "nodes_miss": miss[:K].copy(),
        "nodes_prim_start": ps[:K].copy(),
        "nodes_prim_count": pc[:K].copy(),
        "prim_order": order[:R].copy(),
    }


def _sah_split(bmin, bmax, cent, idx):
    """Best binned-SAH split of prims `idx`: (lidx, ridx)."""
    c = cent[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
        h = len(idx) // 2
        return idx[:h], idx[h:]
    scale = N_BINS * (1.0 - 1e-6) / ext[axis]
    bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
    bins = np.clip(bins, 0, N_BINS - 1)
    counts = np.zeros(N_BINS, np.int64)
    bb_min = np.full((N_BINS, 3), np.inf, np.float32)
    bb_max = np.full((N_BINS, 3), -np.inf, np.float32)
    np.add.at(counts, bins, 1)
    for a in range(3):
        np.minimum.at(bb_min[:, a], bins, bmin[idx, a])
        np.maximum.at(bb_max[:, a], bins, bmax[idx, a])

    def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    lmin = np.minimum.accumulate(bb_min, axis=0)
    lmax = np.maximum.accumulate(bb_max, axis=0)
    rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
    lcnt = np.cumsum(counts)
    rcnt = np.cumsum(counts[::-1])[::-1]
    cost = np.full(N_BINS - 1, np.inf)
    for k in range(N_BINS - 1):
        if lcnt[k] == 0 or rcnt[k + 1] == 0:
            continue
        cost[k] = area(lmin[k], lmax[k]) * lcnt[k] + area(
            rmin[k + 1], rmax[k + 1]
        ) * rcnt[k + 1]
    k = int(np.argmin(cost))
    if not np.isfinite(cost[k]):
        h = len(idx) // 2
        return idx[:h], idx[h:]
    lmask = bins <= k
    return idx[lmask], idx[~lmask]


def build_bvh(bmin: np.ndarray, bmax: np.ndarray, leaf_max: int = LEAF_MAX,
              use_native: bool = True):
    """Threaded BVH arrays over P primitive boxes.

    use_native=False keeps the NumPy build at any size, as the reference
    builds its instance-level tree (accel/tlas.py).

    Returns numpy arrays: nodes_bmin/bmax [K,3] f32, nodes_hit/miss [K]
    i32, nodes_prim_start [K] i32 (-1 internal), nodes_prim_count [K]
    i32 (<= leaf_max), prim_order [P] i32.
    """
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    P = bmin.shape[0]
    if P == 0:
        raise ValueError("build_bvh needs at least one primitive")
    if use_native and P > NATIVE_MIN_PRIMS:
        return _build_bvh_native(bmin, bmax, leaf_max)
    cent = (bmin + bmax) * 0.5

    tree = []  # each: dict(bmin, bmax, left, right, prims)

    def rec(idx):
        nid = len(tree)
        node = {
            "bmin": bmin[idx].min(axis=0),
            "bmax": bmax[idx].max(axis=0),
            "left": -1,
            "right": -1,
            "prims": None,
        }
        tree.append(node)
        if len(idx) <= leaf_max:
            node["prims"] = idx
            return nid
        l, r = _sah_split(bmin, bmax, cent, idx)
        if len(l) == 0 or len(r) == 0:
            h = len(idx) // 2
            l, r = idx[:h], idx[h:]
        node["left"] = rec(l)
        node["right"] = rec(r)
        return nid

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        rec(np.arange(P, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    # Pre-order flatten; each node's skip link is the node after its
    # subtree, carried down the DFS as a tree id and resolved afterwards.
    K = len(tree)
    order = np.empty(K, np.int64)  # preorder position -> tree id
    flat_of = np.empty(K, np.int64)  # tree id -> preorder position
    skip_tree = np.full(K, -1, np.int64)
    pos = 0
    stack = [(0, -1)]
    while stack:
        tid, skip = stack.pop()
        order[pos] = tid
        flat_of[tid] = pos
        skip_tree[pos] = skip
        pos += 1
        n = tree[tid]
        if n["prims"] is None:
            stack.append((n["right"], skip))
            stack.append((n["left"], n["right"]))

    nodes_bmin = np.empty((K, 3), np.float32)
    nodes_bmax = np.empty((K, 3), np.float32)
    nodes_hit = np.empty(K, np.int32)
    nodes_miss = np.empty(K, np.int32)
    nodes_ps = np.full(K, -1, np.int32)
    nodes_pc = np.zeros(K, np.int32)
    prim_order = np.empty(P, np.int64)
    pcur = 0
    for i in range(K):
        n = tree[order[i]]
        nodes_bmin[i] = n["bmin"]
        nodes_bmax[i] = n["bmax"]
        skip = skip_tree[i]
        skip_pos = -1 if skip < 0 else flat_of[skip]
        if n["prims"] is None:
            nodes_hit[i] = i + 1  # first child is next in preorder
            nodes_miss[i] = skip_pos
        else:
            cnt = len(n["prims"])
            prim_order[pcur : pcur + cnt] = n["prims"]
            nodes_ps[i] = pcur
            nodes_pc[i] = cnt
            pcur += cnt
            nodes_hit[i] = skip_pos
            nodes_miss[i] = skip_pos

    return {
        "nodes_bmin": nodes_bmin,
        "nodes_bmax": nodes_bmax,
        "nodes_hit": nodes_hit,
        "nodes_miss": nodes_miss,
        "nodes_prim_start": nodes_ps,
        "nodes_prim_count": nodes_pc,
        "prim_order": prim_order.astype(np.int32),
    }
