"""The reference's own ray traversal: a median-split BVH and a stack walk.

Written for the benchmark and independent of the program's trees and
layouts.  The tree is complete and implicit: the prims are sorted level
by level along the longest centroid axis of each node, node k's children
are 2k+1 and 2k+2, and each of the 2^D leaves holds at most LEAF prims.
The walk pops one node per ray per step (see `walk`).  Triangle and
sphere tests are the path tracer's own arithmetic (Möller-Trumbore in
component form, the nearest sphere root past t_min), so a hit's t, u and
v are the same numbers whatever tree finds it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LEAF = 4
BOX_PAD = 1e-5


def build_tree(bmin, bmax):
    """Implicit median-split tree over prim boxes bmin, bmax [P, 3] (numpy).
    Returns {depth, node_bmin, node_bmax [2L-1, 3], leaf_prims [L, LEAF]
    (-1 padded)}."""
    n = bmin.shape[0]
    depth = max(0, math.ceil(math.log2(n / LEAF))) if n > LEAF else 0
    leaves = 1 << depth
    cent = (bmin.astype(np.float64) + bmax) * 0.5
    perm = np.arange(n)
    for level in range(depth):
        nseg = 1 << level
        bounds = (np.arange(nseg + 1) * n) // nseg
        seg = np.repeat(np.arange(nseg), np.diff(bounds))
        c = cent[perm]
        ext = np.maximum.reduceat(c, bounds[:-1]) - np.minimum.reduceat(c, bounds[:-1])
        ax = np.argmax(ext, axis=1)
        order = np.lexsort((c[np.arange(n), ax[seg]], seg))
        perm = perm[order]
    bounds = (np.arange(leaves + 1) * n) // leaves
    slot = np.arange(n) - np.repeat(bounds[:-1], np.diff(bounds))
    leaf_prims = np.full((leaves, LEAF), -1, np.int64)
    leaf_prims[np.repeat(np.arange(leaves), np.diff(bounds)), slot] = perm
    lo = np.minimum.reduceat(bmin[perm], bounds[:-1]) - BOX_PAD
    hi = np.maximum.reduceat(bmax[perm], bounds[:-1]) + BOX_PAD
    node_bmin = np.zeros((2 * leaves - 1, 3), np.float32)
    node_bmax = np.zeros((2 * leaves - 1, 3), np.float32)
    node_bmin[leaves - 1:], node_bmax[leaves - 1:] = lo, hi
    for level in range(depth - 1, -1, -1):
        k = np.arange((1 << level) - 1, (2 << level) - 1)
        node_bmin[k] = np.minimum(node_bmin[2 * k + 1], node_bmin[2 * k + 2])
        node_bmax[k] = np.maximum(node_bmax[2 * k + 1], node_bmax[2 * k + 2])
    return {"depth": depth, "node_bmin": node_bmin, "node_bmax": node_bmax,
            "leaf_prims": leaf_prims}


def _safe_inv(rd):
    return torch.where(rd.abs() > 1e-12, 1.0 / rd, torch.sign(rd) * 1e12 + 1e12)


def _moller_trumbore(rd, o, v0, e1, e2, t_min):
    """(t, u, v, hit) of rays (o, rd) against triangles (v0, e1, e2), all
    [..., 3] and broadcast."""
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    v0x, v0y, v0z = v0[..., 0], v0[..., 1], v0[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / det, 0.0)
    dx, dy, dz = ox - v0x, oy - v0y, oz - v0z
    tu = (dx * px + dy * py + dz * pz) * inv
    qx = dy * e1z - dz * e1y
    qy = dz * e1x - dx * e1z
    qz = dx * e1y - dy * e1x
    tv = (rdx * qx + rdy * qy + rdz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = ok & (tu >= 0.0) & (tv >= 0.0) & (tu + tv <= 1.0) & (tt > t_min)
    return tt, tu, tv, hit


def _sphere(rd, o, c, r, t_min):
    """(t, hit): the nearest root past t_min, [...] of [..., 3] inputs."""
    sx, sy, sz = o[..., 0] - c[..., 0], o[..., 1] - c[..., 1], o[..., 2] - c[..., 2]
    b = sx * rd[..., 0] + sy * rd[..., 1] + sz * rd[..., 2]
    cq = sx * sx + sy * sy + sz * sz - r * r
    disc = b * b - cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ta = -b - sq
    tb = -b + sq
    ts = torch.where(ta > t_min, ta, tb)
    return ts, (disc > 0.0) & (ts > t_min)


def _leaf(scene, slots, o, d, t, t_min):
    """The nearest hit among each lane's leaf prims `slots` [m, LEAF] (-1
    empty) below t [m]: (t, prim, u, v, closer), the first slot winning
    a tie as in a test of the slots in order."""
    num_tris = scene["num_tris"]
    o = o[:, None, :].expand(-1, LEAF, -1).contiguous()
    d = d[:, None, :].expand(-1, LEAF, -1).contiguous()
    valid = slots >= 0
    inf = torch.full_like(t, float("inf"))[:, None]
    tp = torch.broadcast_to(inf, slots.shape)
    uu = vv = torch.zeros_like(tp)
    if num_tris:
        tid = torch.clamp(slots, 0, scene["tri_v0"].shape[0] - 1)
        tt, uu, vv, h = _moller_trumbore(d, o, scene["tri_v0"][tid], scene["tri_e1"][tid],
                                         scene["tri_e2"][tid], t_min)
        tp = torch.where(h & valid & (slots < num_tris), tt, tp)
    if scene["num_spheres"]:
        sid = torch.clamp(slots - num_tris, 0, scene["sph_center"].shape[0] - 1)
        ts, h = _sphere(d, o, scene["sph_center"][sid], scene["sph_radius"][sid], t_min)
        is_sph = slots >= num_tris
        tp = torch.where(h & valid & is_sph, ts, tp)
        uu = torch.where(is_sph, 0.0, uu)
        vv = torch.where(is_sph, 0.0, vv)
    k = torch.argmin(tp, dim=1, keepdim=True)
    tk = tp.gather(1, k)[:, 0]
    closer = tk < t
    return (tk, slots.gather(1, k)[:, 0], uu.gather(1, k)[:, 0], vv.gather(1, k)[:, 0],
            closer)


def _slab(b0, b1, o, inv, t):
    """(entry t, hit) of boxes [b0, b1] against rays (o, inv = safe 1/d)
    with best t `t`."""
    tlo = (b0 - o) * inv
    thi = (b1 - o) * inv
    tsmall = torch.minimum(tlo, thi)
    tbig = torch.maximum(tlo, thi)
    t_enter = torch.maximum(torch.maximum(tsmall[:, 0], tsmall[:, 1]), tsmall[:, 2])
    t_exit = torch.minimum(torch.minimum(tbig[:, 0], tbig[:, 1]), tbig[:, 2])
    return t_enter, (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t)


def walk(scene, ro, rd, t0, t_min, any_hit=False):
    """Closest (or, with any_hit, some) hit of rays ro, rd [N, 3] in
    (t_min, t0): {t, prim, u, v, hit}, prim -1 and t = t0 on a miss.

    Each step pops one node a ray (a hit box, skipped if a closer hit came
    since it was pushed), tests its prims if it is a leaf, and otherwise
    tests both children's boxes and pushes the hit ones, the nearer on
    top.  Every lane does both halves, masked, so a step is a fixed list
    of operations; finished lanes leave the batch once an eighth of it
    has finished."""
    tree = scene["tree"]
    nb0, nb1, lprims = tree["node_bmin"], tree["node_bmax"], tree["leaf_prims"]
    n_nodes = nb0.shape[0]
    first_leaf = lprims.shape[0] - 1
    dev = ro.device
    n_all = ro.shape[0]
    t_out = t0.clone()
    prim_out = torch.full((n_all,), -1, dtype=torch.int64, device=dev)
    u_out = torch.zeros_like(t0)
    v_out = torch.zeros_like(t0)

    lane = torch.nonzero(t0 > t_min).squeeze(1)
    o, d, t = ro[lane], rd[lane], t0[lane]
    inv = _safe_inv(d)
    n = lane.numel()
    prim = torch.full_like(lane, -1)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    depth = tree["depth"] + 2
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, depth), dtype=t.dtype, device=dev)
    root_t, root_hit = _slab(nb0[:1], nb1[:1], o, inv, t)
    stack_t[:, 0] = root_t
    sp = root_hit.to(torch.int64)
    while n:
        ar = torch.arange(n, device=dev)
        top = torch.clamp(sp - 1, min=0)
        node = stack[ar, top]
        has = sp > 0
        if any_hit:
            has = has & (prim < 0)
        live = has & (stack_t[ar, top] < t)
        sp = sp - has.to(sp.dtype)
        is_leaf = node >= first_leaf

        slots = lprims[torch.clamp(node - first_leaf, min=0)]
        tk, pk, uk, vk, closer = _leaf(scene, slots, o, d, t, t_min)
        closer = closer & live & is_leaf
        t = torch.where(closer, tk, t)
        prim = torch.where(closer, pk, prim)
        u = torch.where(closer, uk, u)
        v = torch.where(closer, vk, v)

        inner = live & ~is_leaf
        c1 = torch.clamp(2 * node + 1, max=n_nodes - 1)
        c2 = torch.clamp(2 * node + 2, max=n_nodes - 1)
        e1, h1 = _slab(nb0[c1], nb1[c1], o, inv, t)
        e2, h2 = _slab(nb0[c2], nb1[c2], o, inv, t)
        one_near = e1 <= e2
        near, far = torch.where(one_near, c1, c2), torch.where(one_near, c2, c1)
        e_near, e_far = torch.where(one_near, e1, e2), torch.where(one_near, e2, e1)
        h_near = inner & torch.where(one_near, h1, h2)
        h_far = inner & torch.where(one_near, h2, h1)
        at = torch.clamp(sp, max=depth - 1)[:, None]
        stack.scatter_(1, at, far[:, None])
        stack_t.scatter_(1, at, e_far[:, None])
        at = torch.clamp(sp + h_far.to(sp.dtype), max=depth - 1)[:, None]
        stack.scatter_(1, at, near[:, None])
        stack_t.scatter_(1, at, e_near[:, None])
        sp = sp + h_far.to(sp.dtype) + h_near.to(sp.dtype)

        done = sp == 0
        if any_hit:
            done = done | (prim >= 0)
        n_done = int(done.sum())
        if n_done * 8 >= n:
            fin = lane[done]
            t_out[fin], prim_out[fin] = t[done], prim[done]
            u_out[fin], v_out[fin] = u[done], v[done]
            keep = ~done
            lane, o, d, inv, t = lane[keep], o[keep], d[keep], inv[keep], t[keep]
            prim, u, v, sp = prim[keep], u[keep], v[keep], sp[keep]
            stack, stack_t = stack[keep], stack_t[keep]
            n = lane.numel()
    return {"t": t_out, "prim": prim_out, "u": u_out, "v": v_out, "hit": prim_out >= 0}
