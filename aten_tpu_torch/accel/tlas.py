"""Two-level (TLAS/BLAS) acceleration with instance transforms.

Counterpart of aten_tpu/accel/tlas.py (the reference's two-level
threaded BVH, threaded_bvh.h:13-56 and threaded_bvh_traverser.h:99-304).
The instance-level tree and every object's tree live in one node pool:

* TLAS leaves carry `tl_inst >= 0`; their hit link is the owning
  object's BLAS root, their miss link the usual top-level skip link.
  Entering one latches the instance id and the resume link and moves
  the ray into object space with the instance's 3x4 world-to-local
  matrix.  The direction is not renormalised, so t stays
  world-parameterised across both levels.
* BLAS links are offset into the pool; "fell off the object's tree"
  (-1) becomes -2, which pops back to the world ray and the latched
  top-level link.

Two implementations return the same {t, prim, u, v, hit, inst}:
`_traverse_two_level_plain`, the oracle's walk in plain torch (the CPU
path, and on a card reached only through impl="plain"), and the CUDA
kernel `ops/tlas_cuda.py::tlas_traverse`.  Every 3x4 transform is
written out in one fixed order, ((m0*x + m1*y) + m2*z) + m3, which the
kernel repeats, so the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.accel.build import LEAF_MAX, build_bvh
from aten_tpu_torch.accel.traverse import _moller_trumbore, _safe_inv, _t0_of


def _transform_box(l2w: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """World AABB of a transformed local AABB (8-corner expansion)."""
    corners = np.array(
        [[bmin[0], bmin[1], bmin[2]], [bmax[0], bmin[1], bmin[2]],
         [bmin[0], bmax[1], bmin[2]], [bmax[0], bmax[1], bmin[2]],
         [bmin[0], bmin[1], bmax[2]], [bmax[0], bmin[1], bmax[2]],
         [bmin[0], bmax[1], bmax[2]], [bmax[0], bmax[1], bmax[2]]],
        np.float32,
    )
    w = corners @ l2w[:3, :3].T + l2w[:3, 3]
    return w.min(axis=0), w.max(axis=0)


def build_two_level(obj_prim_boxes, inst_obj, inst_l2w, leaf_max=LEAF_MAX):
    """The unified two-level node pool, as numpy arrays.

    obj_prim_boxes: per object, (bmin [P,3], bmax [P,3], prim_ids [P])
        in object-local space, prim ids global.
    inst_obj: [I] object of each instance; inst_l2w: [I,4,4].

    Returns tl_bmin/tl_bmax [K,3], tl_hit/tl_miss [K] (pool links; -1
    done, -2 back to the top level), tl_ps/tl_pc [K] (ranges into
    tl_prim_order; -1/0 off BLAS leaves), tl_inst [K] (instance id at
    TLAS leaves, else -1), tl_prim_order [P], inst_obj [I], inst_w2l
    [I+1,3,4] and inst_nmtx [I+1,3,3] (row I is the identity, for lanes
    that hit no instance) and inst_l2w [I,3,4].
    """
    inst_obj = np.asarray(inst_obj, np.int32)
    inst_l2w = np.asarray(inst_l2w, np.float32).reshape(-1, 4, 4)
    I = inst_obj.shape[0]
    if I == 0:
        raise ValueError("build_two_level needs at least one instance")

    blas = []
    obj_bbox = []
    for bmin, bmax, _pids in obj_prim_boxes:
        blas.append(build_bvh(np.asarray(bmin, np.float32),
                              np.asarray(bmax, np.float32), leaf_max=leaf_max))
        obj_bbox.append((np.asarray(bmin).min(axis=0), np.asarray(bmax).max(axis=0)))

    # instance-level tree over world boxes; one instance per leaf
    iw_min = np.empty((I, 3), np.float32)
    iw_max = np.empty((I, 3), np.float32)
    for i in range(I):
        lo, hi = obj_bbox[inst_obj[i]]
        iw_min[i], iw_max[i] = _transform_box(inst_l2w[i], lo, hi)
    tlas = build_bvh(iw_min, iw_max, leaf_max=1, use_native=False)

    Kt = tlas["nodes_bmin"].shape[0]
    blas_base = np.empty(len(blas), np.int64)
    prim_base = np.empty(len(blas), np.int64)
    base = Kt
    pbase = 0
    for o, b in enumerate(blas):
        blas_base[o] = base
        prim_base[o] = pbase
        base += b["nodes_bmin"].shape[0]
        pbase += b["prim_order"].shape[0]
    K = base

    tl_bmin = np.empty((K, 3), np.float32)
    tl_bmax = np.empty((K, 3), np.float32)
    tl_hit = np.empty(K, np.int32)
    tl_miss = np.empty(K, np.int32)
    tl_ps = np.full(K, -1, np.int32)
    tl_pc = np.zeros(K, np.int32)
    tl_inst = np.full(K, -1, np.int32)
    tl_prim_order = np.empty(pbase, np.int32)

    tl_bmin[:Kt] = tlas["nodes_bmin"]
    tl_bmax[:Kt] = tlas["nodes_bmax"]
    tl_hit[:Kt] = tlas["nodes_hit"]
    tl_miss[:Kt] = tlas["nodes_miss"]
    for k in range(Kt):
        ps = tlas["nodes_prim_start"][k]
        if ps >= 0:
            iid = int(tlas["prim_order"][ps])
            tl_inst[k] = iid
            tl_hit[k] = blas_base[inst_obj[iid]]

    for o, b in enumerate(blas):
        kb = b["nodes_bmin"].shape[0]
        s = int(blas_base[o])
        tl_bmin[s : s + kb] = b["nodes_bmin"]
        tl_bmax[s : s + kb] = b["nodes_bmax"]
        for name, dst in (("nodes_hit", tl_hit), ("nodes_miss", tl_miss)):
            links = b[name].astype(np.int64)
            dst[s : s + kb] = np.where(links < 0, -2, links + s).astype(np.int32)
        ps = b["nodes_prim_start"].astype(np.int64)
        tl_ps[s : s + kb] = np.where(ps < 0, -1, ps + prim_base[o]).astype(np.int32)
        tl_pc[s : s + kb] = b["nodes_prim_count"]
        pids = np.asarray(obj_prim_boxes[o][2], np.int32)
        tl_prim_order[prim_base[o] : prim_base[o] + len(pids)] = pids[b["prim_order"]]

    inst_w2l = np.empty((I + 1, 3, 4), np.float32)
    inst_nmtx = np.empty((I + 1, 3, 3), np.float32)
    for i in range(I):
        w2l = np.linalg.inv(inst_l2w[i])
        inst_w2l[i] = w2l[:3, :4]
        inst_nmtx[i] = w2l[:3, :3].T
    inst_w2l[I] = np.eye(4, dtype=np.float32)[:3, :4]
    inst_nmtx[I] = np.eye(3, dtype=np.float32)

    return {
        "tl_bmin": tl_bmin, "tl_bmax": tl_bmax,
        "tl_hit": tl_hit, "tl_miss": tl_miss,
        "tl_ps": tl_ps, "tl_pc": tl_pc, "tl_inst": tl_inst,
        "tl_prim_order": tl_prim_order,
        "inst_obj": inst_obj,
        "inst_w2l": inst_w2l, "inst_nmtx": inst_nmtx,
        "inst_l2w": inst_l2w[:, :3, :4].copy(),
    }


def apply_affine(m, x, y, z, translate):
    """Rows of m [N,3,>=3] applied to (x, y, z) in the fixed order
    ((m0*x + m1*y) + m2*z) (+ m3 when `translate`).  Returns [N,3]."""
    rows = []
    for i in range(3):
        r = m[:, i, 0] * x + m[:, i, 1] * y + m[:, i, 2] * z
        rows.append(r + m[:, i, 3] if translate else r)
    return torch.stack(rows, dim=-1)


def _isect_sphere_general(ox, oy, oz, dx, dy, dz, c, r, t_min):
    """Sphere quadratic a t^2 + 2 b t + c for a non-unit object-space
    direction, in the reference's op order (tlas.py:171-184).  (t, hit)."""
    sx, sy, sz = ox - c[:, 0], oy - c[:, 1], oz - c[:, 2]
    a = dx * dx + dy * dy + dz * dz
    b = sx * dx + sy * dy + sz * dz
    cq = sx * sx + sy * sy + sz * sz - r * r
    disc = b * b - a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=1e-20)
    ta = (-b - sq) * inv_a
    tb = (-b + sq) * inv_a
    ts = torch.where(ta > t_min, ta, tb)
    return ts, (disc > 0.0) & (ts > t_min)


def _traverse_two_level_plain(scene, ro, rd, t0, any_hit, t_min, stats=False):
    """The oracle's two-level walk (reference tlas.py:187-307) over the
    lanes still walking.  Each lane runs the reference's per-lane steps;
    finished lanes are compacted away, which changes no result.

    With stats=True also returns {"node_steps", "prim_tests",
    "inst_entries"}: box tests, primitive tests and instance entries
    summed over the lanes, the work these rays need."""
    dev = ro.device
    N = ro.shape[0]
    num_tris = scene["num_tris"]
    n_inst = scene["num_instances"]
    T = scene["tri_v0"].shape[0]
    S = scene["sph_center"].shape[0]
    nbmin, nbmax = scene["tl_bmin"], scene["tl_bmax"]
    nhit, nmiss = scene["tl_hit"], scene["tl_miss"]
    nps, npc = scene["tl_ps"].long(), scene["tl_pc"]
    ninst = scene["tl_inst"]
    order = scene["tl_prim_order"].long()
    P = order.shape[0]
    w2l = scene["inst_w2l"]
    tv0, te1, te2 = scene["tri_v0"], scene["tri_e1"], scene["tri_e2"]
    scen, srad = scene["sph_center"], scene["sph_radius"]

    t_out = t0.clone()
    prim_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    inst_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((N,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((N,), dtype=torch.float32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)

    # lanes with t0 <= t_min can never hit; they keep (t0, -1, -1, 0, 0)
    lane = torch.nonzero(t0 > t_min).squeeze(1)
    wo, wd = ro[lane], rd[lane]        # world ray
    o, d = wo, wd                      # current-space ray
    inv = _safe_inv(d)
    t = t0[lane]
    cur = torch.zeros(lane.shape, dtype=torch.int32, device=dev)
    resume = torch.full_like(cur, -1)
    inst = torch.full_like(cur, -1)
    prim = torch.full_like(cur, -1)
    binst = torch.full_like(cur, -1)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    while lane.numel():
        # pop back to the top level where a BLAS walk fell off (-2)
        pop = cur == -2
        if bool(pop.any()):
            cur = torch.where(pop, resume, cur)
            inst = torch.where(pop, -1, inst)
            p3 = pop[:, None]
            o = torch.where(p3, wo, o)
            d = torch.where(p3, wd, d)
            inv = torch.where(p3, _safe_inv(wd), inv)
        done = cur < 0
        if bool(done.any()):
            fin = lane[done]
            t_out[fin] = t[done]
            prim_out[fin] = prim[done]
            inst_out[fin] = binst[done]
            u_out[fin] = u[done]
            v_out[fin] = v[done]
            keep = ~done
            lane, wo, wd, o, d, inv = (x[keep] for x in (lane, wo, wd, o, d, inv))
            t, cur, resume, inst, prim, binst, u, v = (
                x[keep] for x in (t, cur, resume, inst, prim, binst, u, v))
            if not lane.numel():
                break
        c = cur.long()
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        tlo = (nbmin[c] - o) * inv
        thi = (nbmax[c] - o) * inv
        tsmall = torch.minimum(tlo, thi)
        tbig = torch.maximum(tlo, thi)
        t_enter = torch.maximum(torch.maximum(tsmall[:, 0], tsmall[:, 1]), tsmall[:, 2])
        t_exit = torch.minimum(torch.minimum(tbig[:, 0], tbig[:, 1]), tbig[:, 2])
        ahit = (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t)
        ps = nps[c]
        pc = npc[c]
        do_leaf = ahit & (ps >= 0)
        if stats:
            counts[0] += lane.numel()
        for k in range(LEAF_MAX):
            valid = do_leaf & (k < pc)
            if not bool(valid.any()):
                break
            if stats:
                counts[1] += valid.sum()
            pid = order[torch.clamp(ps + k, 0, P - 1)]
            is_tri = pid < num_tris
            tid = torch.clamp(pid, 0, T - 1)
            sid = torch.clamp(pid - num_tris, 0, S - 1)
            a0, a1, a2 = tv0[tid], te1[tid], te2[tid]
            t_t, tu, tv, h_t = _moller_trumbore(
                dx, dy, dz, ox, oy, oz,
                (a0[:, 0], a0[:, 1], a0[:, 2]),
                (a1[:, 0], a1[:, 1], a1[:, 2]),
                (a2[:, 0], a2[:, 1], a2[:, 2]), t_min)
            t_s, h_s = _isect_sphere_general(ox, oy, oz, dx, dy, dz,
                                             scen[sid], srad[sid], t_min)
            t_p = torch.where(is_tri, t_t, t_s)
            closer = torch.where(is_tri, h_t, h_s) & valid & (t_p < t)
            t = torch.where(closer, t_p, t)
            prim = torch.where(closer, pid.to(torch.int32), prim)
            binst = torch.where(closer, inst, binst)
            u = torch.where(closer, torch.where(is_tri, tu, 0.0), u)
            v = torch.where(closer, torch.where(is_tri, tv, 0.0), v)
        # TLAS leaf hit: latch the instance, move into object space
        leaf_inst = ninst[c]
        missl = nmiss[c]
        enter = ahit & (leaf_inst >= 0)
        if bool(enter.any()):
            if stats:
                counts[2] += enter.sum()
            m = w2l[torch.clamp(leaf_inst, 0, n_inst - 1).long()]
            wx, wy, wz = wo[:, 0], wo[:, 1], wo[:, 2]
            ro_l = apply_affine(m, wx, wy, wz, translate=True)
            rd_l = apply_affine(m, wd[:, 0], wd[:, 1], wd[:, 2], translate=False)
            e3 = enter[:, None]
            o = torch.where(e3, ro_l, o)
            d = torch.where(e3, rd_l, d)
            inv = torch.where(e3, _safe_inv(rd_l), inv)
            inst = torch.where(enter, leaf_inst, inst)
            resume = torch.where(enter, missl, resume)
        cur = torch.where(ahit, nhit[c], missl)
        if any_hit:
            cur = torch.where(prim >= 0, -1, cur)
    out = {"t": t_out, "prim": prim_out, "u": u_out, "v": v_out,
           "hit": prim_out >= 0, "inst": inst_out}
    if stats:
        n = counts.tolist()
        return out, {"node_steps": n[0], "prim_tests": n[1], "inst_entries": n[2]}
    return out


def traverse_two_level(scene, ro, rd, t_max=None, any_hit=False, t_min=1e-4,
                       impl="auto"):
    """Closest (or any) hit of rays ro, rd [N,3] against an instanced
    scene.  Returns {t, prim, u, v, hit, inst}, each [N]; inst is the
    instance of the hit (-1 on a miss), prim the global prim id.

    impl: "auto" and "cuda" take the CUDA kernel (its plain version for
    CPU tensors), "plain" the plain walk."""
    if impl not in ("auto", "plain", "cuda"):
        raise ValueError(f"two-level traversal has no impl {impl!r}")
    ro = ro.detach().contiguous()
    rd = rd.detach().contiguous()
    t0 = _t0_of(t_max, ro.shape[0], ro.device)
    if impl == "plain":
        return _traverse_two_level_plain(scene, ro, rd, t0, any_hit, t_min)
    from aten_tpu_torch.ops.tlas_cuda import tlas_traverse

    t, prim, inst, u, v = tlas_traverse(scene, ro, rd, t0, any_hit=any_hit,
                                        t_min=t_min)
    return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0, "inst": inst}
