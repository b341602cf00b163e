"""Batched closest-hit / any-hit traversal.

Counterpart of aten_tpu/accel/traverse.py (the reference's
BvhTraverser::Traverse, threaded_bvh_traverser.h:99-304).  These
implementations return the same {t, prim, u, v, hit}:

* `_traverse_dense`: every ray against every prim, for scenes of at most
  DENSE_MAX_PRIMS prims (the Cornell box), in the reference's prim order
  with a strict `<` so ties break the same way.
* `_traverse_plain`: the reference oracle's lane-parallel stackless walk
  of the threaded hit/miss links (`traverse(impl="jax")`), in plain
  torch.  It is the CUDA kernel's plain version: the CPU path, and on a
  card reached only through impl="plain".
* the CUDA kernel `ops/traverse_cuda.py::bvh_traverse`, one ray per
  thread walking the same links with the same arithmetic, over the
  packed records of ops/bvh_layout.py.
* for scenes that carry the Plücker layout (ops/plk_layout.py; the
  reference's choice of its kernel K3 for large triangle-only scenes):
  the CUDA kernel `ops/plk_cuda.py::plk_traverse` and its plain version
  `_traverse_plk_plain`, a walk of the cut tree that tests whole fat
  leaves with Plücker coordinates and returns the kernel's truncated t;
  u/v of the winner come from `recompute_uv`.
* for scenes that carry the treelet layout (ops/trl_layout.py; every
  single-level scene on the reference's treelet branch): the multi-chain
  CUDA kernel K4 `ops/smt_cuda.py::smt_traverse` and its plain version
  `_traverse_trl_plain`, a walk of the cut tree's direction-ordered
  links that drains each fat leaf one step after entering it; u/v of the
  winner come from `recompute_uv`.

The kernel policy is the reference's (traverse_pallas.py:336-337,
2041-2064), read once at import from the environment:
ATEN_TPU_KERNEL = "v3" (the default: K1, and K3 over the 32 MB pool
line), "smt" (K4 on every treelet scene), "plk" (K3 on every
triangle-only treelet scene) or "mt" (K1 on every treelet scene), and
ATEN_TPU_CHAINS, K4's rays per lane.  The scene build applies it
(scene/scene.py) and names the kernel in the static `traversal`.

Instanced scenes (those that carry `tl_bmin`) go to the two-level walk
of accel/tlas.py before any of these, as in the reference (:153-158).

Voxel LOD (accel/voxel.py; reference :165-176, :260-291): in a scene
with `has_voxel_lod` a voxel node deep enough hits as a solid box at its
entry t, with the id `num_tris + num_spheres + node`, and the walk skips
its subtree; voxels fire for any-hit rays too, and an equal entry t goes
to the smaller id.  The oracle walk `_traverse_plain` tests each voxel's
depth against the scene's `lod_depth`; the three kernels and their plain
versions walk the tree baked at `lod_bake_depth` (ops/lod_layout.py), in
which a voxel leaf carries its id.  The two differ only where a ray
starts inside a voxel's box (its entry t <= t_min): the oracle then
enters the subtree, which the baked tree no longer has.  Such a scene
never takes the dense test.

Work counts: the oracle walk returns each ray's node steps as `steps`,
as the reference's does (:240-241, read by utils/debug.py's heatmap).
With stats=True the three plain walks also return totals and per-ray
counts ("counts"), the ones the kStats instantiations of K1 and K3 store
(ops/traverse_cuda.py, ops/plk_cuda.py), which tools/trav_stats.py
reads.

`occlusion_alpha` is the shadow test of scenes with alpha: a bounded
loop of closest-hit walks through alpha surfaces (reference :478-530).

Traversal is discrete structure: it reads its rays and their t_max
without gradients, as the reference stops them (traverse.py:169), so a
kernel inside an autograd graph sees no tensor that requires grad.
"""
from __future__ import annotations

import os

import torch

from aten_tpu_torch.accel.build import LEAF_MAX
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.ops.bvh_layout import LEAF_COUNT, LEAF_SHIFT
from aten_tpu_torch.ops.lod_layout import VOXEL_WORD
from aten_tpu_torch.ops.plk_layout import MAX_WINDOW
from aten_tpu_torch.ops.smt_cuda import CHAIN_COUNTS, DEFAULT_CHAINS
from aten_tpu_torch.utils import spans

# Below this primitive count every ray tests every prim (reference :34).
DENSE_MAX_PRIMS = 512

# The kernel policy, snapshotted once at import as the reference does.
KERNEL_POLICIES = ("v3", "smt", "plk", "mt")
KERNEL = os.environ.get("ATEN_TPU_KERNEL", "v3")
# K4's rays per lane.  The reference defaults to 4 (traverse_pallas.py:337);
# the port defaults to the count its kernel ran fastest on the card
# (ops/smt_cuda.py::DEFAULT_CHAINS, PERF.md).
CHAINS = int(os.environ.get("ATEN_TPU_CHAINS", str(DEFAULT_CHAINS)))
if KERNEL not in KERNEL_POLICIES:
    raise ValueError(
        f"ATEN_TPU_KERNEL={KERNEL!r} is not a kernel policy of the port "
        f"{KERNEL_POLICIES}; the reference knows no other either (ROADMAP.md "
        "queue 2, the kernel table)")
if CHAINS not in CHAIN_COUNTS:
    raise ValueError(f"ATEN_TPU_CHAINS={CHAINS} is not one of the rays per lane K4 is "
                     f"built for {CHAIN_COUNTS}")


def _safe_inv(rd):
    return torch.where(rd.abs() > 1e-12, 1.0 / rd, torch.sign(rd) * 1e12 + 1e12)


def _slab(b0, b1, o, inv):
    """(t_enter, t_exit) of boxes [b0, b1] against rays (o, inv = safe
    1/d), in the oracle's op order (reference :243-259)."""
    tlo = (b0 - o) * inv
    thi = (b1 - o) * inv
    tsmall = torch.minimum(tlo, thi)
    tbig = torch.maximum(tlo, thi)
    t_enter = torch.maximum(torch.maximum(tsmall[:, 0], tsmall[:, 1]), tsmall[:, 2])
    t_exit = torch.minimum(torch.minimum(tbig[:, 0], tbig[:, 1]), tbig[:, 2])
    return t_enter, t_exit


def _slab_hit(b0, b1, o, inv, t):
    """Slab test of boxes [b0, b1] against rays (o, inv = safe 1/d) with
    best t `t`, in the oracle's op order (reference :243-259)."""
    t_enter, t_exit = _slab(b0, b1, o, inv)
    return (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t)


def _voxel_hit(vid, t_enter, t_exit, t, best, t_min):
    """Where a voxel (vid >= 0, its id) records a hit: the box is hit
    past t_min, and its entry t beats `t`, or equals it and vid is below
    the winner's id `best` (reference :260-291)."""
    return ((vid >= 0) & (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter > t_min)
            & ((t_enter < t) | ((t_enter == t) & (vid < best))))


def _voxel_of_word(word):
    """The voxel id a layout word holds (ops/lod_layout.py), -1 elsewhere."""
    return torch.where(word <= VOXEL_WORD, VOXEL_WORD - word, -1)


def _walk_tree(scene, baked):
    """(bmin, bmax, hit, miss, prim start, prim count, prim order, vox) of
    the tree `_traverse_plain` walks; vox [K] the id with which each node
    hits as a voxel (-1 elsewhere), None without LOD.  baked=False: the
    scene's own BVH, its voxels those at depth >= scene["lod_depth"];
    baked=True: K1's packed records (ops/bvh_layout.py), the tree of a
    voxel-LOD scene baked at lod_bake_depth."""
    if not baked:
        vox = None
        if scene.get("has_voxel_lod"):
            K = scene["nodes_depth"].shape[0]
            vox_base = scene["num_tris"] + scene["num_spheres"]
            node = torch.arange(K, dtype=torch.int32, device=scene["nodes_depth"].device)
            vox = torch.where((scene["nodes_voxel_mtl"] >= 0)
                              & (scene["nodes_depth"] >= scene["lod_depth"]), vox_base + node, -1)
        return (scene["nodes_bmin"], scene["nodes_bmax"], scene["nodes_hit"].long(),
                scene["nodes_miss"].long(), scene["nodes_prim_start"].long(),
                scene["nodes_prim_count"], scene["prim_order"].long(), vox)
    if "bvh_nodes" not in scene:
        raise ValueError("the scene lacks K1's packed records (scene.scene.with_bvh_layout "
                         "attaches them)")
    rec = scene["bvh_nodes"]
    ints = rec.view(torch.int32)
    miss, leaf = ints[:, 3].long(), ints[:, 7]
    K = rec.shape[0]
    hit = torch.where(leaf != -1, miss, torch.arange(1, K + 1, device=rec.device))
    ps = torch.where(leaf >= 0, leaf >> LEAF_SHIFT, -1).long()
    pc = torch.where(leaf >= 0, leaf & LEAF_COUNT, 0)
    order = scene["bvh_prims"].view(torch.int32)[:, 3].long()
    return rec[:, 0:3], rec[:, 4:7], hit, miss, ps, pc, order, _voxel_of_word(leaf)


def _t0_of(t_max, n, device):
    """The rays' t_max as a contiguous [n] tensor, detached like the rays
    (a shadow ray's length can depend on a trained light position)."""
    if t_max is None:
        return torch.full((n,), vm.INF, dtype=torch.float32, device=device)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=device).detach()
    return torch.broadcast_to(t_max, (n,)).contiguous()


def _moller_trumbore(rdx, rdy, rdz, ox, oy, oz, v0, e1, e2, t_min):
    """Component-form Möller-Trumbore in the reference's op order
    (traverse.py:304-323).  Returns (t, u, v, hit)."""
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
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


def _sphere(rdx, rdy, rdz, ox, oy, oz, c, r, t_min):
    """Nearest root past t_min in the reference's op order.  (t, hit)."""
    cx, cy, cz = c
    sx, sy, sz = ox - cx, oy - cy, oz - cz
    b = sx * rdx + sy * rdy + sz * rdz
    cq = sx * sx + sy * sy + sz * sz - r * r
    disc = b * b - cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ta = -b - sq
    tb = -b + sq
    ts = torch.where(ta > t_min, ta, tb)
    return ts, (disc > 0.0) & (ts > t_min)


def _traverse_dense(scene, ro, rd, t0, t_min):
    """All-prims test: triangles in id order, then spheres (ref :38)."""
    num_tris = scene["num_tris"]
    num_sph = scene["num_spheres"]
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    t_best = t0.clone()
    prim = torch.full_like(t0, -1, dtype=torch.int32)
    ub = torch.zeros_like(t0)
    vb = torch.zeros_like(t0)
    # prim data as host floats: exact float32 values, one transfer
    v0 = scene["tri_v0"].tolist()
    e1 = scene["tri_e1"].tolist()
    e2 = scene["tri_e2"].tolist()
    cen = scene["sph_center"].tolist()
    rad = scene["sph_radius"].tolist()
    for i in range(num_tris):
        tt, tu, tv, h = _moller_trumbore(
            rdx, rdy, rdz, ox, oy, oz, v0[i], e1[i], e2[i], t_min)
        h = h & (tt < t_best)
        t_best = torch.where(h, tt, t_best)
        prim = torch.where(h, i, prim)
        ub = torch.where(h, tu, ub)
        vb = torch.where(h, tv, vb)
    for i in range(num_sph):
        ts, h = _sphere(rdx, rdy, rdz, ox, oy, oz, cen[i], rad[i], t_min)
        h = h & (ts < t_best)
        t_best = torch.where(h, ts, t_best)
        prim = torch.where(h, num_tris + i, prim)
    hit = t_best < t0
    prim = torch.where(hit, prim, -1)
    return {"t": t_best, "prim": prim, "u": ub, "v": vb, "hit": hit}


def _traverse_plain(scene, ro, rd, t0, any_hit, t_min, stats=False, baked=False):
    """The oracle's threaded walk (reference :189-351) over the lanes
    still walking.  Each lane runs exactly the reference's per-lane
    steps; finished lanes are compacted away, which changes no result.
    Any-hit lanes stop after the step that found a hit.

    In a voxel-LOD scene each step first takes the voxel branch (reference
    :260-291): over the scene's own tree at scene["lod_depth"] (the
    oracle), or with baked=True over K1's records of the tree baked at
    lod_bake_depth (`_walk_tree`): the K1 kernel's plain version there.

    The hits carry `steps` [N] int32, each lane's node steps (every
    iteration it takes with cur >= 0, voxel nodes included), as the
    reference oracle counts them (:240-241) for its heatmap; a lane with
    t0 <= t_min takes none here, where the reference walks it without a
    possible hit.

    With stats=True also returns {"node_steps", "prim_tests"} and, with
    LOD, "voxel_tests": box tests, primitive tests and voxel tests summed
    over the lanes, the work these rays need (the counterpart of the
    reference kernel's `stats` variant); and the hits carry "counts",
    {"node_steps", "prim_tests"} per lane, the counts K1's kStats
    instantiations store: an any-hit lane counts the prims of a leaf up to
    its first accepted hit, where the kernel stops the leaf
    (bvh_traverse.cu), though this walk tests the rest."""
    dev = ro.device
    N = ro.shape[0]
    num_tris = scene["num_tris"]
    T = scene["tri_v0"].shape[0]
    S = scene["sph_center"].shape[0]
    nbmin, nbmax, nhit, nmiss, nps, npc, order, vox = _walk_tree(scene, baked)
    P = order.shape[0]
    tv0, te1, te2 = scene["tri_v0"], scene["tri_e1"], scene["tri_e2"]
    scen, srad = scene["sph_center"], scene["sph_radius"]

    t_out = t0.clone()
    prim_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((N,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((N,), dtype=torch.float32, device=dev)

    # lanes with t0 <= t_min can never hit; they keep (t0, -1, 0, 0)
    lane = torch.nonzero(t0 > t_min).squeeze(1)
    o = ro[lane]
    d = rd[lane]
    inv = _safe_inv(d)
    t = t0[lane]
    cur = torch.zeros_like(lane)
    prim = torch.full_like(lane, -1, dtype=torch.int32)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    steps_out = torch.zeros((N,), dtype=torch.int32, device=dev)
    tests_out = torch.zeros((N,), dtype=torch.int32, device=dev)
    steps = torch.zeros_like(lane, dtype=torch.int32)
    tests = torch.zeros_like(lane, dtype=torch.int32)
    while lane.numel():
        steps += 1
        if stats:
            counts[0] += lane.numel()
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        rdx, rdy, rdz = d[:, 0], d[:, 1], d[:, 2]
        if vox is None:
            ahit = _slab_hit(nbmin[cur], nbmax[cur], o, inv, t)
        else:
            t_enter, t_exit = _slab(nbmin[cur], nbmax[cur], o, inv)
            ahit = (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t)
            vid = vox[cur]
            if stats:
                counts[2] += (vid >= 0).sum()
            # a voxel hit takes the miss link: the subtree is skipped
            ahit = ahit & ~((vid >= 0) & (t_enter > t_min))
            closer = _voxel_hit(vid, t_enter, t_exit, t, prim, t_min)
            t = torch.where(closer, t_enter, t)
            prim = torch.where(closer, vid, prim)
            u = torch.where(closer, 0.0, u)
            v = torch.where(closer, 0.0, v)
        ps = nps[cur]
        pc = npc[cur]
        do_leaf = ahit & (ps >= 0)
        taken = torch.zeros_like(do_leaf)  # any-hit: the leaf had an accepted hit
        for k in range(LEAF_MAX):
            valid = do_leaf & (k < pc)
            if not bool(valid.any()):
                break
            if stats:
                counts[1] += valid.sum()
                tests += valid & ~taken
            pid = order[torch.clamp(ps + k, 0, P - 1)]
            is_tri = pid < num_tris
            tid = torch.clamp(pid, 0, T - 1)
            sid = torch.clamp(pid - num_tris, 0, S - 1)
            a0, a1, a2 = tv0[tid], te1[tid], te2[tid]
            t_t, tu, tv, h_t = _moller_trumbore(
                rdx, rdy, rdz, ox, oy, oz,
                (a0[:, 0], a0[:, 1], a0[:, 2]),
                (a1[:, 0], a1[:, 1], a1[:, 2]),
                (a2[:, 0], a2[:, 1], a2[:, 2]), t_min)
            c = scen[sid]
            t_s, h_s = _sphere(rdx, rdy, rdz, ox, oy, oz,
                               (c[:, 0], c[:, 1], c[:, 2]), srad[sid], t_min)
            t_p = torch.where(is_tri, t_t, t_s)
            closer = torch.where(is_tri, h_t, h_s) & valid & (t_p < t)
            t = torch.where(closer, t_p, t)
            prim = torch.where(closer, pid.to(torch.int32), prim)
            u = torch.where(closer, torch.where(is_tri, tu, 0.0), u)
            v = torch.where(closer, torch.where(is_tri, tv, 0.0), v)
            if any_hit:
                taken |= closer
        cur = torch.where(ahit, nhit[cur], nmiss[cur])
        if any_hit:
            cur = torch.where(prim >= 0, -1, cur)
        done = cur < 0
        if bool(done.any()):
            fin = lane[done]
            t_out[fin] = t[done]
            prim_out[fin] = prim[done]
            u_out[fin] = u[done]
            v_out[fin] = v[done]
            steps_out[fin] = steps[done]
            tests_out[fin] = tests[done]
            keep = ~done
            lane, o, d, inv = lane[keep], o[keep], d[keep], inv[keep]
            t, cur, prim, u, v = t[keep], cur[keep], prim[keep], u[keep], v[keep]
            steps, tests = steps[keep], tests[keep]
    out = {"t": t_out, "prim": prim_out, "u": u_out, "v": v_out,
           "hit": prim_out >= 0, "steps": steps_out}
    if stats:
        out["counts"] = {"node_steps": steps_out, "prim_tests": tests_out}
        n = counts.tolist()
        work = {"node_steps": n[0], "prim_tests": n[1]}
        return out, (work if vox is None else {**work, "voxel_tests": n[2]})
    return out


# The per-ray counts of the treelet walks' stats: node steps, leaves
# entered or drained, slot tests.
TREELET_COUNTS = ("node_steps", "leaves", "slot_tests")


class _PerRay:
    """Per-ray counts TREELET_COUNTS of a compacting walk: `lane` holds
    the walking lanes' int32 counts, `retire` stores the finished ones;
    all no-ops without stats."""

    def __init__(self, n, lane, on):
        self.on = on
        if on:
            self.out = [torch.zeros((n,), dtype=torch.int32, device=lane.device)
                        for _ in TREELET_COUNTS]
            self.lane = [torch.zeros_like(lane, dtype=torch.int32) for _ in TREELET_COUNTS]

    def retire(self, fin, done, keep):
        if self.on:
            for out, c in zip(self.out, self.lane):
                out[fin] = c[done]
            self.lane = [c[keep] for c in self.lane]

    def counts(self):
        return dict(zip(TREELET_COUNTS, self.out))


# K3's winner code: the slot's index in its leaf fills the low
# log2(window) mantissa bits of t (traverse_pallas.py:1073-1076,
# :1144-1146); +inf, slot 0, stands for no hit.
_PLK_SENT = 0x7F800000
# (lane, slot) pairs the plain leaf test takes at once
_PLK_PAIRS = 1 << 22


def _plk_safe_inv(d):
    """K3's safe inverse (traverse_pallas.py:1094-1097), which differs
    from `_safe_inv` for components in [-1e-12, 0)."""
    return torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)


def _plk_leaf_codes(consts, slot, j, d, mw, o, t_min, nb):
    """Winner codes of (lane, slot) pairs: the Plücker test of
    traverse_pallas.py:1131-1145 in its op order.  slot, j [n] int; d, mw,
    o [n,3] the pairs' rd, ro x rd and ro; nb = window - 1, the code's
    slot bits."""
    e = consts[slot]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    mx, my, mz = mw[:, 0], mw[:, 1], mw[:, 2]

    def side(k):
        return (((((e[:, k] * dx + e[:, k + 1] * dy) + e[:, k + 2] * dz)
                  + e[:, k + 3] * mx) + e[:, k + 4] * my) + e[:, k + 5] * mz)

    s0 = side(0)
    s1 = side(6)
    den = (e[:, 12] * dx + e[:, 13] * dy) + e[:, 14] * dz
    numn = (((-e[:, 12]) * o[:, 0] + (-e[:, 13]) * o[:, 1])
            + (-e[:, 14]) * o[:, 2]) + e[:, 15]
    s2 = den - s0 - s1
    idn = den.view(torch.int32)
    signok = ((s0.view(torch.int32) ^ idn) | (s1.view(torch.int32) ^ idn)
              | (s2.view(torch.int32) ^ idn)) >= 0
    tt = numn * (1.0 / den)  # den = 0: inf or NaN, never valid
    valid = signok & (tt > t_min)
    code = (tt.view(torch.int32) & ~nb) | j.to(torch.int32)
    return torch.where(valid, code, _PLK_SENT)


def _leaf_pairs(ss, cnt):
    """The (lane, slot) pairs of lanes testing fat leaves (slots ss ..
    ss+cnt-1), in chunks of lanes of at most _PLK_PAIRS pairs (a leaf
    holds at most MAX_WINDOW): per chunk (a, n, lane_of, j, slot), the
    chunk's first lane a and its n lanes, and per pair its lane in the
    chunk, its index in the leaf and its slot."""
    per = max(1, _PLK_PAIRS // MAX_WINDOW)
    for a in range(0, ss.shape[0], per):
        c = cnt[a:a + per].long()
        n = c.shape[0]
        lane_of = torch.repeat_interleave(torch.arange(n, device=c.device), c)
        j = torch.arange(lane_of.shape[0], device=c.device) - (torch.cumsum(c, 0) - c)[lane_of]
        yield a, n, lane_of, j, ss[a:a + per].long()[lane_of] + j


def _plk_leaves(consts, ss, cnt, d, mw, o, t_min, nb):
    """Least winner code of each lane's fat leaf (slots ss .. ss+cnt-1),
    `_PLK_SENT` where no slot is hit; nb = window - 1."""
    best = torch.full((ss.shape[0],), _PLK_SENT, dtype=torch.int32, device=ss.device)
    for a, n, lane_of, j, slot in _leaf_pairs(ss, cnt):
        code = _plk_leaf_codes(consts, slot, j, d[a:a + n][lane_of],
                               mw[a:a + n][lane_of], o[a:a + n][lane_of], t_min, nb)
        best[a:a + n].scatter_reduce_(0, lane_of, code, "amin")
    return best


def _traverse_plk_plain(scene, ro, rd, t0, any_hit, t_min, stats=False):
    """Plain version of the K3 kernel (ops/plk_cuda.py): each lane walks
    the cut tree's threaded links with K3's slab test and safe inverse;
    at a fat leaf it takes the least winner code over the leaf's slots
    (ties to the smaller slot) and keeps it on a strict `<` of its
    truncated t, as the reference kernel merges (traverse_pallas.py
    :1148-1156); the code's slot bits, and so t's truncation, follow the
    layout's window (`plk_window`).  Any-hit lanes stop after the leaf
    that found a hit; lanes with t0 <= t_min keep (t0, -1).  Returns {"t", "prim"}, t the
    truncated t of the winner (t0 on a miss), prim its global id.

    In a voxel-LOD scene a voxel leaf of the baked cut tree (its slot
    start VOXEL_WORD - id) records its raw entry t under `_voxel_hit`'s
    rule, with its id shifted above the slots (id + n_slots), as the
    reference kernel does (:1214-1224); the shift is undone at the end
    (the reference's wrapper, :2113-2117).

    With stats=True also returns {"node_steps", "leaves", "slot_tests"}
    (and "voxel_tests" with LOD) summed over the lanes: box tests, fat
    leaves entered, (lane, slot) Plücker tests and voxel tests; and the
    hits carry "counts", {"node_steps", "leaves", "slot_tests"} per lane,
    the counts K3's kStats instantiations store."""
    dev = ro.device
    N = ro.shape[0]
    nbmin, nbmax = scene["plk_bmin"], scene["plk_bmax"]
    nhit, nmiss = scene["plk_hit"].long(), scene["plk_miss"].long()
    sstart, scount = scene["plk_slot_start"], scene["plk_count"]
    consts, s2p = scene["plk_consts"], scene["plk_slot2prim"]
    lod = bool(scene.get("has_voxel_lod"))
    n_slots = s2p.shape[0]
    nb = int(scene["plk_window"]) - 1

    t_out = t0.clone()
    slot_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    lane = torch.nonzero(t0 > t_min).squeeze(1)
    o = ro[lane]
    d = rd[lane]
    inv = _plk_safe_inv(d)
    mw = torch.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                      o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                      o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]], dim=1)
    t = t0[lane]
    cur = torch.zeros_like(lane)
    slot = torch.full_like(lane, -1, dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    per_ray = _PerRay(N, lane, stats)
    while lane.numel():
        if stats:
            counts[0] += lane.numel()
            per_ray.lane[0] += 1
        ss = sstart[cur]
        if lod:
            t_enter, t_exit = _slab(nbmin[cur], nbmax[cur], o, inv)
            ahit = (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t)
            vid = _voxel_of_word(ss)
            vid = torch.where(vid >= 0, vid + n_slots, -1)
            if stats:
                counts[3] += (vid >= 0).sum()
            closer = _voxel_hit(vid, t_enter, t_exit, t, slot, t_min)
            t = torch.where(closer, t_enter, t)
            slot = torch.where(closer, vid, slot)
        else:
            ahit = _slab_hit(nbmin[cur], nbmax[cur], o, inv, t)
        at = torch.nonzero(ahit & (ss >= 0)).squeeze(1)
        if at.numel():
            c = scount[cur[at]]
            if stats:
                counts[1] += at.numel()
                counts[2] += c.sum()
                per_ray.lane[1][at] += 1
                per_ray.lane[2][at] += c
            best = _plk_leaves(consts, ss[at], c, d[at], mw[at], o[at], t_min, nb)
            bt = (best & ~nb).view(torch.float32)
            closer = bt < t[at]
            t[at] = torch.where(closer, bt, t[at])
            slot[at] = torch.where(closer, (best & nb) + ss[at], slot[at])
        cur = torch.where(ahit, nhit[cur], nmiss[cur])
        if any_hit:
            cur = torch.where(slot >= 0, -1, cur)
        done = cur < 0
        if bool(done.any()):
            fin = lane[done]
            t_out[fin] = t[done]
            slot_out[fin] = slot[done]
            keep = ~done
            per_ray.retire(fin, done, keep)
            lane, o, d, inv, mw = lane[keep], o[keep], d[keep], inv[keep], mw[keep]
            t, cur, slot = t[keep], cur[keep], slot[keep]
    prim = torch.where(slot_out >= 0, s2p[slot_out.clamp(0, n_slots - 1).long()], -1)
    if lod:
        prim = torch.where(slot_out >= n_slots, slot_out - n_slots, prim)
    out = {"t": t_out, "prim": prim}
    if stats:
        out["counts"] = per_ray.counts()
        n = counts.tolist()
        work = {"node_steps": n[0], "leaves": n[1], "slot_tests": n[2]}
        return out, ({**work, "voxel_tests": n[3]} if lod else work)
    return out


def pick_ordering(rd):
    """Each ray's link ordering o = 2*axis + neg: `_pick_ordering`'s rule
    (traverse_pallas.py:761-772) on the ray's own direction, the dominant
    |component| with ties to x, then y, and `>= 0` as positive, so -0.0
    travels toward +axis."""
    a = rd.abs()
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    ox = torch.where(rd[:, 0] >= 0, 0, 1)
    oy = torch.where(rd[:, 1] >= 0, 2, 3)
    oz = torch.where(rd[:, 2] >= 0, 4, 5)
    return torch.where((ax >= ay) & (ax >= az), ox, torch.where(ay >= az, oy, oz))


def _trl_leaves(recs, ss, cnt, o, d, t, t_min):
    """(t, prim) of lanes draining fat leaves (slots ss .. ss+cnt-1): the
    slots' Möller-Trumbore or sphere tests (traverse_pallas.py:1365-1410)
    taken in slot order with a strict `<` against t, so the least t wins
    and a tie goes to the smaller slot.  t [n] the lanes' best t, prim
    -1 where no slot beats it."""
    t_new = t.clone()
    prim = torch.full((ss.shape[0],), -1, dtype=torch.int32, device=ss.device)
    for a, n, lane_of, j, slot in _leaf_pairs(ss, cnt):
        r = recs[slot]
        ri = r.view(torch.int32)
        dd, oo = d[a:a + n][lane_of], o[a:a + n][lane_of]
        rdx, rdy, rdz = dd[:, 0], dd[:, 1], dd[:, 2]
        ox, oy, oz = oo[:, 0], oo[:, 1], oo[:, 2]
        tt, _, _, h_t = _moller_trumbore(
            rdx, rdy, rdz, ox, oy, oz, (r[:, 0], r[:, 1], r[:, 2]),
            (r[:, 3], r[:, 4], r[:, 5]), (r[:, 6], r[:, 7], r[:, 8]), t_min)
        ts, h_s = _sphere(rdx, rdy, rdz, ox, oy, oz, (r[:, 0], r[:, 1], r[:, 2]),
                          r[:, 3], t_min)
        is_tri = ri[:, 10] > 0
        tp = torch.where(is_tri, tt, ts)
        hp = torch.where(is_tri, h_t, h_s)
        tp = torch.where(hp, tp, float("inf"))
        best = torch.full((n,), float("inf"), dtype=torch.float32, device=ss.device)
        best.scatter_reduce_(0, lane_of, tp, "amin")
        first = torch.full((n,), MAX_WINDOW, dtype=torch.int64, device=ss.device)
        at_best = hp & (tp == best[lane_of])
        first.scatter_reduce_(0, lane_of[at_best], j[at_best], "amin")
        tl = t_new[a:a + n]
        closer = (first < MAX_WINDOW) & (best < tl)
        t_new[a:a + n] = torch.where(closer, best, tl)
        fs = (ss[a:a + n].long() + first.clamp(max=MAX_WINDOW - 1)).clamp(max=recs.shape[0] - 1)
        prim[a:a + n] = torch.where(closer, recs.view(torch.int32)[fs, 9], -1)
    return t_new, prim


def _traverse_trl_plain(scene, ro, rd, t0, any_hit, t_min, stats=False):
    """Plain version of K4 (ops/smt_cuda.py): each lane walks the cut
    tree of ops/trl_layout.py along the links of its own ordering
    (`pick_ordering`) with K4's safe inverse (traverse_pallas.py
    :1348-1351, the same as `_plk_safe_inv`).  Each step runs the
    reference kernel's order (:1450-1521): the box test against the
    current t; the drain of the fat leaf latched on the previous step
    (`_trl_leaves`); the latch of this node's leaf where the box is hit;
    the hit or miss link; and an any-hit lane stops once it has a prim.
    A lane ends when it has no node and no latched leaf.  Lanes with
    t0 <= t_min keep (t0, -1).  Returns {"t", "prim"}.

    In a voxel-LOD scene a voxel leaf of the baked cut tree (its slot
    start word VOXEL_WORD - id) records its entry t under `_voxel_hit`'s
    rule right after the box test, against the t and prim from before the
    drain, as the reference kernel's step does (:1489-1505); any-hit
    lanes that already have a prim test no voxel.

    With stats=True also returns {"node_steps", "leaves", "slot_tests"}
    (and "voxel_tests" with LOD) summed over the lanes: box tests, leaves
    drained, slot tests and voxel tests; and the hits carry "counts", the
    same three per lane."""
    dev = ro.device
    N = ro.shape[0]
    nodes, links, recs = scene["trl_nodes"], scene["trl_links"], scene["trl_recs"]
    nodes_i = nodes.view(torch.int32)
    links = links.long()
    lod = bool(scene.get("has_voxel_lod"))

    t_out = t0.clone()
    prim_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    lane = torch.nonzero(t0 > t_min).squeeze(1)
    o = ro[lane]
    d = rd[lane]
    inv = _plk_safe_inv(d)
    order2 = 2 * pick_ordering(d)
    t = t0[lane]
    cur = torch.zeros_like(lane)
    prim = torch.full_like(lane, -1, dtype=torch.int32)
    pstart = torch.full_like(lane, -1)
    pcount = torch.zeros_like(lane)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    per_ray = _PerRay(N, lane, stats)
    while lane.numel():
        active = cur >= 0
        curc = cur.clamp(min=0)
        if stats:
            counts[0] += active.sum()
            per_ray.lane[0] += active
        nd = nodes[curc]
        ndi = nodes_i[curc]
        if lod:
            t_enter, t_exit = _slab(nd[:, 0:3], nd[:, 3:6], o, inv)
            want = active & (prim < 0) if any_hit else active
            hitv = (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t) & want
            vid = torch.where(want, _voxel_of_word(ndi[:, 6]), -1)
            if stats:
                counts[3] += (vid >= 0).sum()
            closer = _voxel_hit(vid, t_enter, t_exit, t, prim, t_min)
            t = torch.where(closer, t_enter, t)
            prim = torch.where(closer, vid, prim)
        else:
            hitv = _slab_hit(nd[:, 0:3], nd[:, 3:6], o, inv, t) & active
            if any_hit:
                hitv &= prim < 0
        enter = hitv & (ndi[:, 6] >= 0)
        dr = torch.nonzero(pstart >= 0).squeeze(1)
        if dr.numel():
            if stats:
                counts[1] += dr.numel()
                counts[2] += pcount[dr].sum()
                per_ray.lane[1][dr] += 1
                per_ray.lane[2][dr] += pcount[dr].to(torch.int32)
            t_dr, p_dr = _trl_leaves(recs, pstart[dr], pcount[dr], o[dr], d[dr], t[dr], t_min)
            t[dr] = t_dr
            prim[dr] = torch.where(p_dr >= 0, p_dr, prim[dr])
        pstart = torch.where(enter, ndi[:, 6].long(), -1)
        pcount = torch.where(enter, ndi[:, 7].long(), 0)
        lk = links[curc, order2 + torch.where(hitv, 0, 1)]
        cur = torch.where(active, lk, cur)
        if any_hit:
            cur = torch.where(prim >= 0, -1, cur)
        done = (cur < 0) & (pstart < 0)
        if bool(done.any()):
            fin = lane[done]
            t_out[fin] = t[done]
            prim_out[fin] = prim[done]
            keep = ~done
            per_ray.retire(fin, done, keep)
            lane, o, d, inv, order2 = lane[keep], o[keep], d[keep], inv[keep], order2[keep]
            t, cur, prim = t[keep], cur[keep], prim[keep]
            pstart, pcount = pstart[keep], pcount[keep]
    out = {"t": t_out, "prim": prim_out}
    if stats:
        out["counts"] = per_ray.counts()
        n = counts.tolist()
        work = {"node_steps": n[0], "leaves": n[1], "slot_tests": n[2]}
        return out, ({**work, "voxel_tests": n[3]} if lod else work)
    return out


def recompute_uv(scene, ro, rd, prim):
    """Barycentrics of each ray's winning triangle, (0, 0) for spheres and
    misses: one Möller-Trumbore in the oracle's op order, the
    counterpart of the reference's `_recompute_uv`
    (traverse_pallas.py:1573-1610)."""
    T = scene["tri_v0"].shape[0]
    is_tri = (prim >= 0) & (prim < scene["num_tris"])
    tid = torch.clamp(prim, 0, T - 1).long()
    v0, e1, e2 = scene["tri_v0"][tid], scene["tri_e1"][tid], scene["tri_e2"][tid]
    _, u, v, _ = _moller_trumbore(
        rd[:, 0], rd[:, 1], rd[:, 2], ro[:, 0], ro[:, 1], ro[:, 2],
        (v0[:, 0], v0[:, 1], v0[:, 2]), (e1[:, 0], e1[:, 1], e1[:, 2]),
        (e2[:, 0], e2[:, 1], e2[:, 2]), 0.0)
    return torch.where(is_tri, u, 0.0), torch.where(is_tri, v, 0.0)


def _traverse_plk(scene, ro, rd, t0, any_hit, t_min, impl):
    """K3 (impl "plk": the kernel, or its plain version for CPU tensors)
    or its plain version (impl "plk_plain"), then the winner's u/v for
    closest-hit rays; any-hit rays get u = v = 0, as in the reference
    (traverse_pallas.py:2118-2121)."""
    if "plk_consts" not in scene:
        raise ValueError(f"impl={impl!r} needs a scene with the Plücker layout "
                         "(ops/plk_layout.py)")
    if impl == "plk_plain":
        h = _traverse_plk_plain(scene, ro, rd, t0, any_hit, t_min)
        t, prim = h["t"], h["prim"]
    else:
        from aten_tpu_torch.ops.plk_cuda import plk_traverse

        t, prim = plk_traverse(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min)
    if any_hit:
        u = v = torch.zeros_like(t)
    else:
        u, v = recompute_uv(scene, ro, rd, prim)
    return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0}


def _traverse_smt(scene, ro, rd, t0, any_hit, t_min, impl):
    """K4 (impl "smt": the kernel at CHAINS rays per lane, or its plain
    version for CPU tensors) or its plain version (impl "smt_plain"),
    then the winner's u/v for closest-hit rays; any-hit rays get
    u = v = 0, as in the reference (traverse_pallas.py:2150-2158)."""
    if "trl_nodes" not in scene:
        raise ValueError(f"impl={impl!r} needs a scene with the treelet layout "
                         "(ops/trl_layout.py): build it under ATEN_TPU_KERNEL=smt, or "
                         "attach it with scene.scene.with_trl_layout")
    if impl == "smt_plain":
        h = _traverse_trl_plain(scene, ro, rd, t0, any_hit, t_min)
        t, prim = h["t"], h["prim"]
    else:
        from aten_tpu_torch.ops.smt_cuda import smt_traverse

        t, prim = smt_traverse(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min,
                               chains=CHAINS)
    if any_hit:
        u = v = torch.zeros_like(t)
    else:
        u, v = recompute_uv(scene, ro, rd, prim)
    return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0}


IMPLS = ("auto", "dense", "plain", "cuda", "plk", "plk_plain", "smt", "smt_plain")


def traverse(scene, ro, rd, t_max=None, any_hit=False, t_min=1e-4, impl="auto"):
    """Closest (or any) hit for rays ro, rd [N, 3] (unit directions).

    Returns {t, prim, u, v, hit}, each [N]; prim is the global id
    (triangles first, then spheres), -1 on a miss, where t is t_max.
    Instanced scenes add `inst` (accel/tlas.py::traverse_two_level).

    impl: "auto" takes the dense test for scenes of at most
    DENSE_MAX_PRIMS prims without voxel LOD, the kernel the scene's build named under the
    kernel policy (static `traversal`: "plk" for K3, "smt" for K4), and
    otherwise the K1 kernel; a kernel runs its plain version for CPU
    tensors.  "dense", "plain" (the oracle walk, which with voxel LOD
    reads scene["lod_depth"]), "cuda" (K1), "plk"
    (K3), "plk_plain" (K3's plain version), "smt" (K4) and "smt_plain"
    (K4's plain version) force one; the last four need their layouts.
    Recorded as the "traverse" span.
    """
    with spans.span("traverse"):
        return _traverse(scene, ro, rd, t_max, any_hit, t_min, impl)


def _traverse(scene, ro, rd, t_max, any_hit, t_min, impl):
    if impl not in IMPLS:
        raise ValueError(f"unknown traversal impl {impl!r}")
    if "tl_bmin" in scene:
        from aten_tpu_torch.accel.tlas import traverse_two_level

        return traverse_two_level(scene, ro, rd, t_max=t_max, any_hit=any_hit,
                                  t_min=t_min, impl=impl)
    ro = ro.detach().contiguous()
    rd = rd.detach().contiguous()
    t0 = _t0_of(t_max, ro.shape[0], ro.device)
    num_prims = scene["num_tris"] + scene["num_spheres"]
    if scene.get("has_voxel_lod"):
        if impl == "dense":
            raise ValueError("the dense test has no voxel LOD; a voxel-LOD scene walks its tree")
    elif impl == "dense" or (impl == "auto" and num_prims <= DENSE_MAX_PRIMS):
        return _traverse_dense(scene, ro, rd, t0, t_min)
    if impl == "plain":
        return _traverse_plain(scene, ro, rd, t0, any_hit, t_min)
    if impl == "auto":
        impl = {"plk": "plk", "smt": "smt"}.get(scene.get("traversal"), "cuda")
    if impl in ("plk", "plk_plain"):
        return _traverse_plk(scene, ro, rd, t0, any_hit, t_min, impl)
    if impl in ("smt", "smt_plain"):
        return _traverse_smt(scene, ro, rd, t0, any_hit, t_min, impl)
    from aten_tpu_torch.ops.traverse_cuda import bvh_traverse

    t, prim, u, v = bvh_traverse(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min)
    return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0}


def traverse_sorted(scene, ro, rd, t_max=None, any_hit=False, t_min=1e-4,
                    impl="auto"):
    """`traverse`.  The reference sorts rays here only to tighten TPU tile
    votes (traverse.py:364-390); whether a sort pays on a GPU is still to
    be measured, so the port does not sort."""
    return traverse(scene, ro, rd, t_max=t_max, any_hit=any_hit,
                    t_min=t_min, impl=impl)


def occluded(scene, ro, rd, dist, eps=1e-3, impl="auto"):
    """Shadow-ray visibility: True where something blocks [eps, dist-eps].
    Lanes with dist <= eps never hit (pass dist = 0 for dead lanes)."""
    res = traverse_sorted(
        scene, ro, rd, t_max=dist - eps, any_hit=True, t_min=eps, impl=impl
    )
    return res["hit"] & (dist > eps)


def occlusion_alpha(scene, ro, rd, dist, eps=1e-3, max_hits=10, impl="auto"):
    """Shadow occlusion through alpha-translucent surfaces, in [0, 1] (0:
    fully visible): up to max_hits closest hits along [eps, dist - eps],
    each multiplying the transmittance by (1 - alpha), alpha the
    material's times the albedo map's alpha at the hit's uv
    (HitTestToTargetLight's bounded loop, pathtracing_impl.h:266-351;
    the reference's traverse.py:478-530).  A lane stops at a miss, once
    its transmittance is at most 1e-4, or when its segment is used up.
    The reference runs all max_hits walks over every lane; here a walk
    takes only the lanes still active and the loop ends when none is,
    which changes no lane's result."""
    from aten_tpu_torch.integrator.pathtracer import eval_hit
    from aten_tpu_torch.scene.materials import gather_material
    from aten_tpu_torch.scene.textures import sample_texture

    n = ro.shape[0]
    trans = torch.ones(n, dtype=torch.float32, device=ro.device)
    remaining = torch.broadcast_to(
        torch.as_tensor(dist, dtype=torch.float32, device=ro.device), (n,)) - eps
    lane = torch.nonzero(remaining > 0).squeeze(1)
    cur_ro = ro[lane]
    d = rd[lane]
    rem = remaining[lane]
    for _ in range(max_hits):
        if not lane.numel():
            break
        res = traverse_sorted(scene, cur_ro, d, t_max=rem, t_min=eps, impl=impl)
        h = eval_hit(scene, cur_ro, d, res)
        mat = gather_material(scene["materials"], h["mtl"])
        a = mat["alpha"]
        if "tex_stack" in scene:
            rgba = sample_texture(scene, mat["albedo_map"], h["uv"][..., 0],
                                  h["uv"][..., 1], default=1.0)
            a = a * rgba[..., 3]
        hit = res["hit"]
        tr = torch.where(hit, trans[lane] * (1.0 - a), trans[lane])
        trans[lane] = tr
        # advance past the hit; lanes blocked by opaque surfaces stop
        t_adv = torch.where(hit, res["t"] + eps, 0.0)
        cur_ro = cur_ro + t_adv[..., None] * d
        rem = rem - t_adv
        keep = hit & (tr > 1e-4) & (rem > 0)
        lane, cur_ro, d, rem = lane[keep], cur_ro[keep], d[keep], rem[keep]
    return 1.0 - trans
