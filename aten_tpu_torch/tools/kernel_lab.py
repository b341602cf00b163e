"""Microbenchmark (L1): what each part of a treelet walk costs, on the card.

    python -m aten_tpu_torch.tools.kernel_lab [variant]

Counterpart of the reference's tools/kernel_lab.py, whose five Pallas
kernels (`make_nodes_kernel` :36, `make_leafu_kernel` :96,
`make_wide_kernel` :343, `make_spec_kernel` :468, `make_plk_kernel`
:661) took its treelet walk apart on the TPU.  Each walks a tile of
`tile_rows` x 128 rays with ONE node cursor, moved by a vote of the
tile's rays, along the link set of ONE ordering, picked from the tile's
summed direction.  The CUDA kernels are kernels/kernel_lab.cu: one block
per tile, of 1024 threads holding tile_rows / 8 rays each (plk: 512
threads holding four).

Variants (the reference's names, parsed as its `main` parses them):
  v3        the port's production kernel for the scene, K1
            (ops/traverse_cuda.py), closest-hit: the yardstick
  nodes     node walk only: where a fat leaf's box is hit, its entry
            distance becomes t and its row start (first slot / 8) "prim"
  nodir     the same along ordering 0's (hit, miss) links: what the
            reference stores in node lanes 6/7 (`build_treelet_layout`
            :663-665), which its docstring calls "fixed preorder links"
  leafu     full closest-hit walk that drains one row of 8 slots per
            iteration with the cursor frozen, no branch around the drain
  wide<R>[_nc][_t<N>]
            the production walk with tiles of R x 128 rays: the leaf
            latched on one step is drained on the next, behind a branch,
            or with _nc every step, masked; it drains the layout's
            window of slots, or with _t<N> N slots (N >= the window)
  spec<R>   wide<R>, with both successor nodes loaded before the slab
            math (R defaults to 8)
  plk       Plücker drain, 16-row tiles: on entering a leaf its 8 KB
            block E [8, 4P] is copied into shared memory (cp.async) and
            waited on the next step; each thread forms its rays' columns
            of S = E^T R6 and NUM = E[:, 3P:]^T R4 as fixed-order fp32
            sums (no tensor cores, no torch.matmul), then the slot tests

R is 8 or 16.  `noext` (named in the reference's docstring, but its
`run` has no branch for it and silently runs `leafu`) is refused, as is
a drain of N slots under the layout's own window (`trl_window`), which
would skip slots of its leaves: the reference's `_t32` runs on a
layout cut at a window of 32 (ATEN_TRL_WINDOW=32, or
scene.scene.with_trl_layout(window=32)).

The layout is the port's K4 layout (ops/trl_layout.py) at any window:
node records [Kt, 8], links [Kt, 12], slot records [slots, 12].  `plk`
adds the lab's own Plücker tables (`build_plucker_leaves`), blocks of
PLK_SLOTS = 64 slots as the reference builds them, so it runs on
layouts of a window up to 64; their den carries the lab's -n.v0 * m_x
term (ROADMAP.md queue 3): it computes what the lab computes and is
held against the lab, not against the oracle.

`run_plain` computes every variant in torch, all live tiles a step at
a time, in the kernels' operation order: the lab's safe inverse
(1/d, or 1e12 for |d| <= 1e-12), Moller-Trumbore as
accel/traverse.py::_moller_trumbore, T_MIN = 1e-4, and the tile's
direction summed as a pairwise tree (element i with i + h, h halving),
which the kernels repeat, so the two agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from aten_tpu_torch.ops.plk_layout import PACK
from aten_tpu_torch.utils import spans

LANES = 128
T_MIN = 1e-4
PLK_SLOTS = 64  # slots of a Plücker block (kernels/kernel_lab.cu: kWindow)
TILE_ROWS = (8, 16)
VARIANTS = ("v3", "nodes", "nodir", "leafu", "wide<R>[_nc][_t<N>]", "spec<R>", "plk")
KINDS = ("nodes", "nodir", "leafu", "wide", "spec", "plk")  # the kernels' order
# A launch adds 1 to the counter "launch.<name>" (utils/spans.py) on the
# line after it succeeds in `run`.
KERNELS = ("kernel_lab_nodes", "kernel_lab_nodir", "kernel_lab_leafu",
           "kernel_lab_wide8", "kernel_lab_wide16", "kernel_lab_wide8_nc",
           "kernel_lab_wide16_nc", "kernel_lab_spec8", "kernel_lab_spec16", "kernel_lab_plk")
# (lane, slot) pairs or (lane, column) products the plain drains hold at once
_PAIRS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Variant:
    kind: str            # "v3" or one of KINDS
    tile_rows: int = 8
    leaf_cond: bool = True
    drain_slots: int | None = None  # None: the layout's window

    @property
    def tile(self):
        return self.tile_rows * LANES

    @property
    def kernel(self):
        if self.kind in ("wide", "spec"):
            return f"kernel_lab_{self.kind}{self.tile_rows}{'' if self.leaf_cond else '_nc'}"
        return f"kernel_lab_{self.kind}"


def parse(variant):
    """The Variant named `variant`, as the reference's `main` reads it
    (:241-321); raises ValueError for a name it does not know."""
    bad = ValueError(f"unknown kernel_lab variant {variant!r}; one of {VARIANTS}, "
                     f"R in {TILE_ROWS}")
    if variant in ("v3", "nodes", "nodir", "leafu"):
        return Variant(variant)
    if variant == "plk":
        return Variant("plk", 16)
    try:
        if variant.startswith("spec"):
            v = Variant("spec", int(variant[4:]) if len(variant) > 4 else 8)
        elif variant.startswith("wide"):
            parts = variant[4:].split("_")
            v = Variant("wide", int(parts[0]), "nc" not in parts)
            for p in parts[1:]:
                if p.startswith("t"):
                    v = dataclasses.replace(v, drain_slots=int(p[1:]) // PACK * PACK)
                elif p != "nc":
                    raise bad
        else:
            raise bad
    except ValueError as e:
        raise bad from e
    if v.tile_rows not in TILE_ROWS or v.drain_slots == 0:
        raise bad
    return v


def drain_of(tab, v):
    """The slots `v` drains a leaf of the layout in `tab`: its own
    `_t<N>`, or the layout's window.  Raises ValueError for a drain under
    the layout's window, which would skip slots of its leaves."""
    window = tab["window"]
    if v.drain_slots is None:
        return window
    if v.drain_slots < window:
        raise ValueError(
            f"{v.kernel}: a drain of {v.drain_slots} slots skips slots of the layout's "
            f"{window}-slot leaves; cut the layout at a window of at most {v.drain_slots} "
            "(ATEN_TRL_WINDOW, or scene.scene.with_trl_layout(window=))")
    return v.drain_slots


# -- tables and rays ------------------------------------------------------------

def build_plucker_leaves(layout):
    """The lab's Plücker tables (tools/kernel_lab.py:605-658) from the
    K4 layout {"trl_nodes", "trl_recs"} (numpy) of a window up to
    PLK_SLOTS: E [NT*8, 4*PLK_SLOTS] f32 (built in float64, stored as
    float32), pids [NT, PLK_SLOTS] i32 (-1 past
    a leaf's count) and the per-node treelet id [Kt] i32 (-1 off fat
    leaves), the fat leaves numbered in node order.  Per treelet and slot
    j, E's column groups hold the edge lines of v0->v1, v1->v2, v2->v0
    (rows 0-2 a x b, rows 3-5 b - a) and the plane: rows 0-2 n = e1 x e2,
    row 3 -n.v0, which the lab's drain also multiplies into den."""
    nodes = np.asarray(layout["trl_nodes"])
    recs = np.asarray(layout["trl_recs"])
    ints = nodes[:, 6:8].view(np.int32)
    first, count = ints[:, 0].astype(np.int64), ints[:, 1].astype(np.int64)
    tre_ids = np.nonzero((first >= 0) & (count > 0))[0]
    nt = tre_ids.shape[0]
    c = count[tre_ids]
    k = np.repeat(np.arange(nt), c)
    j = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
    if c.size and int(c.max()) > PLK_SLOTS:
        raise ValueError(f"a leaf of {int(c.max())} slots does not fit a {PLK_SLOTS}-slot "
                         "Plücker block")
    r = recs[first[tre_ids][k] + j]
    v0, e1, e2 = (r[:, a:a + 3].astype(np.float64) for a in (0, 3, 6))
    P = PLK_SLOTS
    E = np.zeros((nt, 8, 4 * P), np.float32)
    A, B, C = v0, v0 + e1, v0 + e2
    for g, (a, b) in enumerate(((A, B), (B, C), (C, A))):
        m, d = np.cross(a, b), b - a
        for ax in range(3):
            E[k, ax, g * P + j] = m[:, ax]
            E[k, 3 + ax, g * P + j] = d[:, ax]
    n = np.cross(e1, e2)
    for ax in range(3):
        E[k, ax, 3 * P + j] = n[:, ax]
    E[k, 3, 3 * P + j] = -np.einsum("ij,ij->i", n, v0)
    pids = np.full((nt, P), -1, np.int32)
    pids[k, j] = r[:, 9].view(np.int32)
    tre = np.full(nodes.shape[0], -1, np.int32)
    tre[tre_ids] = np.arange(nt, dtype=np.int32)
    return E.reshape(nt * 8, 4 * P), pids, tre


def tables(scene):
    """The lab's tables on the scene's device: the K4 layout (`nodes`,
    `links`, `recs`; the scene must carry it, see
    scene.scene.with_trl_layout) and its `window`, the Plücker tables
    (`emat`, `pids`, `tre`; with no treelet on a layout of a window
    above PLK_SLOTS) and the scene itself, which `v3` walks with K1 (its
    records attached here where the scene's build chose another
    kernel)."""
    from aten_tpu_torch.scene.scene import with_bvh_layout

    if "trl_nodes" not in scene:
        raise ValueError("kernel_lab needs a scene with the K4 layout "
                         "(scene.scene.with_trl_layout)")
    if "bvh_nodes" not in scene:
        scene = with_bvh_layout(scene)
    window = int(scene["trl_window"])
    host = {k: scene[k].cpu().numpy() for k in ("trl_nodes", "trl_recs")}
    if window <= PLK_SLOTS:
        E, pids, tre = build_plucker_leaves(host)
    else:
        E = np.zeros((0, 4 * PLK_SLOTS), np.float32)
        pids = np.zeros((0, PLK_SLOTS), np.int32)
        tre = np.full(host["trl_nodes"].shape[0], -1, np.int32)
    dev = scene["trl_nodes"].device
    return {"nodes": scene["trl_nodes"], "links": scene["trl_links"],
            "recs": scene["trl_recs"], "emat": torch.from_numpy(E).to(dev),
            "pids": torch.from_numpy(pids).to(dev), "tre": torch.from_numpy(tre).to(dev),
            "window": window, "scene": scene}


def lab_order(res):
    """Pixel index (row-major, row 0 at the top) of each lab ray: 32 x 32
    pixel tiles, row by row, each tile row-major (tools/kernel_lab.py
    :227-233)."""
    ids = []
    for y0 in range(0, res, 32):
        for x0 in range(0, res, 32):
            yy, xx = np.mgrid[y0:y0 + 32, x0:x0 + 32]
            ids.append((yy * res + xx).ravel())
    return np.concatenate(ids)


def lab_rays(cam, res, device):
    """(ro, rd, t0): primary rays through the pixel centres of a res x res
    image (res a multiple of 32) in `lab_order`, t0 = 3.4e38, as the
    reference's `main` makes them (:219-236)."""
    from aten_tpu_torch.core.camera import generate_ray

    if res % 32:
        raise ValueError(f"res={res} is not a multiple of 32")
    x = (np.arange(res) + 0.5) / res
    y = (res - 1 - np.arange(res) + 0.5) / res
    s, t = np.meshgrid(x, y)
    ro, rd = generate_ray(cam.arrays(device),
                          torch.tensor(s.ravel(), dtype=torch.float32, device=device),
                          torch.tensor(t.ravel(), dtype=torch.float32, device=device))
    perm = torch.from_numpy(lab_order(res)).to(device)
    t0 = torch.full((res * res,), 3.4e38, dtype=torch.float32, device=device)
    return ro[perm].contiguous(), rd[perm].contiguous(), t0


# -- the plain versions -----------------------------------------------------------

def _check(tab, ro, rd, t0, v):
    dev = ro.device
    n = ro.shape[0]
    for name, x, dt, shape in (("ro", ro, torch.float32, (n, 3)), ("rd", rd, torch.float32, (n, 3)),
                               ("t0", t0, torch.float32, (n,))):
        if x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {list(shape)}, "
                             f"got {x.dtype} {list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, ro on {dev}")
    for k in ("nodes", "links", "recs", "emat", "pids", "tre"):
        if tab[k].device != dev:
            raise ValueError(f"table {k} is on {tab[k].device}, the rays on {dev}")
    if v.kind != "v3" and n % v.tile:
        raise ValueError(f"{n} rays are not whole tiles of {v.tile}")
    if v.kind == "plk" and tab["window"] > PLK_SLOTS:
        raise ValueError(f"plk: the layout's window {tab['window']} does not fit its "
                         f"{PLK_SLOTS}-slot blocks")
    return drain_of(tab, v)


def tile_ordering(rd):
    """Each tile's link ordering from rd [G, T, 3]: `_pick_ordering`'s
    rule (traverse_pallas.py:761-772) on the tile's summed direction,
    summed as a pairwise tree (element i plus element i + h, h = T/2,
    T/4, .., 1) as the kernels sum it.  [G] int64."""
    from aten_tpu_torch.accel.traverse import pick_ordering

    s = rd
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    return pick_ordering(s[:, 0])


def _slab(nd, o, inv, t):
    """(t_enter, hit) of each tile's node record nd [g, 8] against its
    rays o, inv [g, T, 3] with best t [g, T], in the lab's op order."""
    tlo = (nd[:, None, 0:3] - o) * inv
    thi = (nd[:, None, 3:6] - o) * inv
    ts = torch.minimum(tlo, thi)
    tb = torch.maximum(tlo, thi)
    tenter = torch.maximum(torch.maximum(ts[..., 0], ts[..., 1]), ts[..., 2])
    texit = torch.minimum(torch.minimum(tb[..., 0], tb[..., 1]), tb[..., 2])
    return tenter, (tenter <= texit) & (texit > 0.0) & (tenter < t)


def _merge(tp, hp, pid, t, prim):
    """Sequential strict-`<` updates of (t, prim) [n, T] by slot tests
    tp, hp [n, S, T] with ids pid [n, S], in slot order: the least hit t
    wins, a tie goes to the smaller slot, and only below t."""
    tp = torch.where(hp, tp, float("inf"))
    best = tp.amin(1)
    first = (hp & (tp == best[:, None])).to(torch.uint8).argmax(1)
    closer = best < t
    return torch.where(closer, best, t), torch.where(closer, torch.gather(pid, 1, first), prim)


def _chunks(n, per_item):
    step = max(1, _PAIRS // max(per_item, 1))
    for a in range(0, n, step):
        yield slice(a, min(a + step, n))


def _drain_mt(recs, slots, ok, o, d, t, prim):
    """Moller-Trumbore tests of slots [n, S] (masked by ok [n, S]) for
    each tile's rays o, d [n, T, 3]; returns the updated (t, prim)."""
    from aten_tpu_torch.accel.traverse import _moller_trumbore

    recs_i = recs.view(torch.int32)
    slots = slots.clamp(0, recs.shape[0] - 1)
    t, prim = t.clone(), prim.clone()
    for c in _chunks(slots.shape[0], slots.shape[1] * t.shape[1]):
        e = recs[slots[c]][:, :, None, :]
        dd, oo = d[c][:, None], o[c][:, None]
        tt, _, _, hit = _moller_trumbore(
            dd[..., 0], dd[..., 1], dd[..., 2], oo[..., 0], oo[..., 1], oo[..., 2],
            (e[..., 0], e[..., 1], e[..., 2]), (e[..., 3], e[..., 4], e[..., 5]),
            (e[..., 6], e[..., 7], e[..., 8]), T_MIN)
        t[c], prim[c] = _merge(tt, hit & ok[c][:, :, None], recs_i[slots[c], 9], t[c], prim[c])
    return t, prim


def plk_products(eb, o, d):
    """S = E^T R6 [n, 4P, T] and NUM = E[:, 3P:]^T R4 [n, P, T] of blocks
    eb [n, 8, 4P] and rays o, d [n, T, 3], each entry a sequential fp32
    sum over the block's rows in row order, as the kernel takes it.  R6
    rows are rd, ro x rd, 0, 0 and R4 rows ro, 1, 0, 0, 0, 0: the rows
    whose ray factor is zero are left out (they add +-0)."""
    P = PLK_SLOTS
    ox, oy, oz = (o[:, None, :, a] for a in range(3))
    dx, dy, dz = (d[:, None, :, a] for a in range(3))
    mx, my, mz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx
    e = eb[..., None]
    S = (((((e[:, 0] * dx + e[:, 1] * dy) + e[:, 2] * dz) + e[:, 3] * mx)
          + e[:, 4] * my) + e[:, 5] * mz)
    q = e[:, :, 3 * P:]
    NUM = ((q[:, 0] * ox + q[:, 1] * oy) + q[:, 2] * oz) + q[:, 3]
    return S, NUM


def _drain_plk(e3, pids, pend, o, d, t, prim):
    """The lab's Plücker drain (tools/kernel_lab.py:696-725) of treelets
    pend [n] for each tile's rays; returns the updated (t, prim)."""
    P = PLK_SLOTS
    t, prim = t.clone(), prim.clone()
    for c in _chunks(pend.shape[0], 4 * P * t.shape[1]):
        S, NUM = plk_products(e3[pend[c]], o[c], d[c])
        s0, s1, s2, den = S[:, 0:P], S[:, P:2 * P], S[:, 2 * P:3 * P], S[:, 3 * P:]
        inside = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
                  | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
        dok = den.abs() > 1e-12
        tt = -NUM / torch.where(dok, den, 1e12)
        pid = pids[pend[c]]
        ok = inside & dok & (tt > T_MIN) & (pid >= 0)[:, :, None]
        t[c], prim[c] = _merge(tt, ok, pid, t[c], prim[c])
    return t, prim


def run_plain(tab, ro, rd, t0, variant, tiles=None, stats=False):
    """(t, prim) of `variant` on rays ro, rd [N, 3] with t_max t0 [N], in
    torch: each tile walks its cursor a step at a time, all live tiles
    at once, in the kernel's order.  `tiles` (indices into the N / tile
    tiles) restricts the walk to those tiles, whose rays it returns in
    that order.  With stats=True also returns the tile walks' work:
    {"tile_steps" (node steps of tiles), "ray_steps" (the same times the
    tile's rays), "leaves" (drains), "slot_tests" (occupied slots drained,
    times the tile's rays)}."""
    from aten_tpu_torch.accel.traverse import _plk_safe_inv, _traverse_plain

    v = variant if isinstance(variant, Variant) else parse(variant)
    drain = _check(tab, ro, rd, t0, v)
    if v.kind == "v3":
        h = _traverse_plain(tab["scene"], ro, rd, t0, False, T_MIN)
        return (h["t"], h["prim"]) + (({},) if stats else ())
    dev = ro.device
    T = v.tile
    sel = torch.arange(ro.shape[0] // T, device=dev) if tiles is None else tiles.to(dev)
    o = ro.view(-1, T, 3)[sel]
    d = rd.view(-1, T, 3)[sel]
    t = t0.view(-1, T)[sel].clone()
    g = sel.shape[0]
    t_out, prim_out = t.clone(), torch.full((g, T), -1, dtype=torch.int32, device=dev)
    prim = prim_out.clone()
    inv = _plk_safe_inv(d)
    lo = torch.zeros(g, dtype=torch.long, device=dev) if v.kind == "nodir" else 2 * tile_ordering(d)
    nodes, nodes_i = tab["nodes"], tab["nodes"].view(torch.int32)
    links = tab["links"].long()
    e3 = tab["emat"].view(-1, 8, 4 * PLK_SLOTS)
    idx = torch.arange(g, device=dev)
    cur = torch.zeros(g, dtype=torch.long, device=dev)
    pa = torch.full((g,), -1, dtype=torch.long, device=dev)  # leaf: first slot / treelet
    pb = torch.zeros(g, dtype=torch.long, device=dev)        # leaf: slots (left)
    work = torch.zeros(3, dtype=torch.int64, device=dev)
    ar = torch.arange(max(drain, PACK), device=dev)
    while idx.numel():
        cc = cur.clamp(min=0)
        nd, ndi = nodes[cc], nodes_i[cc]
        first, count = ndi[:, 6].long(), ndi[:, 7].long()
        hitl, missl = links[cc, lo], links[cc, lo + 1]
        tenter, hitv = _slab(nd, o, inv, t)
        if v.kind in ("nodes", "nodir"):
            work[0] += idx.numel()
            start = torch.where(first >= 0, first // PACK, -1)
            closer = hitv & (start >= 0)[:, None] & (tenter > T_MIN) & (tenter < t)
            t = torch.where(closer, tenter, t)
            prim = torch.where(closer, start[:, None].to(torch.int32), prim)
            cur = torch.where(hitv.any(1), hitl, missl)
            done = cur < 0
        elif v.kind == "leafu":
            busy = pb > 0
            free = (cur >= 0) & ~busy
            work[0] += free.sum()
            anyhit = hitv.any(1) & free
            enter = anyhit & (first >= 0) & (count > 0)
            nxt = torch.where(busy | (cur < 0), cur, torch.where(anyhit, hitl, missl))
            pa = torch.where(enter, first, pa)
            pb = torch.where(enter, count, pb)
            work[1] += enter.sum()
            b = torch.nonzero(busy).squeeze(1)
            if b.numel():
                ok = ar[None, :PACK] < pb[b, None]
                work[2] += ok.sum()
                t[b], prim[b] = _drain_mt(tab["recs"], pa[b, None] + ar[None, :PACK], ok,
                                          o[b], d[b], t[b], prim[b])
            pa = torch.where(busy, pa + PACK, pa)
            pb = torch.where(busy, (pb - PACK).clamp(min=0), pb)
            cur = nxt
            done = (cur < 0) & (pb <= 0)
        else:  # wide, spec, plk: drain the leaf latched on the previous step
            active = cur >= 0
            work[0] += active.sum()
            anyhit = hitv.any(1) & active
            enter = (first >= 0) & anyhit
            if v.kind == "plk":
                tre = tab["tre"][cc].long()
                enter &= tre >= 0
            b = torch.nonzero(pa >= 0).squeeze(1)
            if b.numel():
                work[1] += b.numel()
                if v.kind == "plk":
                    work[2] += (tab["pids"][pa[b]] >= 0).sum()
                    t[b], prim[b] = _drain_plk(e3, tab["pids"], pa[b], o[b], d[b], t[b], prim[b])
                else:
                    s = int(pb[b].max())
                    ok = ar[None, :s] < pb[b, None]
                    work[2] += ok.sum()
                    t[b], prim[b] = _drain_mt(tab["recs"], pa[b, None] + ar[None, :s], ok,
                                              o[b], d[b], t[b], prim[b])
            if v.kind == "plk":
                pa = torch.where(enter, tre, -1)
            else:
                pa = torch.where(enter, first, -1)
                pb = torch.where(enter, count, 0)
            cur = torch.where(active, torch.where(anyhit, hitl, missl), cur)
            done = (cur < 0) & (pa < 0)
        if bool(done.any()):
            fin = idx[done]
            t_out[fin], prim_out[fin] = t[done], prim[done]
            keep = ~done
            idx, o, d, inv, lo = idx[keep], o[keep], d[keep], inv[keep], lo[keep]
            t, prim, cur, pa, pb = t[keep], prim[keep], cur[keep], pa[keep], pb[keep]
    out = (t_out.reshape(-1), prim_out.reshape(-1))
    if stats:
        n = work.tolist()
        return out + ({"tile_steps": n[0], "ray_steps": n[0] * T, "leaves": n[1],
                       "slot_tests": n[2] * T},)
    return out


def ray_walk_steps(tab, ro, rd, t0, directional=True):
    """Node steps of the per-ray walk of the cut tree that `nodes`
    (`directional`, each ray along its own ordering) or `nodir` (ordering
    0) computes: the least work of that query on these rays."""
    from aten_tpu_torch.accel.traverse import _plk_safe_inv, pick_ordering

    nodes, nodes_i = tab["nodes"], tab["nodes"].view(torch.int32)
    links = tab["links"].long()
    o, d, t = ro, rd, t0.clone()
    inv = _plk_safe_inv(d)
    lo = 2 * pick_ordering(d) if directional else torch.zeros_like(t, dtype=torch.long)
    cur = torch.zeros(ro.shape[0], dtype=torch.long, device=ro.device)
    steps = torch.zeros((), dtype=torch.int64, device=ro.device)
    while cur.numel():
        steps += cur.numel()
        nd = nodes[cur]
        tenter, hitv = _slab(nd, o[:, None], inv[:, None], t[:, None])
        tenter, hitv = tenter[:, 0], hitv[:, 0]
        first = nodes_i[cur, 6]
        t = torch.where(hitv & (first >= 0) & (tenter > T_MIN), tenter, t)
        cur = torch.where(hitv, links[cur, lo], links[cur, lo + 1])
        keep = cur >= 0
        cur, o, d, inv, lo, t = cur[keep], o[keep], d[keep], inv[keep], lo[keep], t[keep]
    return int(steps)


# -- the kernels ------------------------------------------------------------------

# (table, dtype, trailing shape) of what the kernels read
_TABLES = (("nodes", torch.float32, (8,)), ("links", torch.int32, (12,)),
           ("recs", torch.float32, (12,)), ("emat", torch.float32, (4 * PLK_SLOTS,)),
           ("pids", torch.int32, (PLK_SLOTS,)), ("tre", torch.int32, ()))


def run(tab, ro, rd, t0, variant):
    """(t, prim) [N] of `variant` (a name or a Variant) on rays ro, rd
    [N, 3] with t_max t0 [N] over the tables of `tables`.  For CPU
    tensors it runs `run_plain`; on a CUDA tensor it launches the kernel
    (`v3`: K1, ops/traverse_cuda.py) or raises."""
    v = variant if isinstance(variant, Variant) else parse(variant)
    drain = _check(tab, ro, rd, t0, v)
    if ro.device.type == "cpu":
        return run_plain(tab, ro, rd, t0, v)
    if ro.device.type != "cuda":
        raise ValueError(f"kernel_lab: unsupported device {ro.device}")
    if v.kind == "v3":
        from aten_tpu_torch.ops.traverse_cuda import bvh_traverse

        t, prim, _, _ = bvh_traverse(tab["scene"], ro, rd, t0, t_min=T_MIN)
        return t, prim
    from aten_tpu_torch.tools.lab_library import check, load_library

    for k, dt, tail in _TABLES:
        x = tab[k]
        if x.dtype != dt or tuple(x.shape[1:]) != tail or not x.is_contiguous():
            raise ValueError(f"table {k}: expected contiguous {dt} [n, {tail}], "
                             f"got {x.dtype} {list(x.shape)}")
    n = ro.shape[0]
    t = torch.empty_like(t0)
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    lib = load_library()
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        rc = lib.aten_kernel_lab(
            KINDS.index(v.kind), v.tile_rows, int(v.leaf_cond), drain,
            *(tab[k].data_ptr() for k, _, _ in _TABLES), tab["recs"].shape[0],
            ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t.data_ptr(), prim.data_ptr(), n, stream)
    check(lib, rc, f"kernel_lab {v.kernel}")
    spans.count("launch." + v.kernel)
    return t, prim


def measure(tab, ro, rd, t0, variant, reps=3):
    """The reference's timing (:246-264, :278-332): six chained runs,
    each on ro + 0 * acc of the previous ones, timed with CUDA events;
    the best of `reps`, in ms per run.  acc sums each run's first prim,
    not its first t as the reference does: two misses at t = 3.4e38 sum
    to inf, and 0 * inf would turn the next run's origins into NaN."""
    def chained():
        acc = torch.zeros((), dtype=torch.float32, device=ro.device)
        for _ in range(6):
            _, prim = run(tab, ro + 0 * acc, rd, t0, variant)
            acc = acc + prim[0].float()
        return acc

    chained()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        chained()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best / 6


def agreement(t, prim, t_ref, prim_ref):
    """(prim agreement, max |dt| where both hit) of one run against
    another, as the reference prints them."""
    same = float((prim == prim_ref).float().mean())
    both = (prim >= 0) & (prim_ref >= 0)
    dt = float((t[both] - t_ref[both]).abs().max()) if bool(both.any()) else 0.0
    return same, dt


def main(argv):
    variant = argv[1] if len(argv) > 1 else "nodes"
    v = parse(variant)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_lab: no CUDA card is available")
    from aten_tpu_torch.scene.scene import with_trl_layout
    from aten_tpu_torch.scene.scenedefs import procedural_mesh_scene

    res = 1024
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    scene, cam = procedural_mesh_scene(res, res, device=dev)
    tab = tables(with_trl_layout(scene))
    ro, rd, t0 = lab_rays(cam, res, dev)
    t, prim = run(tab, ro, rd, t0, v)
    torch.cuda.synchronize()
    print(f"build and first run: {time.perf_counter() - t_start:.1f}s "
          f"[{torch.cuda.get_device_name(0)}]")
    ms = measure(tab, ro, rd, t0, v)
    print(f"{variant}: {ro.shape[0] / ms / 1e3:.1f} Mrays/s ({ms:.2f} ms)")
    if v.kind not in ("v3", "nodes", "nodir"):
        same, dt = agreement(t, prim, *run(tab, ro, rd, t0, "v3"))
        print(f"prim agreement vs v3: {same:.6f}  max|dt| on hits: {dt:.2e}")


if __name__ == "__main__":
    main(sys.argv)
