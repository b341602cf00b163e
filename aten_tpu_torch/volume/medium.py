"""Participating media: the HG phase, homogeneous and heterogeneous
sampling.

Counterpart of aten_tpu/volume/medium.py (the reference's
phase_function.h:12-66, medium.h:25-118 and medium.cpp:10-150): the
Henyey-Greenstein phase function, analytic distance sampling in a
homogeneous medium on a hero channel, and delta and ratio tracking
through a dense [D, H, W] density grid against its majorant, with
brick-level majorants that cross an empty brick in one step.

`MediumTable` is host numpy and makes the reference's rows, padded
density stack and brick majorants bit for bit.  The reference also
stages a 2x2x2 corner row per voxel (`grid_corners`, one 8-wide TPU
gather in place of eight); the port does not: `sample_grid_density`
takes the eight clipped gathers of the reference's plain branch, which
fetch the same values.

The tracking keys are the reference's uint32 LCGs, held here as int64
tensors of uint32 values (core/sampler.py's convention), so every
key and every uniform drawn from it is the reference's bit for bit.
The reference's tracking loops are `lax.while_loop`s over masked lanes
that stop when no lane is live or after MAX_TRACKING_STEPS; here each
iteration takes only the live lanes (`torch.nonzero` once, then the
lanes that did not finish).  A lane's key advances once per iteration
while it is live, as in the masked loop, so each lane's result is the
masked loop's.  Each iteration costs one host sync (the live count),
counted in "host_sync.tracking" (utils/spans.py).

Media attach to materials (the material's `medium` id): crossing a
transmissive surface whose material carries a medium switches the
path's current medium (integrator/volpt.py).  A REFRACTION material
with ior 1 is the conventional null boundary.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.core.sampler import _M32, _mul32
from aten_tpu_torch.utils import spans

PI = float(np.float32(np.pi))
MAX_TRACKING_STEPS = 64
BRICK = 4  # voxels per brick edge (brick-majorant empty-space skipping)
_LCG_MUL, _LCG_ADD = 747796405, 2891336453
_DELTA_SEED_MUL, _RATIO_SEED_MUL = 0x9E3779B9, 0x85157AF5

ARRAY_KEYS = ("med_sigma_a", "med_sigma_s", "med_g", "med_le", "med_grid")
GRID_KEYS = ("grid_density", "grid_bmin", "grid_bmax", "grid_dim", "grid_majorant",
             "grid_brickmax")


class MediumTable:
    def __init__(self):
        self.rows = []
        self.grids = []

    def add(self, sigma_a=(0.1, 0.1, 0.1), sigma_s=(0.5, 0.5, 0.5), g=0.0,
            le=(0.0, 0.0, 0.0), grid=None, grid_bmin=None, grid_bmax=None) -> int:
        """grid: an optional [D, H, W] density array (heterogeneous), whose
        world box is [grid_bmin, grid_bmax]."""
        gid = -1
        if grid is not None:
            gid = len(self.grids)
            self.grids.append((np.asarray(grid, np.float32), np.asarray(grid_bmin, np.float32),
                               np.asarray(grid_bmax, np.float32)))
        self.rows.append(dict(sigma_a=tuple(map(float, sigma_a)),
                              sigma_s=tuple(map(float, sigma_s)),
                              g=float(g), le=tuple(map(float, le)), grid=gid))
        return len(self.rows) - 1

    def numpy_arrays(self):
        """The medium rows (`med_*`) and, with a grid, the padded density
        stack, boxes, sizes, majorants and brick majorants (`grid_*`)."""
        rows = self.rows or [dict(sigma_a=(0, 0, 0), sigma_s=(0, 0, 0), g=0.0,
                                  le=(0, 0, 0), grid=-1)]
        out = {
            "med_sigma_a": np.asarray([r["sigma_a"] for r in rows], np.float32),
            "med_sigma_s": np.asarray([r["sigma_s"] for r in rows], np.float32),
            "med_g": np.asarray([r["g"] for r in rows], np.float32),
            "med_le": np.asarray([r["le"] for r in rows], np.float32),
            "med_grid": np.asarray([r["grid"] for r in rows], np.int32),
        }
        if not self.grids:
            return out
        n = len(self.grids)
        d = max(g[0].shape[0] for g in self.grids)
        h = max(g[0].shape[1] for g in self.grids)
        w = max(g[0].shape[2] for g in self.grids)
        stack = np.zeros((n, d, h, w), np.float32)
        bmin = np.zeros((n, 3), np.float32)
        bmax = np.ones((n, 3), np.float32)
        dim = np.zeros((n, 3), np.int32)
        for i, (g, lo, hi) in enumerate(self.grids):
            stack[i, : g.shape[0], : g.shape[1], : g.shape[2]] = g
            bmin[i], bmax[i] = lo, hi
            dim[i] = g.shape
        out["grid_density"] = stack
        out["grid_bmin"] = bmin
        out["grid_bmax"] = bmax
        out["grid_dim"] = dim
        out["grid_majorant"] = np.asarray([g[0].max() for g in self.grids], np.float32)
        # brick majorants: the max over BRICK^3 voxels of the grid dilated
        # by one voxel, so a zero brick holds no non-zero trilinear tap
        nb = -(-np.asarray([d, h, w]) // BRICK)
        bricks = np.zeros((n, nb[0], nb[1], nb[2]), np.float32)
        for i in range(n):
            gd = stack[i]
            gp = np.pad(gd, 1)
            dil = gd.copy()
            for dz in range(3):
                for dy in range(3):
                    for dx in range(3):
                        np.maximum(dil, gp[dz:dz + d, dy:dy + h, dx:dx + w], out=dil)
            pad = nb * BRICK - np.asarray([d, h, w])
            dilp = np.pad(dil, [(0, pad[0]), (0, pad[1]), (0, pad[2])])
            bricks[i] = dilp.reshape(nb[0], BRICK, nb[1], BRICK, nb[2], BRICK).max(
                axis=(1, 3, 5))
        out["grid_brickmax"] = bricks
        return out


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (phase_function.h:12-66)
# ---------------------------------------------------------------------------


def hg_phase(g, cos_t):
    denom = 1.0 + g * g + 2.0 * g * cos_t
    return (1.0 - g * g) / torch.clamp(
        4.0 * PI * denom * torch.sqrt(torch.clamp(denom, min=1e-8)), min=1e-8)


def hg_sample(g, wo, u1, u2):
    """Sample a direction about -wo, the direction of travel (wo points
    to the previous vertex).  Returns (wi, pdf)."""
    d = -wo
    g = torch.clamp(g, -0.999, 0.999)
    safe = torch.abs(g) > 1e-3
    denom1 = 1.0 - g + 2.0 * g * u1
    sq = (1.0 - g * g) / torch.where(torch.abs(denom1) > 1e-6, denom1, 1e-6)
    denom2 = 2.0 * g
    cos_t_g = (1.0 + g * g - sq * sq) / torch.where(torch.abs(denom2) > 1e-6, denom2, 1e-6)
    cos_t = torch.where(safe, cos_t_g, 1.0 - 2.0 * u1)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * PI * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wi = vm.normalize(vm.to_world(local, d))
    return wi, hg_phase(g, cos_t)


# ---------------------------------------------------------------------------
# Grid sampling (heterogeneous density)
# ---------------------------------------------------------------------------


def _to_index(x):
    """float -> int32 saturating, as the reference's float-to-int
    convert (values beyond int32 would be undefined in torch)."""
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(torch.int32)


def _grid_box(scene, gid):
    """(clamped grid ids, their boxes' corners, their sizes as float)."""
    g = torch.clamp(gid, 0, scene["grid_dim"].shape[0] - 1).long()
    return g, scene["grid_bmin"][g], scene["grid_bmax"][g], scene["grid_dim"][g].to(torch.float32)


def sample_grid_density(scene, gid, p):
    """Trilinear density at world points p [N, 3] of grids gid [N]; 0
    outside the grid's box."""
    if "grid_density" not in scene:
        return torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    g, lo, hi, dim = _grid_box(scene, gid)
    uvw = (p - lo) / torch.clamp(hi - lo, min=1e-8)
    inside = torch.all((uvw >= 0.0) & (uvw <= 1.0), dim=-1)
    ijk = uvw * (dim - 1.0)
    i0 = _to_index(torch.floor(ijk))
    f = ijk - i0.to(torch.float32)
    D = scene["grid_density"]
    # each axis's two taps, clipped to the stack (no device tensor is made
    # from host values here: on the card that copy would wait for the device)
    taps = [[torch.clamp(i0[..., a] + o, 0, D.shape[1 + a] - 1).long() for o in (0, 1)]
            for a in range(3)]

    def fetch(oz, oy, ox):
        return D[g, taps[0][oz], taps[1][oy], taps[2][ox]]

    fz, fy, fx = f[..., 0], f[..., 1], f[..., 2]
    c = (
        fetch(0, 0, 0) * (1 - fz) * (1 - fy) * (1 - fx)
        + fetch(0, 0, 1) * (1 - fz) * (1 - fy) * fx
        + fetch(0, 1, 0) * (1 - fz) * fy * (1 - fx)
        + fetch(0, 1, 1) * (1 - fz) * fy * fx
        + fetch(1, 0, 0) * fz * (1 - fy) * (1 - fx)
        + fetch(1, 0, 1) * fz * (1 - fy) * fx
        + fetch(1, 1, 0) * fz * fy * (1 - fx)
        + fetch(1, 1, 1) * fz * fy * fx
    )
    return torch.where(inside, c, 0.0)


def _medium_row(scene, mid):
    m = torch.clamp(mid, 0, scene["med_sigma_a"].shape[0] - 1).long()
    return {
        "sigma_a": scene["med_sigma_a"][m],
        "sigma_s": scene["med_sigma_s"][m],
        "g": scene["med_g"][m],
        "le": scene["med_le"][m],
        "grid": scene["med_grid"][m],
    }


def _mean3(x):
    """The mean over the last axis of 3, summed in order then divided, as
    the reference's jnp.mean."""
    return (x[..., 0] + x[..., 1] + x[..., 2]) / 3.0


def sample_medium_distance(scene, mid, ro, rd, t_surf, u_dist, u_chan, seed, active=None):
    """Sample a scattering distance inside medium `mid` along [0, t_surf].

    Homogeneous: analytic exponential sampling on a hero channel.
    Heterogeneous: delta tracking against the grid majorant.  `active`
    (optional) limits the tracking to those lanes; the others return as
    if they had no grid to track (their result is the caller's to mask).

    Returns {t, scattered, weight [N, 3], g, le, sigma_a}: weight is the
    throughput factor for either outcome.
    """
    med = _medium_row(scene, mid)
    sigma_t = med["sigma_a"] + med["sigma_s"]
    in_medium = mid >= 0

    ch = torch.clamp((u_chan * 3).to(torch.int32), max=2).long()
    s_t_hero = torch.gather(sigma_t, -1, ch[..., None])[..., 0]
    s_t_hero = torch.clamp(s_t_hero, min=1e-6)
    t_hom = -torch.log(torch.clamp(1.0 - u_dist, 1e-7, 1.0)) / s_t_hero
    scat_hom = t_hom < t_surf
    # single-channel MIS weights over the 3 channels (spectral balance)
    tr_t = torch.exp(-sigma_t * torch.minimum(t_hom, t_surf)[..., None])
    pdf_scat = _mean3(sigma_t * tr_t)
    pdf_pass = _mean3(tr_t)
    w_scat = med["sigma_s"] * tr_t / torch.clamp(pdf_scat, min=1e-10)[..., None]
    w_pass = tr_t / torch.clamp(pdf_pass, min=1e-10)[..., None]

    is_hetero = med["grid"] >= 0
    if "grid_density" in scene:
        act = in_medium & is_hetero
        if active is not None:
            act = act & active
        t_het, scat_het = _delta_track(scene, med, ro, rd, t_surf, seed, active=act)
        # null-collision estimator: weight sigma_s / sigma_t at real events
        albedo = med["sigma_s"] / torch.clamp(sigma_t, min=1e-8)
        t = torch.where(is_hetero, t_het, t_hom)
        scattered = torch.where(is_hetero, scat_het, scat_hom) & in_medium
        w_scat = torch.where(is_hetero[..., None], albedo, w_scat)
        w_pass = torch.where(is_hetero[..., None], torch.ones_like(w_pass), w_pass)
    else:
        t = t_hom
        scattered = scat_hom & in_medium

    weight = torch.where(scattered[..., None], w_scat, w_pass)
    weight = torch.where(in_medium[..., None], weight, 1.0)
    return {"t": torch.where(scattered, t, t_surf), "scattered": scattered,
            "weight": weight, "g": med["g"], "le": med["le"], "sigma_a": med["sigma_a"]}


def _brick_step(scene, gid, p, rd, t):
    """(brick majorant at p, absolute t at the brick's exit along rd).

    A brick majorant of 0 certifies every trilinear tap in the brick is
    0, so the segment to the brick's exit is crossed in one step with no
    collision test."""
    g, lo, hi, dim = _grid_box(scene, gid)
    BM = scene["grid_brickmax"]
    ijk = (p - lo) / torch.clamp(hi - lo, min=1e-8) * (dim - 1.0)
    fb = torch.floor(ijk / BRICK)
    bi = _to_index(fb)
    mb = BM[(g,) + tuple(torch.clamp(bi[..., a], 0, BM.shape[1 + a] - 1).long()
                         for a in range(3))]
    step_w = (hi - lo) / torch.clamp(dim - 1.0, min=1.0)  # world units a voxel
    bound_w = lo + (fb + (rd > 0)) * BRICK * step_w
    tex = torch.where(torch.abs(rd) > 1e-12, (bound_w - p) / rd, float(np.float32(3e38)))
    t_rel = torch.amin(tex, dim=-1)
    eps = 0.05 * torch.amin(step_w, dim=-1)
    return mb, t + torch.clamp(t_rel, min=0.0) + eps


def lcg_next(key):
    """The tracking loops' key step, key * 747796405 + 2891336453 mod 2^32."""
    return (_mul32(key, _LCG_MUL) + _LCG_ADD) & _M32


def key_uniform(key):
    """The uniform a key gives, (key >> 9) / 2^23, exactly."""
    return (key >> 9).to(torch.float32) / float(1 << 23)


def delta_key0(seed):
    return (_mul32(seed, _DELTA_SEED_MUL) + 1) & _M32


def ratio_key0(seed):
    return (_mul32(seed, _RATIO_SEED_MUL) + 7) & _M32


def _tracking_setup(scene, med):
    gid = med["grid"]
    g = torch.clamp(gid, 0, scene["grid_majorant"].shape[0] - 1).long()
    maj = torch.clamp(scene["grid_majorant"][g], min=1e-6)
    s_bar = maj * torch.clamp(torch.amax(med["sigma_a"] + med["sigma_s"], dim=-1), min=1e-6)
    return gid, maj, s_bar


def _tentative(scene, gid, ro, rd, t, step):
    """(t of the next tentative collision, whether it crossed an empty
    brick)."""
    if "grid_brickmax" not in scene:
        return t + step, torch.zeros_like(t, dtype=torch.bool)
    mb, t_exit = _brick_step(scene, gid, ro + t[..., None] * rd, rd, t)
    skip = mb <= 0.0
    return torch.where(skip, t_exit, t + step), skip


def _delta_track(scene, med, ro, rd, t_surf, seed, active=None):
    """Delta (Woodcock) tracking: (t, scattered), over the live lanes."""
    gid, maj, s_bar = _tracking_setup(scene, med)
    need = t_surf > 0.0
    if active is not None:
        need = need & active
    n = ro.shape[0]
    t = torch.zeros((n,), dtype=torch.float32, device=ro.device)
    scat = torch.zeros((n,), dtype=torch.bool, device=ro.device)
    done = ~need
    lane = torch.nonzero(need).squeeze(1)
    key = torch.broadcast_to(delta_key0(seed), (n,))[lane]
    o, d, ts, gl, sb, mj = ro[lane], rd[lane], t_surf[lane], gid[lane], s_bar[lane], maj[lane]
    tl = t[lane]
    for _ in range(MAX_TRACKING_STEPS):
        spans.count("host_sync.tracking")  # the live count: the nonzero, then each keep
        if not lane.numel():
            break
        key = lcg_next(key)
        u1 = key_uniform(key)
        key = lcg_next(key)
        u2 = key_uniform(key)
        step = -torch.log(torch.clamp(1.0 - u1, 1e-7, 1.0)) / sb
        t_new, skip = _tentative(scene, gl, o, d, tl, step)
        dens = sample_grid_density(scene, gl, o + t_new[..., None] * d)
        real = ~skip & (u2 < (dens / mj))
        escaped = t_new >= ts
        fin = real | escaped
        t[lane] = t_new
        scat[lane] = real & ~escaped
        done[lane] = fin
        keep = torch.nonzero(~fin).squeeze(1)  # one sync; indexing by it makes none
        lane, key, o, d, ts, gl, sb, mj, tl = (
            lane[keep], key[keep], o[keep], d[keep], ts[keep], gl[keep], sb[keep], mj[keep],
            t_new[keep])
    return torch.minimum(t, t_surf), scat & done & need


def transmittance(scene, mid, ro, rd, dist, seed, active=None):
    """RGB transmittance along a segment of length dist inside medium
    `mid`: Beer-Lambert (homogeneous), ratio tracking (a grid).  Lanes
    outside `active` skip the tracking (and return 1 in a grid)."""
    med = _medium_row(scene, mid)
    sigma_t = med["sigma_a"] + med["sigma_s"]
    in_medium = mid >= 0
    tr_hom = torch.exp(-sigma_t * dist[..., None])
    if "grid_density" in scene:
        is_het = med["grid"] >= 0
        act = in_medium & is_het
        if active is not None:
            act = act & active
        tr_het = _ratio_track(scene, med, ro, rd, dist, seed, active=act)
        tr = torch.where(is_het[..., None], tr_het, tr_hom)
    else:
        tr = tr_hom
    return torch.where(in_medium[..., None], tr, 1.0)


def _ratio_track(scene, med, ro, rd, dist, seed, active=None):
    """Ratio tracking with brick skipping, over the live lanes: [N, 3]."""
    gid, maj, s_bar = _tracking_setup(scene, med)
    need = dist > 0.0
    if active is not None:
        need = need & active
    n = ro.shape[0]
    tr = torch.ones((n,), dtype=torch.float32, device=ro.device)
    lane = torch.nonzero(need).squeeze(1)
    key = torch.broadcast_to(ratio_key0(seed), (n,))[lane]
    o, d, ds, gl, sb, mj = ro[lane], rd[lane], dist[lane], gid[lane], s_bar[lane], maj[lane]
    tl = torch.zeros_like(ds)
    trl = tr[lane]
    for _ in range(MAX_TRACKING_STEPS):
        spans.count("host_sync.tracking")  # the live count: the nonzero, then each keep
        if not lane.numel():
            break
        key = lcg_next(key)
        u1 = key_uniform(key)
        step = -torch.log(torch.clamp(1.0 - u1, 1e-7, 1.0)) / sb
        t_new, skip = _tentative(scene, gl, o, d, tl, step)
        alive = t_new < ds
        dens = sample_grid_density(scene, gl, o + t_new[..., None] * d)
        trl = torch.where(alive & ~skip, trl * (1.0 - dens / mj), trl)
        tr[lane] = trl
        keep = torch.nonzero(alive).squeeze(1)
        lane, key, o, d, ds, gl, sb, mj, tl, trl = (
            lane[keep], key[keep], o[keep], d[keep], ds[keep], gl[keep], sb[keep], mj[keep],
            t_new[keep], trl[keep])
    return tr[..., None] * torch.ones((1, 3), dtype=torch.float32, device=ro.device)
