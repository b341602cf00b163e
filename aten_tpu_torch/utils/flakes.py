"""Procedural car-paint flakes: the shade-time generator and its hash.

Counterpart of aten_tpu/utils/flakes.py.  `flakes_gen` scans the 3x3
jittered cells around each lane's uv; each cell holds one flake at a
hashed offset with a hashed, cone-limited normal, and a lane on a flake
disc gets that flake's tangent-space normal and coverage 1, others the
flat normal (0, 0, 1) and 0.  The cell hash is Jenkins' lookup3.

The reference hashes in uint32 with wraparound.  As in core/sampler.py,
every value here is an int64 tensor holding a uint32, masked back to 32
bits after each add, subtract and shift, so the hash is bit for bit the
reference's.  `make_flakes_normal_map` is the host baking tool: an
[S, S, 3] 0.5-biased tangent-space normal map.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_INIT = (0xDEADBEEF + (4 << 2) + 13) & _M32
_INV = 1.0 / 4294967295.0


def _rotl(x, k):
    return ((x << k) & _M32) | (x >> (32 - k))


def _sub(a, b):
    return (a - b) & _M32


def _add(a, b):
    return (a + b) & _M32


def _bjfinal(a, b, c):
    """lookup3's final mix."""
    c = c ^ b
    c = _sub(c, _rotl(b, 14))
    a = a ^ c
    a = _sub(a, _rotl(c, 11))
    b = b ^ a
    b = _sub(b, _rotl(a, 25))
    c = c ^ b
    c = _sub(c, _rotl(b, 16))
    a = a ^ c
    a = _sub(a, _rotl(c, 4))
    b = b ^ a
    b = _sub(b, _rotl(a, 14))
    c = c ^ b
    c = _sub(c, _rotl(b, 24))
    return c


def _bjmix(a, b, c):
    """lookup3's mix."""
    a = _sub(a, c)
    a = a ^ _rotl(c, 4)
    c = _add(c, b)
    b = _sub(b, a)
    b = b ^ _rotl(a, 6)
    a = _add(a, c)
    c = _sub(c, b)
    c = c ^ _rotl(b, 8)
    b = _add(b, a)
    a = _sub(a, c)
    a = a ^ _rotl(c, 16)
    c = _add(c, b)
    b = _sub(b, a)
    b = b ^ _rotl(a, 19)
    a = _add(a, c)
    c = _sub(c, b)
    c = c ^ _rotl(b, 4)
    b = _add(b, a)
    return a, b, c


def _inthash4(k0, k1, k2, k3):
    """lookup3 hash of four uint32 keys (int64 tensors or ints)."""
    a = _add(k0, _INIT)
    b = _add(k1, _INIT)
    c = _add(k2, _INIT)
    a, b, c = _bjmix(a, b, c)
    a = _add(a, k3)
    return _bjfinal(a, b, c)


def _cell_key(p):
    """floor(p) as int32, reinterpreted as uint32: negative cells wrap to
    two's complement."""
    return torch.floor(p).to(torch.int32).to(torch.int64) & _M32


def _cellnoise3(px, py, pz):
    """Three uniforms in [0, 1] per integer cell.  The hash goes to float32
    rounding to nearest, as the reference's uint32 -> float32."""
    kx, ky, kz = _cell_key(px), _cell_key(py), _cell_key(pz)
    return tuple(_inthash4(kx, ky, kz, j).to(torch.float32) * _INV for j in range(3))


_CELL_CENTERS = ((0.5, 0.5), (1.5, 0.5), (1.5, 1.5), (0.5, 1.5), (-0.5, 1.5),
                 (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5), (1.5, -0.5))


def flakes_gen(u, v, flake_scale, flake_size, flake_size_variance,
               flake_normal_orientation):
    """Per-lane flake lookup.  u, v [N]; the four parameters [N].
    Returns (nml [N,3] tangent-space flake normal, alpha [N], 1 where
    the uv lies on a flake)."""
    var = torch.clamp(flake_size_variance, 0.1, 1.0)
    px = flake_scale * u
    py = flake_scale * v
    bx = torch.floor(px)
    by = torch.floor(py)

    best_cz = torch.ones_like(px)
    best_cx = torch.zeros_like(px)
    best_cy = torch.zeros_like(px)
    found = torch.zeros_like(px, dtype=torch.bool)
    for cx0, cy0 in _CELL_CENTERS:
        ccx = bx + cx0
        ccy = by + cy0
        r0, r1, r2 = _cellnoise3(ccx, ccy, torch.zeros_like(ccx))
        ox = r0 * 2.0 - 1.0
        oy = r1 * 2.0 - 1.0
        oz = (r2 * 2.0 - 1.0) * var
        inv_len = 1.0 / torch.sqrt(torch.clamp(ox * ox + oy * oy + oz * oz, min=1e-12))
        fx = ccx + 0.5 * ox * inv_len
        fy = ccy + 0.5 * oy * inv_len
        fz = 0.5 * oz * inv_len
        dx = px - fx
        dy = py - fy
        d = torch.sqrt(dx * dx + dy * dy + fz * fz)
        take = (d < flake_size) & (fz < best_cz)
        best_cz = torch.where(take, fz, best_cz)
        best_cx = torch.where(take, ccx, best_cx)
        best_cy = torch.where(take, ccy, best_cy)
        found = found | take

    # the winning cell's random normal, faced to +z and mixed toward it
    r0, r1, r2 = _cellnoise3(best_cx, best_cy, torch.full_like(best_cx, 1.5))
    nx = r0 * 2.0 - 1.0
    ny = r1 * 2.0 - 1.0
    nz = r2 * 2.0 - 1.0
    flip = torch.where(nz < 0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    t = flake_normal_orientation
    nx = nx * (1.0 - t)
    ny = ny * (1.0 - t)
    nz = nz * (1.0 - t) + t
    inv_len = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-12))
    nml = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    flat = torch.tensor([0.0, 0.0, 1.0], dtype=nml.dtype, device=nml.device)
    nml = torch.where(found[..., None], nml, flat)
    return nml, found.to(torch.float32)


def flake_density(flake_size, aspect=1.0):
    """Expected flake coverage: min(pi * size^2 / aspect, 1)."""
    return torch.clamp(math.pi * flake_size * flake_size / aspect, max=1.0)


def make_flakes_normal_map(size=256, flake_scale=24.0, flake_size=0.35,
                           normal_cone=0.35, seed=0):
    """Bake an [size, size, 3] flake normal map (numpy, seeded).
    flake_scale: cells per texture edge; flake_size: flake disc radius
    within its cell (0..0.5); normal_cone: the largest tangent tilt."""
    rng = np.random.default_rng(seed)
    n_cells = int(flake_scale)
    jitter = rng.uniform(0.2, 0.8, (n_cells, n_cells, 2))
    tilt = rng.uniform(-normal_cone, normal_cone, (n_cells, n_cells, 2))

    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    u = (xs + 0.5) / size * n_cells
    v = (ys + 0.5) / size * n_cells
    ci = np.clip(u.astype(int), 0, n_cells - 1)
    cj = np.clip(v.astype(int), 0, n_cells - 1)
    cx = ci + jitter[cj, ci, 0]
    cy = cj + jitter[cj, ci, 1]
    d = np.hypot(u - cx, v - cy)
    in_flake = d < flake_size

    nx = np.where(in_flake, tilt[cj, ci, 0], 0.0)
    ny = np.where(in_flake, tilt[cj, ci, 1], 0.0)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 1e-6))
    n = np.stack([nx, ny, nz], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)
