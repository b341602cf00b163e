"""Batched 3D math on [..., 3] tensors.

Counterpart of aten_tpu/core/vecmath.py.  Every expression keeps the
reference's operation order (left-to-right sums, explicit products) so
that results agree to the last few ulps.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6
INF = float(np.float32(3.4e38))


def dot(a, b, keepdims=True):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def length(a, keepdims=True):
    return torch.sqrt(torch.clamp(torch.sum(a * a, dim=-1, keepdim=keepdims), min=0.0))


def normalize(a):
    return a / torch.clamp(length(a), min=1e-20)


def reflect(wi, n):
    """Reflect direction `wi` (pointing away from surface) about normal."""
    return normalize(2.0 * dot(wi, n) * n - wi)


def refract(wi, n, eta):
    """Refract `wi` (away from surface, same side as n); eta = n_i / n_t
    with a trailing axis of 1.  Returns (wt, total_internal_reflection)."""
    cos_i = dot(wi, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = normalize(-eta * wi + (eta * cos_i - cos_t) * n)
    return wt, tir[..., 0]


def onb(n):
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.cat([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.cat([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_world(local_dir, n):
    """Map a local-frame direction (z-up) into the frame of normal n."""
    t, b = onb(n)
    return (
        local_dir[..., 0:1] * t
        + local_dir[..., 1:2] * b
        + local_dir[..., 2:3] * n
    )


def spherical_dir(sin_theta, cos_theta, phi):
    return torch.cat(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1)


def luminance(rgb):
    return 0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2] + 0.0722 * rgb[..., 2:3]


def ipow(x, y: int):
    """x**y for a static positive int y by binary exponentiation, in the
    multiplication order of JAX's integer_pow (x**5 = x * (x2 * x2))."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


# Intersection primitives (the reference's math/intersect.h and aabb.h),
# batched: rays are [N, 3] tensors and primitives may broadcast.


def intersect_aabb(ro, rd_inv, bmin, bmax, t_max):
    """Slab test: hit mask [N].  rd_inv = 1 / rd (inf where rd is 0)."""
    t0 = (bmin - ro) * rd_inv
    t1 = (bmax - ro) * rd_inv
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < t_max)


def intersect_tri(ro, rd, v0, e1, e2, t_min=EPS):
    """Moller-Trumbore over [..., 3] tensors: (t, u, v, hit mask)."""
    pvec = cross(rd, e2)
    det = dot(e1, pvec, keepdims=False)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = ro - v0
    u = dot(tvec, pvec, keepdims=False) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec, keepdims=False) * inv_det
    t = dot(e2, qvec, keepdims=False) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return t, u, v, hit


def intersect_sphere(ro, rd, center, radius, t_min=EPS):
    """(t, hit mask): the nearest root beyond t_min."""
    oc = ro - center
    b = dot(oc, rd, keepdims=False)
    c = dot(oc, oc, keepdims=False) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > t_min, t0, t1)
    return t, (disc > 0.0) & (t > t_min)


def transform_point(m, p):
    """[..., 4, 4] matrices applied to [..., 3] points."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", m, ph)[..., :3]


def transform_vector(m, v):
    """[..., 4, 4] matrices' linear part applied to [..., 3] vectors."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


def look_at(eye, center, up):
    """Camera-to-world basis (right, up, forward) as float32 numpy."""
    f = np.asarray(center, np.float32) - np.asarray(eye, np.float32)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float32))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    return r.astype(np.float32), u.astype(np.float32), f.astype(np.float32)
