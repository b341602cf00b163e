"""Batched 3D math on [..., 3] tensors, in the floating type of the run.

A frozen copy of the port's vector helpers, kept in the benchmark so that
the reference stays fixed while the program changes.  Every float tensor
made here takes torch's default dtype, which `precision()` sets: float32
for the reference, bfloat16 for its control.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

INF = float(np.float32(3.4e38))  # the program's "no limit" on a ray's t


def ftype():
    """The floating type the reference computes in."""
    return torch.get_default_dtype()


def inf():
    """INF, or the largest finite value of the run's floating type if
    that is smaller (bfloat16's is 3.39e38)."""
    return min(INF, float(torch.finfo(ftype()).max))


@contextlib.contextmanager
def precision(dtype):
    """Run the reference in `dtype` (torch.float32, or torch.bfloat16 for
    the control), restoring the previous default afterwards."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def dot(a, b, keepdims=True):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def length(a, keepdims=True):
    return torch.sqrt(torch.clamp(torch.sum(a * a, dim=-1, keepdim=keepdims), min=0.0))


def normalize(a):
    return a / torch.clamp(length(a), min=1e-20)


def reflect(wi, n):
    return normalize(2.0 * dot(wi, n) * n - wi)


def refract(wi, n, eta):
    """(wt, total internal reflection) of `wi` (away from the surface, on
    n's side); eta = n_i / n_t with a trailing axis of 1."""
    cos_i = dot(wi, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = normalize(-eta * wi + (eta * cos_i - cos_t) * n)
    return wt, tir[..., 0]


def onb(n):
    """Branchless orthonormal basis (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.cat([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.cat([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_world(local_dir, n):
    t, b = onb(n)
    return local_dir[..., 0:1] * t + local_dir[..., 1:2] * b + local_dir[..., 2:3] * n


def luminance(rgb):
    return 0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2] + 0.0722 * rgb[..., 2:3]


def ipow(x, y: int):
    """x**y for a static positive int y by binary exponentiation."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def look_at(eye, center, up):
    """Camera basis (right, up, forward) as float32 numpy."""
    f = np.asarray(center, np.float32) - np.asarray(eye, np.float32)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float32))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    return r.astype(np.float32), u.astype(np.float32), f.astype(np.float32)
