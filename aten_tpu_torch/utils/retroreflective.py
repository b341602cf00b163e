"""Effective retroreflective area (ERA) of a corner-cube pair, on the host.

Counterpart of aten_tpu/utils/retroreflective.py with its numpy path
(`xp=np`) only: the port builds the retroreflective BRDF's ERA table
from it at scene shading time, once per process.  Rays start on a
barycentric grid over the front triangle {(0,P,0),(0,0,P),(P,0,0)} of
the pair, in the direction of spherical (theta, phi) in the frame
{t=(-.5,1,-.5)/|.|, b=(-1,0,1)/|.|, n=-front_normal}; ERA(theta, phi)
is the share of the rays that hit the front face and then the back face
{(-P,0,0),(0,-P,0),(0,0,-P)}.  Every expression keeps the reference's
numpy types and order, so the table is bit for bit the reference's.
`era_table`, the measuring tool's full table, runs in float32 with torch
on a device, as the reference's runs in float32 with jnp.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.core.vecmath import cross

RAY_ORG_NUM = 100
THETA_MIN, THETA_MAX = 0.0, np.pi / 2
PHI_MIN, PHI_MAX = 0.0, np.pi
_POS = 1.0

FRONT = np.array([[0, _POS, 0], [0, 0, _POS], [_POS, 0, 0]], np.float32)
BACK = np.array([[-_POS, 0, 0], [0, -_POS, 0], [0, 0, -_POS]], np.float32)


def ray_origins(n: int = RAY_ORG_NUM) -> np.ndarray:
    """Barycentric grid over the front triangle."""
    step = 1.0 / n
    pts = []
    p0 = FRONT[0]
    v0 = FRONT[1] - FRONT[0]
    v1 = FRONT[2] - FRONT[0]
    for y in range(n + 1):
        a = min(y * step, 1.0)
        for x in range(n + 1):
            b = min(x * step, 1.0)
            if a + b > 1.0:
                break
            pts.append(p0 + v0 * a + v1 * b)
    return np.asarray(pts, np.float32)


def gen_ray(theta, phi):
    """Unit direction for spherical (theta, phi) in the pair's frame;
    broadcasts over arrays."""
    v0 = FRONT[1] - FRONT[0]
    v1 = FRONT[2] - FRONT[0]
    n = np.cross(v0 / np.linalg.norm(v0), v1 / np.linalg.norm(v1))
    n = -n / np.linalg.norm(n)
    t = np.array([-0.5, 1.0, -0.5])
    t = t / np.linalg.norm(t)
    b = np.array([-1.0, 0.0, 1.0])
    b = b / np.linalg.norm(b)
    st = np.sin(theta)
    x = st * np.cos(phi)
    y = st * np.sin(phi)
    z = np.cos(theta)
    d = x[..., None] * t[None] + y[..., None] * b[None] + z[..., None] * n[None]
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _tri_hit(ro, rd, tri):
    """Both-sided Möller-Trumbore test; ro, rd [..., 3] broadcastable."""
    v0, v1, v2 = (np.asarray(t) for t in tri)
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(rd, e2)
    det = np.sum(e1 * p, axis=-1)
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
    s = ro - v0
    u = np.sum(s * p, axis=-1) * inv
    q = np.cross(s, e1)
    v = np.sum(rd * q, axis=-1) * inv
    t = np.sum(e2 * q, axis=-1) * inv
    return (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)


def era(theta, phi, n_orgs: int = RAY_ORG_NUM):
    """ERA for arrays of angles: [A] -> [A] hit shares, one [A, O] batch
    of the two triangle tests."""
    theta = np.atleast_1d(np.asarray(theta, np.float32))
    phi = np.atleast_1d(np.asarray(phi, np.float32))
    d = gen_ray(theta, phi)  # [A,3]
    ro = ray_origins(n_orgs)[None, :, :]  # [1,O,3]
    rd = d[:, None, :]  # [A,1,3]
    # the origins lie on the front plane: step back along the ray so the
    # front-face test is a proper intersection
    ro = ro - rd * 1e-3
    front = _tri_hit(ro, rd, FRONT)  # [A,O]
    back = _tri_hit(ro, rd, BACK)
    n_front = front.sum(axis=-1)
    n_both = (front & back).sum(axis=-1)
    return np.where(n_front > 0, n_both / np.maximum(n_front, 1), 0.0)



def _tri_hit_t(ro, rd, tri):
    """_tri_hit on float32 tensors."""
    v0, v1, v2 = (torch.tensor(t, device=ro.device) for t in tri)
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(rd.expand(ro.shape), e2)
    det = torch.sum(e1 * p, dim=-1)
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    s = ro - v0
    u = torch.sum(s * p, dim=-1) * inv
    q = cross(s, e1)
    v = torch.sum(rd * q, dim=-1) * inv
    t = torch.sum(e2 * q, dim=-1) * inv
    return (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)


def era_table(steps: int = 40, n_orgs: int = RAY_ORG_NUM, device="cuda"):
    """(theta grid [T], phi grid [P], era [T, P] float32) over the
    measuring tool's angle ranges, evaluated in float32 with torch on
    `device` (the card unless the caller names the CPU), as the reference
    evaluates its table in float32 with jnp.  `era` above is the host
    evaluation (float64 directions) that the BRDF's table uses; the two
    differ where a grid origin lies on a triangle's edge."""
    from aten_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    thetas = np.linspace(THETA_MIN, THETA_MAX, steps, endpoint=False)
    phis = np.linspace(PHI_MIN, PHI_MAX, steps, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    f32 = torch.float32
    theta = torch.tensor(tt.ravel(), dtype=f32, device=dev)
    phi = torch.tensor(pp.ravel(), dtype=f32, device=dev)
    v0, v1 = FRONT[1] - FRONT[0], FRONT[2] - FRONT[0]
    n = np.cross(v0 / np.linalg.norm(v0), v1 / np.linalg.norm(v1))
    n = -n / np.linalg.norm(n)
    t = np.array([-0.5, 1.0, -0.5])
    t = t / np.linalg.norm(t)
    b = np.array([-1.0, 0.0, 1.0])
    b = b / np.linalg.norm(b)
    t, b, n = (torch.tensor(x, dtype=f32, device=dev) for x in (t, b, n))
    st = torch.sin(theta)
    d = ((st * torch.cos(phi))[:, None] * t[None] + (st * torch.sin(phi))[:, None] * b[None]
         + torch.cos(theta)[:, None] * n[None])
    rd = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))[:, None, :]  # [A,1,3]
    ro = torch.tensor(ray_origins(n_orgs), device=dev)[None] - rd * 1e-3  # [A,O,3]
    front = _tri_hit_t(ro, rd, FRONT)
    back = _tri_hit_t(ro, rd, BACK)
    n_front = front.sum(dim=-1)
    n_both = (front & back).sum(dim=-1)
    vals = torch.where(n_front > 0, n_both / torch.clamp(n_front, min=1), 0.0).to(f32)
    return thetas, phis, vals.reshape(steps, steps).cpu().numpy()
