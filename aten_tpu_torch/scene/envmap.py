"""Image-based lighting: the equirect envmap, its lookups and alias-table
sampling.

Counterpart of aten_tpu/scene/envmap.py.  `build_env_tables` runs on the
host in numpy with the reference's own expressions (the Walker/Vose
alias loop in float64, with the same small/large pop order), so every
table is bit for bit the reference's.  The reference also stages a
12-wide bilinear quad-row table (`env_quad`) so that a TPU fetches the
four taps of `eval_env` in one gather, behind an optimization barrier;
the port builds no such table and fetches the four taps by plain index
reads of the flat image, which gives the same values.

Directions map to (u, v) by the equirect parameterization; a sample
picks a texel with probability proportional to its luminance times
sin(theta), and its pdf is that texel probability over the texel's
solid angle.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# the tables the build puts into a scene (the reference's, without env_quad)
TABLE_KEYS = ("envmap", "env_weight", "env_cdf_v", "env_cdf_u", "env_alias",
              "env_payload", "env_avg_illum")


def build_env_tables(img: np.ndarray) -> dict:
    """img: [H, W, 3] float32 equirect radiance map -> numpy tables."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None]
    row_w = weight.sum(axis=1)
    total = max(row_w.sum(), 1e-20)
    cdf_v = np.cumsum(row_w) / total
    cdf_u = np.cumsum(weight, axis=1) / np.maximum(row_w[:, None], 1e-20)
    avg_illum = float(lum.mean())

    # Walker/Vose alias table over the texel distribution
    prob = (weight / total).ravel().astype(np.float64)
    n = prob.size
    scaled = prob * n
    alias = np.arange(n, dtype=np.int64)
    cut = np.ones(n, np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        cut[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    # per texel: rgb radiance and p(texel)
    payload = np.concatenate(
        [img.reshape(n, -1)[:, :3], (weight / total).reshape(n, 1)], axis=1
    ).astype(np.float32)
    # [HW, 2]: the cut, then the alias index bit-cast to float32
    alias_rows = np.stack(
        [cut.astype(np.float32), alias.astype(np.int32).view(np.float32)], axis=1)
    return {
        "envmap": img,
        "env_weight": (weight / total).astype(np.float32),
        "env_cdf_v": cdf_v.astype(np.float32),
        "env_cdf_u": cdf_u.astype(np.float32),
        "env_alias": alias_rows,
        "env_payload": payload,
        "env_avg_illum": np.float32(avg_illum),
    }


def dir_to_uv(d):
    """Equirect mapping of unit directions [..., 3] to (u, v) in [0, 1]."""
    phi = torch.atan2(d[..., 2], d[..., 0])  # [-pi, pi]
    u = phi / (2.0 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def uv_to_dir(u, v):
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = v * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], dim=-1)


def eval_env(scene, d):
    """Bilinear radiance [N, 3] of the envmap in directions d [N, 3]:
    x wraps, y clamps at the poles."""
    img = scene["envmap"]
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(-1, img.shape[-1])
    u, v = dir_to_uv(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()

    def tap(xi, yi):
        return flat[torch.clamp(yi, 0, h - 1) * w + torch.remainder(xi, w)]

    return (tap(x0, y0) * (1 - fx) * (1 - fy)
            + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy
            + tap(x0 + 1, y0 + 1) * fx * fy)


def _texel_jacobian(v, w, h):
    """Solid angle per unit texel probability at row coordinate v."""
    theta = torch.clamp(v * math.pi, 1e-4, math.pi - 1e-4)
    return (2.0 * math.pi / w) * (math.pi / h) * torch.sin(theta)


def pdf_env(scene, d):
    """Solid-angle pdf of sample_ibl proposing direction d."""
    pw = scene["env_weight"]
    h, w = pw.shape
    u, v = dir_to_uv(d)
    xi = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    p_cell = pw.reshape(-1)[yi * w + xi]
    return p_cell / torch.clamp(_texel_jacobian(v, w, h), min=1e-12)


def sample_ibl(scene, p, uv):
    """Alias-table sample of the envmap for shading points p [N, 3] from
    the uniforms uv = (u1, u2); a light-sample dict in solid-angle
    measure, at distance 1e30."""
    h, w = scene["envmap"].shape[0], scene["envmap"].shape[1]
    n = h * w
    u1, u2 = uv
    cell0 = torch.clamp((u1 * n).to(torch.int32), max=n - 1).long()
    table = scene["env_alias"]
    cut = table[:, 0][cell0]
    alt = table[:, 1].contiguous().view(torch.int32)[cell0]
    cell = torch.where(u2 <= cut, cell0, alt.long())
    pay = scene["env_payload"][cell]
    le = pay[..., 0:3]
    p_cell = pay[..., 3]
    row = cell // w
    col = cell - row * w
    uu = (col.to(torch.float32) + 0.5) / w
    vv = (row.to(torch.float32) + 0.5) / h
    d = uv_to_dir(uu, vv)
    pdf = p_cell / torch.clamp(_texel_jacobian(vv, w, h), min=1e-12)
    shape = p.shape[:-1]
    false = torch.zeros(shape, dtype=torch.bool, device=p.device)
    return {
        "pos": p + d * 1e30,
        "nml": -d,
        "dir": d,
        "dist": torch.full(shape, 1e30, dtype=torch.float32, device=p.device),
        "le": le,
        "pdf": pdf,
        "singular": false,
        "infinite": ~false,
        "area_measure": false,
    }
