"""Light sampling, the envmap and next-event estimation.

A frozen copy of the port's area-light and image-based-light sampling
(scene/lights.py, scene/envmap.py) and of its NEE with MIS
(shading/nee.py), for the light kinds the benchmark's scenes use: area
lights on triangle ranges, and the envmap's alias-table light.  The
envmap tables are built on the host in numpy, as the port builds its own.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bsdf
from benchmark.reference import vecmath as vm
from benchmark.reference.sampler import next_1d, next_2d
from benchmark.reference.vecmath import ftype

AREA, IBL = 0, 1
TWO_PI = float(np.float32(2.0 * np.pi))


def build_env_tables(img):
    """Equirect radiance [H, W, 3] -> the numpy tables sampling reads:
    texel weights (luminance times sin theta), and a Walker/Vose alias
    table over them (float64 loop, the same pop order as the port)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None]
    total = max(weight.sum(axis=1).sum(), 1e-20)
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
    payload = np.concatenate([img.reshape(n, -1)[:, :3], (weight / total).reshape(n, 1)],
                             axis=1).astype(np.float32)
    return {"envmap": img, "env_weight": (weight / total).astype(np.float32),
            "env_cut": cut.astype(np.float32), "env_alias": alias, "env_payload": payload}


def dir_to_uv(d):
    phi = torch.atan2(d[..., 2], d[..., 0])
    u = phi / (2.0 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def uv_to_dir(u, v):
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = v * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], dim=-1)


def eval_env(scene, d):
    """Bilinear envmap radiance [N, 3] in directions d: x wraps, y clamps."""
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

    return (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)


def _texel_jacobian(v, w, h):
    theta = torch.clamp(v * math.pi, 1e-4, math.pi - 1e-4)
    return (2.0 * math.pi / w) * (math.pi / h) * torch.sin(theta)


def pdf_env(scene, d):
    pw = scene["env_weight"]
    h, w = pw.shape
    u, v = dir_to_uv(d)
    xi = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return pw.reshape(-1)[yi * w + xi] / torch.clamp(_texel_jacobian(v, w, h), min=1e-12)


def _sample_ibl(scene, p, uv):
    h, w = scene["envmap"].shape[0], scene["envmap"].shape[1]
    n = h * w
    u1, u2 = uv
    cell0 = torch.clamp((u1 * n).to(torch.int32), max=n - 1).long()
    cell = torch.where(u2 <= scene["env_cut"][cell0], cell0, scene["env_alias"][cell0])
    pay = scene["env_payload"][cell]
    row = cell // w
    col = cell - row * w
    uu = (col.to(ftype()) + 0.5) / w
    vv = (row.to(ftype()) + 0.5) / h
    d = uv_to_dir(uu, vv)
    pdf = pay[..., 3] / torch.clamp(_texel_jacobian(vv, w, h), min=1e-12)
    false = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    return {"nml": -d, "dir": d, "dist": torch.full(p.shape[:-1], 1e30, device=p.device),
            "le": pay[..., 0:3], "pdf": pdf, "infinite": ~false, "area_measure": false}


def _sample_area(scene, lrow, li, p, u1, uv):
    """A uniform point on the light's triangles; pdf in area measure."""
    cdf_rows = scene["lights"]["tri_cdf"][li]
    k = torch.sum((u1[..., None] > cdf_rows).to(torch.int32), dim=-1)
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(lrow["tri_count"] - 1, min=0))
    tidx = torch.clamp(lrow["tri_start"] + k, 0, scene["tri_v0"].shape[0] - 1).long()
    v0, e1, e2 = scene["tri_v0"][tidx], scene["tri_e1"][tidx], scene["tri_e2"][tidx]
    su = torch.sqrt(torch.clamp(uv[0], 1e-8, 1.0))
    pos = v0 + (1.0 - su)[..., None] * e1 + (uv[1] * su)[..., None] * e2
    nml = vm.normalize(vm.cross(e1, e2))
    to_l = pos - p
    dist = vm.length(to_l, keepdims=False)
    false = torch.zeros_like(dist, dtype=torch.bool)
    return {"nml": nml, "dir": to_l / torch.clamp(dist[..., None], min=1e-20), "dist": dist,
            "le": lrow["le"], "pdf": 1.0 / torch.clamp(lrow["area"], min=1e-20),
            "infinite": false, "area_measure": ~false}


def sample_light(scene, light_idx, p, u1, uv):
    lights = scene["lights"]
    li = torch.clamp(light_idx, 0, lights["type"].shape[0] - 1).long()
    lrow = {k: v[li] for k, v in lights.items() if k != "tri_cdf"}
    out = _sample_area(scene, lrow, li, p, u1, uv)
    if "envmap" in scene:
        ibl = _sample_ibl(scene, p, uv)
        is_ibl = lrow["type"] == IBL
        out = {k: torch.where(is_ibl[..., None] if out[k].ndim > is_ibl.ndim else is_ibl,
                              ibl[k], out[k]) for k in out}
    return out


def mis_balance(pdf_a, pdf_b):
    return (pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-12)).detach()


def shadow_distance(dist, cos_l, eps=1e-3):
    return dist - eps / torch.clamp(torch.abs(cos_l), 0.02, 1.0)


def nee_contribution(scene, mat, p, ns, wo, state, occluded_fn, used):
    """(rgb [N, 3], state): one light sample's MIS-weighted direct light;
    occluded_fn(ro, rd, dist) -> bool [N]."""
    num_lights = scene["num_lights"]
    if num_lights == 0:
        return torch.zeros_like(p), state
    u_pick, state = next_1d(state)
    u_a, u_b, state = next_2d(state)
    u_c, state = next_1d(state)
    lidx = torch.clamp((u_pick * num_lights).to(torch.int32), max=num_lights - 1)
    ls = sample_light(scene, lidx, p, u_c, (u_a, u_b))
    pdf_select = 1.0 / num_lights
    wi = ls["dir"]
    n_or = bsdf.orient_normal(ns, wo)
    cos_s = vm.dot(n_or, wi, keepdims=False)
    f, pdf_b = bsdf.eval_bsdf_pdf(mat, ns, wo, wi, used)
    cos_l = vm.dot(ls["nml"], -wi, keepdims=False)
    dist2 = torch.clamp(ls["dist"] * ls["dist"], min=1e-8)
    pdf_light = ls["pdf"] * pdf_select
    pdf_light_c = torch.clamp(pdf_light, min=1e-12)[..., None]
    pdf_b_area = pdf_b * torch.abs(cos_l) / dist2
    w_area = mis_balance(pdf_light, pdf_b_area * 1.0)
    c_area = (f * ls["le"]
              * (torch.clamp(cos_s, min=0.0) * torch.clamp(cos_l, min=0.0) / dist2)[..., None]
              / pdf_light_c * w_area[..., None])
    w_solid = mis_balance(pdf_light, pdf_b)
    c_solid = (f * ls["le"] * torch.clamp(cos_s, min=0.0)[..., None] / pdf_light_c
               * w_solid[..., None])
    contrib = torch.where(ls["area_measure"][..., None], c_area, c_solid)
    facing = (cos_s > 0.0) & (ls["infinite"] | (cos_l > 0.0))
    ro_sh = p + n_or * 1e-3
    dist_sh = torch.where(ls["infinite"], ls["dist"], shadow_distance(ls["dist"], cos_l))
    occ = occluded_fn(ro_sh, wi, dist_sh).to(ftype())
    vis = torch.where(facing, 1.0 - occ, 0.0)
    return contrib * vis[..., None], state


def implicit_light_weight(scene, hit_light_id, pdf_prev, prev_singular, t_dist, cos_l):
    num_lights = max(scene["num_lights"], 1)
    lights = scene["lights"]
    li = torch.clamp(hit_light_id, 0, lights["type"].shape[0] - 1).long()
    pdf_area = 1.0 / torch.clamp(lights["area"][li], min=1e-12)
    dist2 = torch.clamp(t_dist * t_dist, min=1e-8)
    pdf_light_solid = pdf_area * dist2 / torch.clamp(torch.abs(cos_l), min=1e-6)
    w = mis_balance(pdf_prev, pdf_light_solid / num_lights)
    return torch.where(prev_singular, 1.0, w)


def env_miss_weight(scene, rd, pdf_prev, prev_singular):
    num_lights = max(scene["num_lights"], 1)
    w = mis_balance(pdf_prev, pdf_env(scene, rd) / num_lights)
    return torch.where(prev_singular, 1.0, w)
