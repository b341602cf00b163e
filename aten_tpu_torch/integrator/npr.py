"""NPR: toon shading and feature lines.

Counterpart of aten_tpu/integrator/npr.py (the reference's toon BRDF with
remap bands, highlight and rim, toon.h and material.h:124-161, and its
feature lines, renderer/npr/feature_line.h:36-160 and
npr/npr_pathtracer.h:8).  `render_npr` takes the first-hit G-buffer of
`render_sample_with_aovs` (spp 1, depth 2, RR 1, as the reference),
shades it with a quantized ramp, highlight and rim under light 0 (whose
shadow ray is an any-hit walk), and darkens the screen-space feature
lines (mesh id, crease, silhouette and albedo discontinuities over the
four neighbours).  `feature_lines_sample_rays` is the sample-ray
formulation: around each pixel's query ray, `num_samples` rays through a
pixel disc, each compared with the query hit; one closest-hit walk for
the query rays and one per sample ring.

Thresholds turn an ulp into a visible step (a band of 1/bands, a
highlight of highlight_gain, a line), so a pixel here and there may
differ from the reference by one; tests/test_torch_npr.py says how many.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aten_tpu_torch.accel.traverse import occluded, traverse
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.core.camera import generate_ray
from aten_tpu_torch.denoise.svgf import _shift
from aten_tpu_torch.integrator.pathtracer import eval_hit, render_sample_with_aovs
from aten_tpu_torch.scene import textures as tex_mod
from aten_tpu_torch.scene.lights import sample_light
from aten_tpu_torch.scene.materials import gather_material


@dataclasses.dataclass(frozen=True)
class ToonParams:
    bands: int = 3            # quantization steps of the diffuse ramp
    shadow_floor: float = 0.25  # stylized shadow brightness
    highlight_power: float = 32.0
    highlight_gain: float = 0.9
    highlight_translation: float = 0.0  # ToonParameter highlight controls
    rim_power: float = 4.0
    rim_gain: float = 0.25
    line_width: int = 1
    depth_threshold: float = 0.03
    normal_threshold: float = 0.65


def toon_shade(scene, aovs, cam_origin, params: ToonParams, impl="auto"):
    """Quantized-ramp direct light, highlight and rim from the G-buffer,
    [H, W, 3], under light 0 (the key light, as the reference's toon
    binds one target light)."""
    H, W = aovs["depth"].shape
    p = aovs["pos"].reshape(-1, 3)
    n = aovs["normal"].reshape(-1, 3)
    alb = aovs["albedo"].reshape(-1, 3)
    hitm = (aovs["depth"] > 0).reshape(-1)
    N = p.shape[0]

    lidx = torch.zeros((N,), dtype=torch.int32, device=p.device)
    u0 = torch.full((N,), 0.5, dtype=torch.float32, device=p.device)
    ls = sample_light(scene, lidx, p, u0, (u0, u0))
    wi = ls["dir"]
    blocked = occluded(scene, p + n * 1e-3, wi, ls["dist"], impl=impl)

    ndl = torch.clamp(vm.dot(n, wi, keepdims=False), 0.0, 1.0)
    ndl = torch.where(blocked, 0.0, ndl)
    # ramp quantization with a stylized shadow floor
    band = torch.ceil(ndl * params.bands) / params.bands
    ramp = params.shadow_floor + (1.0 - params.shadow_floor) * band

    wo = vm.normalize(cam_origin[None, :] - p)
    h = vm.normalize(wi + wo)
    spec = torch.clamp(vm.dot(n, h, keepdims=False) + params.highlight_translation,
                       0.0, 1.0) ** params.highlight_power
    spec = torch.where(spec > 0.5, params.highlight_gain, 0.0)
    spec = torch.where(blocked, 0.0, spec)

    rim = (1.0 - torch.clamp(vm.dot(n, wo, keepdims=False), 0.0, 1.0)) ** params.rim_power
    shade = alb * ramp[..., None] + (spec + params.rim_gain * rim)[..., None]
    shade = torch.where(hitm[..., None], shade, scene["bg"])
    return shade.reshape(H, W, 3)


def feature_lines(aovs, params: ToonParams):
    """Screen-space feature-line mask [H, W] in {0, 1} (1 = line): mesh
    id (material), crease (normal), silhouette (tangent-plane distance)
    and albedo edges against the four neighbours."""
    depth = aovs["depth"]
    normal = aovs["normal"]
    prim = aovs["mtl"]
    alb = aovs["albedo"]
    pos = aovs["pos"]
    line = torch.zeros_like(depth, dtype=torch.bool)
    r = params.line_width
    for dy, dx in ((0, r), (r, 0), (0, -r), (-r, 0)):
        p_q = _shift(pos, dy, dx)
        n_q = _shift(normal, dy, dx)
        m_q = _shift(prim, dy, dx)
        a_q = _shift(alb, dy, dx)
        # silhouette: the neighbour's position off the local tangent plane
        plane_d = torch.abs(torch.sum((p_q - pos) * normal, dim=-1))
        depth_edge = plane_d > params.depth_threshold * torch.clamp(depth, min=1e-3)
        normal_edge = torch.sum(n_q * normal, dim=-1) < params.normal_threshold
        id_edge = m_q != prim
        albedo_edge = torch.abs(a_q - alb).sum(-1) > 0.4
        line = line | depth_edge | normal_edge | id_edge | albedo_edge
    return line.to(torch.float32)


def feature_lines_sample_rays(scene, cam_arrays, width, height, frame, params: ToonParams = None,
                              num_samples=8, disc_radius_px=1.0, impl="auto"):
    """Sample-ray feature lines [H, W] in {0, 1}: around each query ray,
    `num_samples` rays through a pixel-space disc, their hits compared
    with the query's (mesh id, tangent-plane depth, normal, albedo, and
    hit against miss).  1 + num_samples closest-hit walks."""
    params = params or ToonParams()
    dev = scene.device
    N = width * height
    lpix = torch.arange(N, dtype=torch.int64, device=dev)
    px = (lpix % width).to(torch.float32)
    py = (lpix // width).to(torch.float32)

    def attrs_for(s, t):
        ro, rd = generate_ray(cam_arrays, s, t)
        hit = traverse(scene, ro, rd, impl=impl)
        h = eval_hit(scene, ro, rd, hit)
        mat = gather_material(scene["materials"], h["mtl"])
        mat = tex_mod.apply_albedo(scene, mat, h["uv"])
        return {"hit": hit["hit"], "p": h["p"], "ns": h["ns"], "mtl": h["mtl"],
                "alb": mat["base_color"], "depth": torch.where(hit["hit"], hit["t"], -1.0)}

    s0 = (px + 0.5) / width
    t0 = (float(height - 1) - py + 0.5) / height
    q = attrs_for(s0, t0)

    line = torch.zeros((N,), dtype=torch.bool, device=dev)
    for k in range(num_samples):
        ang = 2.0 * np.pi * (k + 0.5) / num_samples
        # radii over the disc
        rad = disc_radius_px * np.sqrt((k % 4 + 1) / 4.0)
        dx = float(np.float32(rad * np.cos(ang) / width))
        dy = float(np.float32(rad * np.sin(ang) / height))
        sm = attrs_for(s0 + dx, t0 + dy)
        both = q["hit"] & sm["hit"]
        plane_d = torch.abs(vm.dot(sm["p"] - q["p"], q["ns"], keepdims=False))
        depth_edge = both & (plane_d > params.depth_threshold * torch.clamp(q["depth"], min=1e-3))
        normal_edge = both & (vm.dot(sm["ns"], q["ns"], keepdims=False) < params.normal_threshold)
        id_edge = both & (sm["mtl"] != q["mtl"])
        albedo_edge = both & (torch.abs(sm["alb"] - q["alb"]).sum(-1) > 0.4)
        sil_edge = q["hit"] != sm["hit"]  # object silhouette against the background
        line = line | depth_edge | normal_edge | id_edge | albedo_edge | sil_edge
    return line.to(torch.float32).reshape(height, width)


def _npr_frame(scene, cam_arrays, width, height, frame, cam_origin, params: ToonParams,
               impl="auto"):
    """(the toon image with its feature lines darkened [H, W, 3], the
    G-buffer)."""
    _, aovs = render_sample_with_aovs(scene, cam_arrays, width, height, frame, 0, 1, 2, 1,
                                      impl=impl)
    shade = toon_shade(scene, aovs, cam_origin, params, impl=impl)
    lines = feature_lines(aovs, params)
    return shade * (1.0 - lines[..., None]), aovs


def render_npr(scene, cam, params: ToonParams = None, frame=0, impl="auto"):
    """The NprPathTracer's image [H, W, 3]: toon shade and feature lines."""
    params = params or ToonParams()
    origin = torch.tensor(cam.origin, dtype=torch.float32, device=scene.device)
    img, _ = _npr_frame(scene, cam.arrays(scene.device), cam.width, cam.height, frame, origin,
                       params, impl=impl)
    return img
