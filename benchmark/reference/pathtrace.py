"""The reference path tracer: NEE with MIS and Russian roulette, lane by lane.

A frozen copy of the port's integrator loop (integrator/pathtracer.py's
`_trace_paths` for pinhole cameras and the CMJ sampler) over the
reference's own scene, tree and shading.  Each lane is one (pixel,
sample, frame); its random numbers are seeded by the global pixel id,
the frame and the sample exactly as the program seeds them, so any set
of pixels of any image can be traced on its own and compared with the
same pixels of the program's image.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bsdf, lights
from benchmark.reference import sampler as smp
from benchmark.reference import vecmath as vm
from benchmark.reference.vecmath import ftype, inf
from benchmark.reference.walk import walk


def camera_arrays(cam, device):
    """Pinhole camera {origin, right, up, forward, dist} from the
    description {origin, lookat, up, vfov_deg} and the image size."""
    r, u, f = vm.look_at(cam["origin"], cam["lookat"], cam.get("up", (0.0, 1.0, 0.0)))
    half_h = math.tan(math.radians(cam["vfov_deg"]) * 0.5)
    half_w = cam["width"] / cam["height"] * half_h

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), dtype=ftype(), device=device)

    return {"origin": t(cam["origin"]), "right": t(r * half_w * 2.0),
            "up": t(u * half_h * 2.0), "forward": t(f), "dist": t(1.0)}


def generate_ray(ca, s, t):
    o = ca["origin"]
    p = (o + ca["forward"] * ca["dist"] + (s[..., None] - 0.5) * ca["right"]
         + (t[..., None] - 0.5) * ca["up"])
    rd = vm.normalize(p - o)
    return torch.broadcast_to(o, rd.shape), rd


def gather_material(mats, mtl_id):
    m = torch.clamp(mtl_id, 0, mats["type"].shape[0] - 1).long()
    return {k: v[m] for k, v in mats.items()}


def eval_hit(scene, ro, rd, hit):
    prim = hit["prim"]
    num_tris = scene["num_tris"]
    T, S = scene["tri_v0"].shape[0], scene["sph_center"].shape[0]
    is_tri = prim < num_tris
    tid = torch.clamp(prim, 0, T - 1)
    sid = torch.clamp(prim - num_tris, 0, S - 1)
    t_safe = torch.where(hit["hit"], hit["t"], 1.0)
    p = ro + t_safe[..., None] * rd
    u = hit["u"][..., None]
    v = hit["v"][..., None]
    w = 1.0 - u - v
    n0, n1, n2 = scene["tri_n0"][tid], scene["tri_n1"][tid], scene["tri_n2"][tid]
    e1, e2 = scene["tri_e1"][tid], scene["tri_e2"][tid]
    ns_tri = vm.normalize(w * n0 + u * n1 + v * n2)
    ng_tri = vm.normalize(vm.cross(e1, e2))
    uv_tri = w * scene["tri_uv0"][tid] + u * scene["tri_uv1"][tid] + v * scene["tri_uv2"][tid]
    ns_sph = (p - scene["sph_center"][sid]) / torch.clamp(
        scene["sph_radius"][sid][..., None], min=1e-12)
    m3 = is_tri[..., None]
    return {
        "p": p,
        "ns": torch.where(m3, ns_tri, ns_sph),
        "ng": torch.where(m3, ng_tri, ns_sph),
        "uv": torch.where(m3, uv_tri, 0.5),
        "mtl": torch.where(is_tri, scene["tri_mtl"][tid], scene["sph_mtl"][sid]),
        "light": torch.where(is_tri, scene["tri_light"][tid], -1),
    }


def trace(scene, cam, px, py, frame, sample, spp, max_depth, rr_depth, counts=None):
    """Radiance [N, 3] of lanes (px, py, frame, sample), int64 tensors [N]
    (frame may be an int), on the image `cam` describes.  counts: a dict
    that gains, per bounce, the closest-hit rays ("closest") and the
    shadow rays ("shadow") the lanes trace."""
    dev = px.device
    used = scene["used"]
    width, height = cam["width"], cam["height"]
    ca = camera_arrays(cam, dev)
    n = px.shape[0]
    pixel_seed = smp.wang_hash(py * width + px + 1)
    state = smp.make_state(pixel_seed, frame, sample, spp, bounce=0)
    ju, jv, state = smp.next_2d(state)
    s = (px.to(ftype()) + ju) / width
    t = (float(height - 1) - py.to(ftype()) + jv) / height
    ro, rd = generate_ray(ca, s, t)

    radiance = torch.zeros((n, 3), device=dev)
    throughput = torch.ones((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    pdf_prev = torch.ones((n,), device=dev)
    prev_singular = torch.ones((n,), dtype=torch.bool, device=dev)

    def occluded(o, d, dist):
        res = walk(scene, o.detach(), d.detach(), (dist - 1e-3).detach(), 1e-3, any_hit=True)
        if counts is not None:
            counts.setdefault("shadow", []).append(int((dist > 1e-3).sum()))
        return res["hit"] & (dist > 1e-3)

    for bounce in range(max_depth):
        if counts is not None:
            counts.setdefault("closest", []).append(int(alive.sum()))
        t_max = torch.where(alive, inf(), 0.0).detach()
        hit = walk(scene, ro.detach(), rd.detach(), t_max, 1e-4)
        h = eval_hit(scene, ro, rd, hit)
        mat = gather_material(scene["materials"], h["mtl"])
        if bsdf.CAR_PAINT in used:
            mat = bsdf.carpaint_flake_fields(mat, h["uv"], h["ns"])

        miss = alive & ~hit["hit"]
        le_bg, w_bg = scene["bg"], 1.0
        if "envmap" in scene:
            le_bg = lights.eval_env(scene, rd)
            w_bg = lights.env_miss_weight(scene, rd, pdf_prev, prev_singular)[..., None]
        radiance = radiance + torch.where(miss[..., None], throughput * le_bg * w_bg, 0.0)

        state = smp.make_state(pixel_seed, frame, sample, spp, bounce=bounce + 1)

        is_emis = mat["type"] == bsdf.EMISSIVE
        cos_l = vm.dot(h["ng"], -rd, keepdims=False)
        hit_emit = alive & hit["hit"] & is_emis
        w_imp = lights.implicit_light_weight(scene, h["light"], pdf_prev, prev_singular,
                                             hit["t"], cos_l)
        w_imp = torch.where(h["light"] >= 0, w_imp, 1.0)
        radiance = radiance + torch.where((hit_emit & (cos_l > 0.0))[..., None],
                                          throughput * mat["base_color"] * w_imp[..., None], 0.0)
        alive = alive & hit["hit"] & ~is_emis

        wo = -rd
        contrib, state = lights.nee_contribution(
            scene, mat, h["p"], h["ns"], wo, state,
            lambda o, d, dist, a=alive: occluded(o, d, torch.where(a, dist, 0.0)), used)
        singular = (mat["type"] == bsdf.SPECULAR) | (mat["type"] == bsdf.REFRACTION)
        radiance = radiance + torch.where((alive & ~singular)[..., None], throughput * contrib,
                                          0.0)

        u_rr, state = smp.next_1d(state)
        if bounce >= rr_depth:
            rr_p = torch.clamp(torch.amax(throughput, dim=-1), 0.01, 0.95).detach()
        else:
            rr_p = torch.ones_like(u_rr)
        alive = alive & (u_rr < rr_p)
        throughput = throughput / rr_p[..., None]

        u1, u2, state = smp.next_2d(state)
        u3, state = smp.next_1d(state)
        samp = bsdf.sample_brdf(mat, h["ns"], wo, u1, u2, u3, used)
        n_or = bsdf.orient_normal(h["ns"], wo)
        cos_wi = torch.abs(vm.dot(n_or, samp["wi"], keepdims=False))
        good = (samp["pdf"] > 1e-9) & (cos_wi > 1e-9)
        pdf_det = torch.clamp(samp["pdf"], min=1e-9).detach()
        weight = samp["bsdf"] * (cos_wi / pdf_det)[..., None]
        throughput = torch.where((alive & good)[..., None], throughput * weight, throughput)
        alive = alive & good
        off_n = torch.where(samp["transmission"][..., None], -n_or, n_or)
        ro = (h["p"] + off_n * 1e-3).detach()
        rd = samp["wi"].detach()
        pdf_prev = samp["pdf"]
        prev_singular = samp["singular"]

    bad = ~torch.all(torch.isfinite(radiance), dim=-1) | torch.any(radiance < 0, dim=-1)
    return torch.where(bad[..., None], 0.0, radiance)


def render_pixels(scene, cam, pix, frames, spp, max_depth, rr_depth, lanes=1 << 20,
                  counts=None):
    """Mean radiance [M, 3] over spp samples of pixels `pix` (flat ids,
    int64 [M]) of images `frames` (int64 [M]), in batches of at most
    `lanes` lanes."""
    dev = pix.device
    out = []
    per = max(1, lanes // spp)
    for a in range(0, pix.shape[0], per):
        p = pix[a:a + per].repeat(spp)
        f = frames[a:a + per].repeat(spp)
        s = torch.arange(spp, device=dev).repeat_interleave(pix[a:a + per].shape[0])
        rad = trace(scene, cam, p % cam["width"], p // cam["width"], f, s, spp, max_depth,
                    rr_depth, counts)
        out.append(rad.reshape(spp, -1, 3).sum(dim=0) / spp)
    return torch.cat(out)
