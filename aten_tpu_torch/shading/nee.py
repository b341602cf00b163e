"""Next-event estimation and multiple importance sampling.

Counterpart of aten_tpu/shading/nee.py: the reference's SampleLight /
FillShadowRay, ComputeRadianceNEE, HitImplicitLight and the envmap's MIS
weight on a miss (ShadeMiss).  The light pick is uniform (1/N) as in the
reference.  An image-based light sample is in solid-angle measure and
lies at distance 1e30, so its shadow ray runs to 1e30.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.core import sampler as smp
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.envmap import pdf_env
from aten_tpu_torch.scene.lights import sample_light
from aten_tpu_torch.shading import brdf as brdf_mod
from aten_tpu_torch.shading import dispatch as disp_mod
from aten_tpu_torch.utils import spans


def mis_balance(pdf_a, pdf_b):
    """Balance heuristic (the reference detaches it under AD)."""
    return (pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-12)).detach()


def shadow_distance(dist, cos_l, eps=1e-3):
    """Shadow-ray length that never re-hits the target light itself: the
    1e-3 normal offset at the shading point can cross the emitter's plane
    up to eps/cos_l early (reference nee.py:125-139)."""
    return dist - eps / torch.clamp(torch.abs(cos_l), 0.02, 1.0)


def nee_contribution(scene, mat, p, ns, wo, state, occluded_fn, used):
    """Direct-light contribution at a batch of shading points.

    occluded_fn(ro, rd, dist) -> [N] occlusion: a bool (the binary shadow
    traversal) or a float in [0, 1] (accel/traverse.py::occlusion_alpha).
    Returns (rgb [N,3], new sampler state).  Recorded as the "nee" span.
    """
    with spans.span("nee"):
        return _nee_contribution(scene, mat, p, ns, wo, state, occluded_fn, used)


def _nee_contribution(scene, mat, p, ns, wo, state, occluded_fn, used):
    num_lights = scene["num_lights"]
    if num_lights == 0:
        return torch.zeros_like(p), state

    u_pick, state = smp.next_1d(state)
    u_a, u_b, state = smp.next_2d(state)
    u_c, state = smp.next_1d(state)

    lidx = torch.clamp((u_pick * num_lights).to(torch.int32), max=num_lights - 1)
    ls = sample_light(scene, lidx, p, u_c, (u_a, u_b))
    pdf_select = 1.0 / num_lights

    wi = ls["dir"]
    n_or = brdf_mod.orient_normal(ns, wo)
    cos_s = vm.dot(n_or, wi, keepdims=False)
    f, pdf_b = disp_mod.eval_bsdf_pdf(scene, mat, ns, wo, wi, used)
    cos_l = vm.dot(ls["nml"], -wi, keepdims=False)

    dist2 = torch.clamp(ls["dist"] * ls["dist"], min=1e-8)
    pdf_light = ls["pdf"] * pdf_select
    pdf_light_c = torch.clamp(pdf_light, min=1e-12)[..., None]
    # area-measure lights: G = cos_l / dist^2, bsdf pdf -> area measure
    pdf_b_area = pdf_b * torch.abs(cos_l) / dist2
    w_area = mis_balance(pdf_light, pdf_b_area * 1.0)
    c_area = (
        f
        * ls["le"]
        * (torch.clamp(cos_s, min=0.0) * torch.clamp(cos_l, min=0.0) / dist2)[..., None]
        / pdf_light_c
        * w_area[..., None]
    )
    # solid-angle measure
    w_solid = mis_balance(pdf_light, pdf_b)
    c_solid = (
        f * ls["le"] * torch.clamp(cos_s, min=0.0)[..., None] / pdf_light_c
        * w_solid[..., None]
    )
    # singular lights: no MIS competition
    c_sing = f * ls["le"] * torch.clamp(cos_s, min=0.0)[..., None] / pdf_light_c

    contrib = torch.where(ls["area_measure"][..., None], c_area, c_solid)
    contrib = torch.where(ls["singular"][..., None], c_sing, contrib)

    facing = (cos_s > 0.0) & (ls["singular"] | ls["infinite"] | (cos_l > 0.0))
    ro_sh = p + n_or * 1e-3
    dist_sh = torch.where(
        ls["infinite"] | ls["singular"],
        ls["dist"],
        shadow_distance(ls["dist"], cos_l),
    )
    occ = occluded_fn(ro_sh, wi, dist_sh).to(torch.float32)
    vis = torch.where(facing, 1.0 - occ, 0.0)
    return contrib * vis[..., None], state


def implicit_light_weight(scene, hit_light_id, pdf_prev, prev_singular, t_dist, cos_l):
    """MIS weight of emitted radiance reached by a BSDF-sampled ray."""
    num_lights = max(scene["num_lights"], 1)
    lights = scene["lights"]
    li = torch.clamp(hit_light_id, 0, lights["type"].shape[0] - 1).long()
    area = lights["area"][li]
    pdf_area = 1.0 / torch.clamp(area, min=1e-12)
    dist2 = torch.clamp(t_dist * t_dist, min=1e-8)
    pdf_light_solid = pdf_area * dist2 / torch.clamp(torch.abs(cos_l), min=1e-6)
    pdf_light_solid = pdf_light_solid / num_lights
    w = mis_balance(pdf_prev, pdf_light_solid)
    return torch.where(prev_singular, 1.0, w)


def env_miss_weight(scene, rd, pdf_prev, prev_singular):
    """MIS weight of envmap radiance reached by a BSDF-sampled ray that
    misses the scene (1 where the scene has no envmap)."""
    if "envmap" not in scene:
        return torch.ones(rd.shape[:-1], dtype=torch.float32, device=rd.device)
    num_lights = max(scene["num_lights"], 1)
    p_env = pdf_env(scene, rd) / num_lights
    w = mis_balance(pdf_prev, p_env)
    return torch.where(prev_singular, 1.0, w)
