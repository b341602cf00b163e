"""Toon and StylizedBrdf materials: the toon term of a path's first hit.

Counterpart of aten_tpu/shading/toon.py (the reference's Toon::bsdf,
ComputeRimLight, ToonSpecular's stylized half vector and StylizedBrdf's
GI-aware remap).  A toon material is shaded as a light: one NEE sample
toward the material's own target light (`toon_target_light`), through
a diffuse or stylized-highlight GGX lobe, whose radiance is then remapped
by the material's 1-D remap texture (plain Toon: the gamma'd luminance
picks a band; StylizedBrdf: the luminance between y_min and y_max picks
a colour, weighted back by the NEE pdf), plus an additive rim term.  The
path tracer adds it at bounce 0 and ends the path (integrator/
pathtracer.py).  Everything is batched masked math over lanes, as in
the reference.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.core import sampler as smp
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.lights import sample_light
from aten_tpu_torch.scene.textures import sample_texture
from aten_tpu_torch.shading import brdf as brdf_mod
from aten_tpu_torch.shading.nee import shadow_distance


def stylized_half(mat, n, v, l):
    """The stylized highlight's half vector: the half vector of v and l
    translated, scaled, split and squared in the tangent frame of n."""
    h = vm.normalize(l + v)
    t, b = vm.onb(n)
    h = vm.normalize(h + mat["toon_hl_translation_t"][..., None] * t
                     + mat["toon_hl_translation_b"][..., None] * b)
    sc_t = mat["toon_hl_scale_t"][..., None]
    sc_b = mat["toon_hl_scale_b"][..., None]
    h = vm.normalize(h - sc_t * vm.dot(h, t) * t - sc_b * vm.dot(h, b) * b)
    sp_t = mat["toon_hl_split_t"][..., None]
    sp_b = mat["toon_hl_split_b"][..., None]
    h = vm.normalize(h - sp_t * torch.sign(vm.dot(h, t)) * t
                     - sp_b * torch.sign(vm.dot(h, b)) * b)
    sharp = torch.clamp(mat["toon_hl_square_sharp"][..., None], min=1e-6)
    mag = mat["toon_hl_square_magnitude"][..., None]
    ht = torch.clamp(vm.dot(h, t), -1.0, 1.0)
    hb = torch.clamp(vm.dot(h, b), -1.0, 1.0)
    sq_t = torch.sin(torch.pow(torch.acos(ht), sharp))
    sq_b = torch.sin(torch.pow(torch.acos(hb), sharp))
    return vm.normalize(h - mag * (sq_t * ht * t + sq_b * hb * b))


def toon_specular_eval(mat, n, wo, wi):
    """GGX evaluated at the stylized half vector: (bsdf [N,3], pdf [N])."""
    h = stylized_half(mat, n, wo, wi)
    a = torch.clamp(mat["roughness"], min=1e-3)
    nh = torch.clamp(vm.dot(n, h, keepdims=False), 0.0, 1.0)
    nv = torch.clamp(vm.dot(n, wo, keepdims=False), 1e-6, 1.0)
    nl = torch.clamp(vm.dot(n, wi, keepdims=False), 0.0, 1.0)
    vh = torch.clamp(vm.dot(wo, h, keepdims=False), 1e-6, 1.0)
    d = brdf_mod._ggx_d(nh, a)
    g = brdf_mod._ggx_g1(nv, a) * brdf_mod._ggx_g1(nl, a)
    f0 = vm.ipow((mat["ior"] - 1.0) / (mat["ior"] + 1.0), 2)
    f = f0 + (1.0 - f0) * vm.ipow(1.0 - vh, 5)
    spec = (d * g * f / torch.clamp(4.0 * nv * nl, min=1e-8))[..., None]
    bsdf = spec * torch.ones_like(mat["base_color"])
    pdf = d * nh / torch.clamp(4.0 * vh, min=1e-8)
    return bsdf, pdf


def _bezier_smoothstep(edge0, edge1, mid, t, s):
    """Smoothstep shaped by a quadratic Bezier with control point `mid`."""
    tt = torch.clamp((t - edge0) / torch.clamp(edge1 - edge0, min=1e-6), 0.0, 1.0)
    tt = tt * s
    p = (1.0 - 2.0 * mid) * tt * tt + 2.0 * mid * tt
    return torch.where(t <= edge0, 0.0, torch.where(t >= edge1, 1.0, p))


def rim_light(mat, n, rd):
    """The additive rim term [N,3], strongest where the view grazes n."""
    ndv = vm.dot(n, -rd, keepdims=False)
    rim = _bezier_smoothstep(
        1.0 - mat["toon_rim_width"], 1.0, (1.0 - mat["toon_rim_softness"]) * 0.5,
        1.0 - ndv, mat["toon_rim_spread"])
    rim = torch.where(ndv > 0.0, rim, 0.0)
    on = (mat["toon_rim_enable"] > 0).to(torch.float32)
    return (rim * on)[..., None] * mat["toon_rim_color"]


def _sample_remap(scene, tex_id, u, default):
    """The 1-D remap texture at (u, 0.5); `default` where tex_id < 0."""
    if "tex_stack" not in scene:
        return default
    val = sample_texture(scene, tex_id, u, torch.full_like(u, 0.5))[..., :3]
    return torch.where((tex_id >= 0)[..., None], val, default)


def toon_term(scene, mat, p, ns, rd, state, occluded_fn, stylized=None):
    """The toon contribution at hit points p with shading normals ns,
    reached along rd: (rgb [N,3], state).

    mat: the lanes' material rows (after the texture maps).  Draws
    next_2d, then next_1d, from every lane's state.  occluded_fn(ro, rd,
    dist) -> [N] occlusion (bool, or a float in [0, 1] in an alpha scene)
    tests the shadow ray toward the target light.
    stylized: bool [N], the StylizedBrdf lanes (default none).
    """
    n = brdf_mod.orient_normal(ns, -rd)
    wo = -rd

    tl = mat["toon_target_light"]
    has_light = tl >= 0
    u_a, u_b, state = smp.next_2d(state)
    u_c, state = smp.next_1d(state)
    ls = sample_light(scene, torch.clamp(tl, min=0), p, u_c, (u_a, u_b))

    wi = ls["dir"]
    cos_s = vm.dot(n, wi, keepdims=False)
    cos_l = vm.dot(ls["nml"], -wi, keepdims=False)

    # the base lobe: diffuse, or the stylized-highlight GGX
    f_dif = mat["base_color"] / brdf_mod.PI
    pdf_dif = torch.clamp(cos_s, min=0.0) / brdf_mod.PI
    f_spec, pdf_spec = toon_specular_eval(mat, n, wo, wi)
    spec_sel = mat["toon_type"] > 0
    f = torch.where(spec_sel[..., None], f_spec, f_dif)
    path_pdf = torch.where(spec_sel, pdf_spec, pdf_dif)

    # one NEE sample with light-select probability 1
    dist2 = torch.clamp(ls["dist"] * ls["dist"], min=1e-8)
    inf_or_sing = ls["infinite"] | ls["singular"]
    dist2 = torch.where(inf_or_sing, 1.0, dist2)
    path_pdf_area = torch.where(ls["infinite"], path_pdf, path_pdf * torch.abs(cos_l) / dist2)
    mis_w = torch.where(
        ls["singular"], 1.0,
        ls["pdf"] / torch.clamp(ls["pdf"] + path_pdf_area, min=1e-12))
    g = torch.clamp(cos_s, min=0.0) * torch.clamp(cos_l, min=0.0) / dist2
    lpdf = torch.clamp(ls["pdf"], min=1e-12)
    radiance = f * ls["le"] * (mis_w * g / lpdf)[..., None]

    # the shadow ray toward the target light (toon_receive_shadow)
    dist_sh = torch.where(inf_or_sing, ls["dist"], shadow_distance(ls["dist"], cos_l))
    occ = occluded_fn(p + n * 1e-3, wi, dist_sh).to(torch.float32)
    vis = torch.where(mat["toon_receive_shadow"] > 0, 1.0 - occ, 1.0)
    lit = has_light & (cos_s >= 0.0) & (cos_l >= 0.0)
    radiance = torch.where((lit & (vis > 0.0))[..., None], radiance * vis[..., None], 0.0)

    # plain Toon: the gamma'd luminance picks a band of the remap
    lum = torch.clamp(vm.luminance(radiance)[..., 0], 0.0, 1.0)
    lum = torch.clamp(torch.pow(lum, 1.0 / 2.2), 0.0, 1.0)
    toon_rgb = _sample_remap(scene, mat["toon_remap_tex"], lum,
                             torch.ones_like(radiance)) * mat["base_color"]

    # StylizedBrdf: the GI-aware remap, weighted back by the NEE pdf
    y = (0.212639 * radiance[..., 0] + 0.715169 * radiance[..., 1]
         + 0.072192 * radiance[..., 2])
    weight = torch.clamp(y, min=0.01)
    y_min = torch.minimum(mat["toon_stylized_y_min"], mat["toon_stylized_y_max"])
    y_max = torch.maximum(mat["toon_stylized_y_min"], mat["toon_stylized_y_max"])
    remap_v = torch.clamp((y - y_min) / torch.clamp(y_max - y_min, min=1e-6), 0.0, 1.0)
    sty_remap = _sample_remap(scene, mat["toon_remap_tex"], remap_v, radiance)
    sty_pdf = lpdf / torch.clamp(mis_w, min=1e-6)
    sty_rgb = weight[..., None] * sty_remap * sty_pdf[..., None]

    if stylized is None:
        stylized = torch.zeros_like(has_light)
    out = torch.where(stylized[..., None], sty_rgb, toon_rgb)
    out = torch.where(has_light[..., None], out, 0.0)
    return out + rim_light(mat, n, rd), state
