"""BSDF sampling and evaluation, batched over shading points.

Counterpart of aten_tpu/shading/brdf.py: DIFFUSE, OREN_NAYAR, SPECULAR,
REFRACTION, GGX, BECKMANN, MICROFACET_REFRACTION, VELVET, RETROREFLECTIVE,
CAR_PAINT and DISNEY (plus EMISSIVE, which has no lobe).  TOON and
STYLIZED_BRDF lanes take the diffuse lobe here, as in the reference: the
path tracer ends them at their toon term (shading/toon.py) before they
scatter.  As in the reference, every family present in the scene is
evaluated on the whole batch and the per-lane material type selects the
result; the static used-type set prunes absent families (`_need`), and
`used=None` evaluates every family, as the reference's default does.  A
type id that is no MaterialType raises NotImplementedError.
`eval_bsdf` and `eval_pdf` are the two halves of `eval_bsdf_pdf`.

Conventions: `wo` points away from the surface toward the viewer, `wi`
toward the next vertex; `ns` is the shading normal as stored.  Singular
models report pdf 1 and f with f * |cos| equal to the throughput weight.
Integer powers go through `vm.ipow`, the multiplication chain JAX lowers
`x ** k` to.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.utils.flakes import flake_density, flakes_gen

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))

_EMISSIVE = int(MaterialType.EMISSIVE)
_SPECULAR = int(MaterialType.SPECULAR)
_REFRACTION = int(MaterialType.REFRACTION)
_GGX = int(MaterialType.GGX)
_MICROFACET_REFRACTION = int(MaterialType.MICROFACET_REFRACTION)

PORTED_TYPES = frozenset(int(t) for t in MaterialType)


def check_used_types(used):
    """Raise for a used-type set the port cannot shade (None: every
    family, as in the reference)."""
    if used is None:
        return
    missing = sorted(set(int(t) for t in used) - PORTED_TYPES)
    if missing:
        raise NotImplementedError(f"material type ids the port does not know: {missing}")


def _need(used, *types):
    """Static dispatch pruning by the scene's used-material-type set
    (None: every family)."""
    return used is None or any(int(t) in used for t in types)


def orient_normal(ns, wo):
    """Flip normal to the side of wo."""
    s = torch.sign(vm.dot(ns, wo))
    s = torch.where(s == 0.0, 1.0, s)
    return ns * s


def fresnel_schlick(cos_i, f0):
    c = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return f0 + (1.0 - f0) * vm.ipow(c, 5)


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = vm.ipow(eta_i / eta_t, 2) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(
        eta_i * cos_i + eta_t * cos_t, min=1e-12)
    rp = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(
        eta_t * cos_i + eta_i * cos_t, min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin2_t >= 1.0, 1.0, f)  # TIR


def _cos_hemisphere_sample(n, u1, u2):
    """Cosine-weighted hemisphere about n. Returns (wi, pdf)."""
    r = torch.sqrt(torch.clamp(u1, 1e-8, 1.0))
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, 1e-8, 1.0))
    local = torch.stack([x, y, z], dim=-1)
    wi = vm.normalize(vm.to_world(local, n))
    pdf = torch.clamp(vm.dot(wi, n, keepdims=False), min=1e-6) / PI
    return wi, pdf


def _reflect_about(wo, h):
    return vm.normalize(2.0 * vm.dot(wo, h) * h - wo)


# --- microfacet NDFs: GGX and Beckmann ---------------------------------------


def _ggx_alpha(mat):
    return torch.clamp(vm.ipow(mat["roughness"], 2), min=1e-3)


def _ggx_d(nh, a):
    d = nh * nh * (a * a - 1.0) + 1.0
    return a * a / torch.clamp(PI * d * d, min=1e-12)


def _ggx_g1(nv, a):
    nv = torch.clamp(nv, min=1e-6)
    return 2.0 * nv / torch.clamp(
        nv + torch.sqrt(a * a + (1.0 - a * a) * nv * nv), min=1e-12)


def _beckmann_d(nh, a):
    nh = torch.clamp(nh, min=1e-6)
    nh2 = nh * nh
    t2 = (1.0 - nh2) / nh2
    return torch.exp(-t2 / torch.clamp(a * a, min=1e-12)) / torch.clamp(
        PI * a * a * nh2 * nh2, min=1e-12)


def _beckmann_g1(nv, a):
    nv = torch.clamp(nv, 1e-6, 1.0)
    tan_v = torch.sqrt(torch.clamp(1.0 - nv * nv, min=0.0)) / nv
    c = 1.0 / torch.clamp(a * tan_v, min=1e-12)
    c2 = c * c
    poly = (3.535 * c + 2.181 * c2) / (1.0 + 2.276 * c + 2.577 * c2)
    return torch.where(c < 1.6, poly, torch.ones_like(c))


def _microfacet_f0(mat):
    ior = mat["ior"]
    r = (ior - 1.0) / torch.clamp(ior + 1.0, min=1e-6)
    return r * r


def _microfacet_eval(mat, n, wo, wi, kind="ggx"):
    """Cook-Torrance: (f [N,3], pdf [N]).  kind: "ggx" or "beckmann"."""
    a = _ggx_alpha(mat)
    h = vm.normalize(wo + wi)
    nh = torch.clamp(vm.dot(n, h, keepdims=False), 0.0, 1.0)
    nv = vm.dot(n, wo, keepdims=False)
    nl = vm.dot(n, wi, keepdims=False)
    vh = torch.clamp(vm.dot(wo, h, keepdims=False), 0.0, 1.0)
    if kind == "ggx":
        d = _ggx_d(nh, a)
        g = _ggx_g1(nv, a) * _ggx_g1(nl, a)
    else:
        d = _beckmann_d(nh, a)
        g = _beckmann_g1(nv, a) * _beckmann_g1(nl, a)
    f = fresnel_schlick(vh, _microfacet_f0(mat))
    spec = d * g * f / torch.clamp(4.0 * nv * nl, min=1e-6)
    valid = (nv > 0.0) & (nl > 0.0)
    fr = torch.where(valid[..., None], spec[..., None] * mat["base_color"], 0.0)
    pdf = torch.where(valid, d * nh / torch.clamp(4.0 * vh, min=1e-6), 0.0)
    return fr, pdf


def _microfacet_sample_h(mat, n, u1, u2, kind="ggx"):
    a = _ggx_alpha(mat)
    u1 = torch.clamp(u1, 1e-7, 1.0 - 1e-7)
    if kind == "ggx":
        tan2 = a * a * u1 / (1.0 - u1)
    else:
        tan2 = -(a * a) * torch.log(torch.clamp(1.0 - u1, min=1e-7))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    local = torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    return vm.normalize(vm.to_world(local, n))


# --- Oren-Nayar and velvet (cosine-sampled) -----------------------------------


def _oren_nayar_eval(mat, n, wo, wi):
    sig = mat["roughness"]
    s2 = sig * sig
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    ci = torch.clamp(vm.dot(n, wi, keepdims=False), 0.0, 1.0)
    co = torch.clamp(vm.dot(n, wo, keepdims=False), 0.0, 1.0)
    si = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    so = torch.sqrt(torch.clamp(1.0 - co * co, min=0.0))
    # cos(phi_i - phi_o) from the tangent-plane projections
    ti = wi - n * ci[..., None]
    to = wo - n * co[..., None]
    denom = torch.clamp(
        vm.length(ti, keepdims=False) * vm.length(to, keepdims=False), min=1e-8)
    cos_dphi = torch.clamp(vm.dot(ti, to, keepdims=False) / denom, 0.0, 1.0)
    sin_a = torch.maximum(si, so)
    tan_b = torch.minimum(si, so) / torch.clamp(torch.maximum(ci, co), min=1e-6)
    f = (A + B * cos_dphi * sin_a * tan_b)[..., None] * mat["base_color"] / PI
    return torch.where((ci > 0)[..., None] & (co > 0)[..., None], f, 0.0)


def _velvet_eval(mat, n, wo, wi):
    """Inverted-gaussian sheen lobe."""
    a = torch.clamp(mat["roughness"], min=1e-3)
    h = vm.normalize(wo + wi)
    nh = torch.clamp(vm.dot(n, h, keepdims=False), 1e-6, 1.0)
    sin2 = 1.0 - nh * nh
    cot2 = (nh * nh) / torch.clamp(sin2, min=1e-6)
    d = torch.exp(-cot2 / (a * a)) / torch.clamp(PI * a * a * sin2 * sin2, min=1e-6)
    nv = vm.dot(n, wo, keepdims=False)
    nl = vm.dot(n, wi, keepdims=False)
    valid = (nv > 0) & (nl > 0)
    spec = d / torch.clamp(4.0 * (nv + nl - nv * nl), min=1e-6)
    return torch.where(valid[..., None], spec[..., None] * mat["base_color"], 0.0)


# --- Disney principled BRDF (Burley 2012) -------------------------------------


def _schlick_w(c):
    return vm.ipow(torch.clamp(1.0 - c, 0.0, 1.0), 5)


def _gtr1_d(nh, a):
    a = torch.clamp(a, 1e-3, 0.999)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * nh * nh
    denom = PI * torch.log(a2) * t  # negative for a < 1, as the numerator
    return (a2 - 1.0) / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)


def _disney_lobes(mat):
    """Per-lane lobe weights of the sampling mixture."""
    w_diff = 1.0 - mat["metallic"]
    w_spec = torch.ones_like(w_diff)
    w_cc = 0.25 * mat["clearcoat"]
    tot = torch.clamp(w_diff + w_spec + w_cc, min=1e-6)
    return w_diff / tot, w_spec / tot, w_cc / tot


def _clearcoat_alpha(mat):
    a_cc = (1.0 - mat["clearcoat_gloss"]) * 0.1 + mat["clearcoat_gloss"] * 0.001
    return torch.sqrt(torch.clamp(a_cc, 1e-4, 1.0))


def _disney_eval_pdf(mat, n, wo, wi):
    bc = mat["base_color"]
    rough = torch.clamp(mat["roughness"], 0.02, 1.0)
    metallic = mat["metallic"]
    nv = vm.dot(n, wo, keepdims=False)
    nl = vm.dot(n, wi, keepdims=False)
    h = vm.normalize(wo + wi)
    nh = torch.clamp(vm.dot(n, h, keepdims=False), 0.0, 1.0)
    lh = torch.clamp(vm.dot(wi, h, keepdims=False), 0.0, 1.0)
    lum = vm.luminance(bc)[..., 0]
    ctint = bc / torch.clamp(lum, min=1e-4)[..., None]

    # diffuse and subsurface (Burley)
    fl = _schlick_w(nl)
    fv = _schlick_w(nv)
    fd90 = 0.5 + 2.0 * lh * lh * rough
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = lh * lh * rough
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(nl + nv, min=1e-4) - 0.5) + 0.5)
    sub = mat["subsurface"]
    f_diff = bc / PI * torch.where(
        (sub > 0)[..., None], ((1.0 - sub) * fd + sub * ss)[..., None], fd[..., None])
    # sheen
    st = mat["sheen_tint"][..., None]
    csheen = (1.0 - st) + st * ctint
    f_sheen = mat["sheen"][..., None] * csheen * _schlick_w(lh)[..., None]

    # specular GGX
    a = torch.clamp(rough * rough, min=1e-3)
    spt = mat["specular_tint"][..., None]
    cspec0 = mat["specular"][..., None] * 0.08 * ((1.0 - spt) + spt * ctint)
    cspec0 = cspec0 * (1.0 - metallic)[..., None] + bc * metallic[..., None]
    d_spec = _ggx_d(nh, a)
    g_spec = _ggx_g1(nv, a) * _ggx_g1(nl, a)
    f_spec_f = cspec0 + (1.0 - cspec0) * _schlick_w(lh)[..., None]
    f_spec = f_spec_f * (d_spec * g_spec / torch.clamp(4.0 * nv * nl, min=1e-6))[..., None]

    # clearcoat (GTR1, F0 0.04, G alpha 0.25)
    d_cc = _gtr1_d(nh, _clearcoat_alpha(mat))
    f_cc = 0.04 + 0.96 * _schlick_w(lh)
    g_cc = _ggx_g1(nv, 0.25) * _ggx_g1(nl, 0.25)
    f_clear = (0.25 * mat["clearcoat"] * d_cc * f_cc * g_cc
               / torch.clamp(4.0 * nv * nl, min=1e-6))[..., None]

    f = (f_diff + f_sheen) * (1.0 - metallic)[..., None] + f_spec + f_clear
    valid = (nv > 0) & (nl > 0)
    f = torch.where(valid[..., None], f, 0.0)

    # mixture pdf
    w_d, w_s, w_c = _disney_lobes(mat)
    pdf_d = torch.clamp(nl, min=0.0) / PI
    vh = torch.clamp(vm.dot(wo, h, keepdims=False), 1e-6, 1.0)
    pdf_s = d_spec * nh / (4.0 * vh)
    pdf_c = d_cc * nh / (4.0 * vh)
    pdf = w_d * pdf_d + w_s * pdf_s + w_c * pdf_c
    pdf = torch.where(valid, pdf, 0.0)
    return f, pdf


def _disney_sample(mat, n, wo, u1, u2, u3):
    w_d, w_s, _ = _disney_lobes(mat)
    wi_d, _ = _cos_hemisphere_sample(n, u1, u2)
    wi_s = _reflect_about(wo, _microfacet_sample_h(mat, n, u1, u2, "ggx"))
    # clearcoat GTR1 lobe
    a_cc = _clearcoat_alpha(mat)
    a2 = torch.clamp(a_cc * a_cc, 1e-6, 0.999)
    u1c = torch.clamp(u1, 1e-6, 1.0 - 1e-6)
    cos2 = (1.0 - torch.pow(a2, 1.0 - u1c)) / (1.0 - a2)
    cos_t = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos2, 0.0, 1.0))
    phi = TWO_PI * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wi_c = _reflect_about(wo, vm.normalize(vm.to_world(local, n)))

    pick_d = u3 < w_d
    pick_c = u3 >= (w_d + w_s)
    return torch.where(pick_d[..., None], wi_d, torch.where(pick_c[..., None], wi_c, wi_s))


# --- rough dielectric (Walter et al. 2007) ------------------------------------


def _rough_dielectric_eval_pdf(mat, ns, wo, wi):
    """f and pdf of a GGX rough dielectric at any wi (reflection and
    transmission branches)."""
    n = orient_normal(ns, wo)
    entering = vm.dot(ns, wo, keepdims=False) > 0.0
    eta_i = torch.where(entering, 1.0, mat["ior"])
    eta_t = torch.where(entering, mat["ior"], 1.0)
    a = _ggx_alpha(mat)

    nv = torch.clamp(vm.dot(n, wo, keepdims=False), 1e-6, 1.0)
    nl = vm.dot(n, wi, keepdims=False)  # signed: < 0 transmits
    reflecting = nl > 0.0

    h_r = vm.normalize(wo + wi)
    # transmission half-vector (Walter eq. 16), turned to n's side
    h_t = vm.normalize(-(eta_i[..., None] * wo + eta_t[..., None] * wi))
    h_t = h_t * torch.sign(vm.dot(h_t, n))
    h = torch.where(reflecting[..., None], h_r, h_t)

    nh = torch.clamp(vm.dot(n, h, keepdims=False), 0.0, 1.0)
    vh = vm.dot(wo, h, keepdims=False)
    lh = vm.dot(wi, h, keepdims=False)
    d = _ggx_d(nh, a)
    g = _ggx_g1(torch.abs(nv), a) * _ggx_g1(torch.abs(nl), a)
    F = fresnel_dielectric(torch.clamp(torch.abs(vh), 0.0, 1.0), eta_i, eta_t)

    f_r = d * g * F / torch.clamp(4.0 * torch.abs(nv * nl), min=1e-6)
    pdf_r = d * nh / torch.clamp(4.0 * torch.abs(vh), min=1e-6) * F
    # transmission branch (Walter eq. 21)
    denom = eta_i * vh + eta_t * lh
    denom2 = torch.clamp(denom * denom, min=1e-8)
    jac_t = eta_t * eta_t * torch.abs(lh) / denom2
    f_t = (torch.abs(vh * lh) / torch.clamp(torch.abs(nv * nl), min=1e-6)
           * eta_t * eta_t * (1.0 - F) * d * g / denom2)
    pdf_t = d * nh * jac_t * (1.0 - F)

    valid_r = reflecting & (nh > 0)
    valid_t = (~reflecting) & (nh > 0)
    f = torch.where(valid_r, f_r, torch.where(valid_t, f_t, 0.0))
    pdf = torch.where(valid_r, pdf_r, torch.where(valid_t, pdf_t, 0.0))
    return f[..., None] * mat["base_color"], pdf


def _rough_dielectric_sample(mat, ns, wo, u1, u2, u3):
    n = orient_normal(ns, wo)
    entering = vm.dot(ns, wo, keepdims=False) > 0.0
    eta_i = torch.where(entering, 1.0, mat["ior"])
    eta_t = torch.where(entering, mat["ior"], 1.0)
    h = _microfacet_sample_h(mat, n, u1, u2, "ggx")
    vh = torch.clamp(vm.dot(wo, h, keepdims=False), 0.0, 1.0)
    F = fresnel_dielectric(vh, eta_i, eta_t)
    wi_r = _reflect_about(wo, h)
    wt, tir = vm.refract(wo, h * torch.sign(vm.dot(h, wo)), (eta_i / eta_t)[..., None])
    choose_reflect = (u3 < F) | tir
    return torch.where(choose_reflect[..., None], wi_r, wt), ~choose_reflect


# --- retroreflective sheeting --------------------------------------------------
#
# Three components: Beckmann surface reflection, the retroreflection lobe
# about the reversed incident direction scaled by the sheet's effective
# retroreflective area ERA(theta) and a double Fresnel transmission, and
# an energy-compensated diffuse floor.  ERA comes from the corner-cube
# ray count of utils/retroreflective.py, averaged over phi.

_ERA_CACHE = {}


def _era_theta_table(steps=91):
    """(thetas [steps], ERA [steps]) over theta in [0, pi/2], phi-averaged
    (numpy float32, bit for bit the reference's table)."""
    if steps not in _ERA_CACHE:
        from aten_tpu_torch.utils.retroreflective import era

        thetas = np.linspace(0.0, np.pi / 2, steps).astype(np.float32)
        phis = np.linspace(0.0, np.pi, 16, endpoint=False).astype(np.float32)
        tt = np.repeat(thetas, len(phis))
        pp = np.tile(phis, len(thetas))
        vals = np.asarray(era(tt, pp, n_orgs=48)).reshape(steps, len(phis))
        _ERA_CACHE[steps] = (thetas, vals.mean(axis=1).astype(np.float32))
    return _ERA_CACHE[steps]


_ERA_DEVICE = {}


def _era_on(device):
    """The ERA table as a tensor on `device` (once per device)."""
    key = str(device)
    if key not in _ERA_DEVICE:
        _ERA_DEVICE[key] = torch.from_numpy(_era_theta_table()[1]).to(device)
    return _ERA_DEVICE[key]


def _refract_dir(d, n, eta):
    """Refract incident d (pointing into the surface) about n; eta =
    ni/nt per lane."""
    cos_i = -vm.dot(d, n, keepdims=False)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    k = torch.clamp(k, min=0.0)
    ut = eta[..., None] * d + (eta * cos_i - torch.sqrt(k))[..., None] * n
    return vm.normalize(ut)


def _retro_components(mat, n, wo, wi):
    """Component (f, pdf) sums, the normalized lobe weights and (a0, ut).

    The reference's incident direction is -wo here and its scattered
    one wi.  Its ERA lerp gathers both endpoints with one one-hot MXU
    matmul of a staged pair table, a TPU device trick; here they are two
    plain index reads of the table."""
    rough = torch.clamp(mat["roughness"], 0.01, 1.0)
    nt = torch.clamp(mat["ior"], min=1.01)
    ni = 1.0
    f0 = vm.ipow((ni - nt) / (ni + nt), 2)

    nv = vm.dot(n, wo, keepdims=False)
    nl = vm.dot(n, wi, keepdims=False)

    # the refracted mean direction into the prismatic sheet
    ut = _refract_dir(-wo, n, ni / nt)
    cos_t = torch.clamp(vm.dot(ut, -n, keepdims=False), 0.0, 1.0)
    theta = torch.arccos(cos_t)
    th_tab, era_np = _era_theta_table()
    era_tab = _era_on(theta.device)
    steps = era_np.shape[0]
    top = float(np.float32(steps - 1) - np.float32(1e-6))
    pos = torch.clamp(theta / float(th_tab[1] - th_tab[0]), 0.0, top)
    i0 = pos.to(torch.int32)
    fr = pos - i0.to(torch.float32)
    i0 = i0.long()
    E = era_tab[i0] * (1.0 - fr) + era_tab[torch.clamp(i0 + 1, max=steps - 1)] * fr

    # lobe weights
    F_in = fresnel_schlick(torch.clamp(nv, 0.0, 1.0), f0)
    w_sr = F_in
    w_rr = (1.0 - F_in) * E
    w_d = (1.0 - F_in) * (1.0 - E)
    norm = torch.clamp(w_sr + w_rr + w_d, min=1e-8)
    w_sr, w_rr, w_d = w_sr / norm, w_rr / norm, w_d / norm

    # 1) surface reflection: Beckmann microfacet
    f_sr, pdf_sr = _microfacet_eval(mat, n, wo, wi, "beckmann")

    # 2) retroreflection: the NDF about wo with the refraction-Jacobian
    # widened roughness
    nn = nt / ni
    utn = vm.dot(ut, n, keepdims=False)
    j1d = nv + nn * utn
    j2d = -nn * utn + nv
    absnv = torch.abs(nv)
    J1 = torch.where(j1d > 0, absnv / torch.clamp(j1d * j1d, min=1e-12), 0.0)
    J2 = torch.where(j2d > 0, absnv / torch.clamp(j2d * j2d, min=1e-12), 0.0)
    a2 = rough * rough
    a0 = torch.sqrt(
        torch.where(J1 > 0, a2 / torch.clamp(J1, min=1e-12), 0.0)
        + torch.where(J2 > 0, a2 / torch.clamp(J2, min=1e-12), 0.0))
    a0 = torch.clamp(a0, min=1e-3)
    c_retro = torch.clamp(vm.dot(wi, wo, keepdims=False), 0.0, 1.0)
    D = _beckmann_d(c_retro, a0)
    F_rr = (1.0 - fresnel_schlick(torch.clamp(nv, 0.0, 1.0), f0)) * (
        1.0 - fresnel_schlick(torch.clamp(nl, 0.0, 1.0), f0))
    G = _beckmann_g1(torch.abs(vm.dot(-wo, ut, keepdims=False)), rough) * \
        _beckmann_g1(torch.abs(vm.dot(ut, wi, keepdims=False)), rough)
    f_rr = torch.where(
        torch.abs(nl) > 1e-6, E * F_rr * G * D / torch.clamp(torch.abs(nl), min=1e-6), 0.0)
    pdf_rr = D * c_retro

    # 3) diffuse floor with multiple-scattering compensation
    kd = 1.0
    brdf0 = F_rr * (1.0 - E) * vm.ipow(ni / nt, 2) * (kd / PI)
    Fd = (1.0 - f0) * (-160.0 / 21.0)
    f_d = brdf0 / (1.0 - kd * Fd)
    pdf_cos = torch.clamp(nl, min=0.0) / PI
    pdf_d = 1.0 / torch.clamp(1.0 - pdf_cos, min=1e-3)

    valid = (nv > 0) & (nl > 0)
    f = f_sr + torch.where(valid, f_rr + f_d, 0.0)[..., None] * mat["base_color"]
    pdf = w_sr * pdf_sr + torch.where(valid, w_rr * pdf_rr + w_d * pdf_d, 0.0)
    return f, pdf, (w_sr, w_rr, w_d), (a0, ut)


def _retro_eval_pdf(mat, n, wo, wi):
    f, pdf, _, _ = _retro_components(mat, n, wo, wi)
    return f, pdf


def _retro_sample(mat, n, wo, u1, u2, u3):
    """Component pick by the normalized weights: surface reflection
    samples the Beckmann half-vector, retroreflection the widened NDF
    about wo, diffuse the cosine lobe."""
    # the weights depend only on (wo, n): evaluate with wi = wo
    _, _, (w_sr, w_rr, _), (a0, _) = _retro_components(mat, n, wo, wo)
    wi_sr = _reflect_about(wo, _microfacet_sample_h(mat, n, u1, u2, "beckmann"))

    u1c = torch.clamp(u1, 1e-7, 1.0 - 1e-7)
    tan2 = -(a0 * a0) * torch.log(torch.clamp(1.0 - u1c * 0.99, min=1e-7))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wi_rr = vm.normalize(vm.to_world(local, vm.normalize(wo)))

    wi_d, _ = _cos_hemisphere_sample(n, u1, u2)

    c1 = (u3 < w_sr)[..., None]
    c2 = (u3 < w_sr + w_rr)[..., None]
    return torch.where(c1, wi_sr, torch.where(c2, wi_rr, wi_d))


# --- car paint -----------------------------------------------------------------
#
# A Fresnel-weighted Beckmann clearcoat over a flake layer: the procedural
# flake pattern decides per shading point whether the base is a metallic
# flake (wide Beckmann, flakes_color) or the pigment diffuse.  The
# shade-time flake fields (coverage and flake normal at the hit uv) are
# attached by `carpaint_flake_fields`; without them the expected coverage
# (flake_density) stands in.


def carpaint_flake_fields(mat, uv, ns):
    """`mat` with per-lane flake data: mat["flake_a"] the coverage at uv
    and mat["flake_nml"] the world-space flake normal."""
    nml_t, a = flakes_gen(uv[..., 0], uv[..., 1], mat["flake_scale"], mat["flake_size"],
                          mat["flake_size_variance"], mat["flake_normal_orientation"])
    mat = dict(mat)
    mat["flake_a"] = a
    mat["flake_nml"] = vm.normalize(vm.to_world(nml_t, ns))
    return mat


def _carpaint_fields(mat, n):
    dens = flake_density(mat["flake_size"])
    a = mat.get("flake_a")
    if a is None:
        a = dens
    n_fl = mat.get("flake_nml")
    if n_fl is None:
        n_fl = n
    return dens, a, n_fl


_FLAKE_ROUGH = 1.0  # the flake lobe's roughness
_FLAKE_IOR = 10.0


def _carpaint_eval_pdf(mat, n, wo, wi):
    nv = vm.dot(n, wo, keepdims=False)
    nl = vm.dot(n, wi, keepdims=False)
    F = fresnel_dielectric(torch.clamp(nv, 0.0, 1.0), 1.0, mat["clearcoat_ior"])
    dens, a, n_fl = _carpaint_fields(mat, n)

    mat_cc = dict(mat, roughness=mat["clearcoat_roughness"], ior=mat["clearcoat_ior"],
                  base_color=mat["clearcoat_color"])
    f_cc, pdf_cc = _microfacet_eval(mat_cc, n, wo, wi, "beckmann")

    # flakes: a wide Beckmann lobe about the flake normal
    mat_fl = dict(mat, roughness=torch.full_like(nv, _FLAKE_ROUGH),
                  ior=torch.full_like(nv, _FLAKE_IOR),
                  base_color=mat["flakes_color"] * mat["flake_color_multiplier"][..., None])
    f_fl, _ = _microfacet_eval(mat_fl, n_fl, wo, wi, "beckmann")
    _, pdf_fl = _microfacet_eval(mat_fl, n, wo, wi, "beckmann")

    f_diff = mat["base_color"] / PI

    valid = (nv > 0) & (nl > 0)
    f = (F[..., None] * f_cc
         + (1.0 - F)[..., None] * (a[..., None] * f_fl + (1.0 - a)[..., None] * f_diff))
    f = torch.where(valid[..., None], f, 0.0)
    pdf_diff = torch.clamp(nl, min=0.0) / PI
    pdf = F * pdf_cc + (1.0 - F) * (dens * pdf_fl + (1.0 - dens) * pdf_diff)
    return f, torch.where(valid, pdf, 0.0)


def _carpaint_sample(mat, n, wo, u1, u2, u3):
    nv = vm.dot(n, wo, keepdims=False)
    F = fresnel_dielectric(torch.clamp(nv, 0.0, 1.0), 1.0, mat["clearcoat_ior"])
    dens = flake_density(mat["flake_size"])

    mat_cc = dict(mat, roughness=mat["clearcoat_roughness"])
    wi_cc = _reflect_about(wo, _microfacet_sample_h(mat_cc, n, u1, u2, "beckmann"))
    mat_fl = dict(mat, roughness=torch.full_like(nv, _FLAKE_ROUGH))
    wi_fl = _reflect_about(wo, _microfacet_sample_h(mat_fl, n, u1, u2, "beckmann"))
    wi_d, _ = _cos_hemisphere_sample(n, u1, u2)

    pick_cc = (u3 < F)[..., None]
    # re-stretch u3 for the base pick
    u3b = torch.clamp((u3 - F) / torch.clamp(1.0 - F, min=1e-6), 0.0, 1.0)
    pick_fl = (u3b < dens)[..., None]
    return torch.where(pick_cc, wi_cc, torch.where(pick_fl, wi_fl, wi_d))


# --- fused evaluation and sampling --------------------------------------------


def eval_bsdf(mat, ns, wo, wi, used=None):
    """f(wo, wi) [N,3] of the non-singular lobes, zero for singular and
    emissive materials: eval_bsdf_pdf's first half."""
    return eval_bsdf_pdf(mat, ns, wo, wi, used)[0]


def eval_pdf(mat, ns, wo, wi, used=None):
    """The solid-angle pdf [N] of sample_brdf proposing wi, zero for
    singular and emissive materials: eval_bsdf_pdf's second half."""
    return eval_bsdf_pdf(mat, ns, wo, wi, used)[1]


def eval_bsdf_pdf(mat, ns, wo, wi, used=None):
    """f(wo, wi) [N,3] and the solid-angle pdf [N] of sample_brdf
    proposing wi; both zero for singular and emissive materials."""
    check_used_types(used)
    n = orient_normal(ns, wo)
    mtype = mat["type"]
    t = mtype[..., None]
    nl = torch.clamp(vm.dot(n, wi, keepdims=False), 0.0, 1.0)

    f = mat["base_color"] / PI * torch.ones_like(nl)[..., None]
    f = torch.where(nl[..., None] > 0, f, 0.0)
    pdf = nl / PI
    if _need(used, MaterialType.OREN_NAYAR):
        f = torch.where(t == int(MaterialType.OREN_NAYAR), _oren_nayar_eval(mat, n, wo, wi), f)
    if _need(used, MaterialType.VELVET):
        f = torch.where(t == int(MaterialType.VELVET), _velvet_eval(mat, n, wo, wi), f)
    for ty, both in (
        (MaterialType.GGX, lambda: _microfacet_eval(mat, n, wo, wi, "ggx")),
        (MaterialType.BECKMANN, lambda: _microfacet_eval(mat, n, wo, wi, "beckmann")),
        (MaterialType.DISNEY, lambda: _disney_eval_pdf(mat, n, wo, wi)),
        (MaterialType.MICROFACET_REFRACTION,
         lambda: _rough_dielectric_eval_pdf(mat, ns, wo, wi)),
        (MaterialType.RETROREFLECTIVE, lambda: _retro_eval_pdf(mat, n, wo, wi)),
        (MaterialType.CAR_PAINT, lambda: _carpaint_eval_pdf(mat, n, wo, wi)),
    ):
        if _need(used, ty):
            fv, pv = both()
            f = torch.where(t == int(ty), fv, f)
            pdf = torch.where(mtype == int(ty), pv, pdf)
    zero = (mtype == _SPECULAR) | (mtype == _REFRACTION) | (mtype == _EMISSIVE)
    f = torch.where(zero[..., None], 0.0, f)
    pdf = torch.where(zero, 0.0, pdf)
    return f, pdf


def sample_brdf(mat, ns, wo, u1, u2, u3, used=None):
    """Sample wi ~ p(wi | wo).  Returns {wi [N,3], pdf [N], bsdf [N,3],
    singular [N], transmission [N]}."""
    check_used_types(used)
    n = orient_normal(ns, wo)
    mtype = mat["type"]
    t3 = mtype[..., None]

    # cosine-hemisphere family (diffuse, Oren-Nayar, velvet)
    wi, _ = _cos_hemisphere_sample(n, u1, u2)
    for ty, kind in ((MaterialType.GGX, "ggx"), (MaterialType.BECKMANN, "beckmann")):
        if _need(used, ty):
            wi_h = _reflect_about(wo, _microfacet_sample_h(mat, n, u1, u2, kind))
            wi = torch.where(t3 == int(ty), wi_h, wi)

    wi_spec = vm.reflect(wo, n)
    if _need(used, MaterialType.SPECULAR):
        wi = torch.where(t3 == _SPECULAR, wi_spec, wi)

    if _need(used, MaterialType.REFRACTION):
        entering = vm.dot(ns, wo, keepdims=False) > 0.0
        eta_i = torch.where(entering, 1.0, mat["ior"])
        eta_t = torch.where(entering, mat["ior"], 1.0)
        cos_i = torch.clamp(vm.dot(n, wo, keepdims=False), 0.0, 1.0)
        F = fresnel_dielectric(cos_i, eta_i, eta_t)
        wt, tir = vm.refract(wo, n, (eta_i / eta_t)[..., None])
        choose_reflect = (u3 < F) | tir
        wi_refr = torch.where(choose_reflect[..., None], wi_spec, wt)
        wi = torch.where(t3 == _REFRACTION, wi_refr, wi)
    else:
        choose_reflect = torch.ones_like(mtype, dtype=torch.bool)

    if _need(used, MaterialType.DISNEY):
        wi = torch.where(t3 == int(MaterialType.DISNEY),
                         _disney_sample(mat, n, wo, u1, u2, u3), wi)
    if _need(used, MaterialType.MICROFACET_REFRACTION):
        wi_rt, rt_transmit = _rough_dielectric_sample(mat, ns, wo, u1, u2, u3)
        wi = torch.where(t3 == _MICROFACET_REFRACTION, wi_rt, wi)
    else:
        rt_transmit = torch.zeros_like(mtype, dtype=torch.bool)
    if _need(used, MaterialType.RETROREFLECTIVE):
        wi = torch.where(t3 == int(MaterialType.RETROREFLECTIVE),
                         _retro_sample(mat, n, wo, u1, u2, u3), wi)
    if _need(used, MaterialType.CAR_PAINT):
        wi = torch.where(t3 == int(MaterialType.CAR_PAINT),
                         _carpaint_sample(mat, n, wo, u1, u2, u3), wi)

    f, pdf = eval_bsdf_pdf(mat, ns, wo, wi, used)

    # singular overrides: pdf 1, f = weight / |cos|
    cos_wi = torch.abs(vm.dot(n, wi, keepdims=False))
    inv_cos = 1.0 / torch.clamp(cos_wi, min=1e-6)
    is_spec = mtype == _SPECULAR
    is_refr = mtype == _REFRACTION
    f = torch.where(is_spec[..., None], mat["base_color"] * inv_cos[..., None], f)
    f = torch.where(is_refr[..., None], mat["base_color"] * inv_cos[..., None], f)
    singular = is_spec | is_refr
    pdf = torch.where(singular, 1.0, pdf)
    transmission = (is_refr & ~choose_reflect) | (
        (mtype == _MICROFACET_REFRACTION) & rt_transmit)
    return {
        "wi": wi,
        "pdf": pdf,
        "bsdf": f,
        "singular": singular,
        "transmission": transmission,
    }
