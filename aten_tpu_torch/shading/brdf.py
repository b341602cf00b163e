"""BSDF sampling and evaluation, batched over shading points.

Counterpart of aten_tpu/shading/brdf.py for the families ported so far:
DIFFUSE, SPECULAR, REFRACTION and GGX (plus EMISSIVE, which has no lobe).
As in the reference, every family present in the scene is evaluated on
the whole batch and the per-lane material type selects the result; the
static used-type set prunes absent families (`_need`).  A scene that
uses any other family, or an unknown used-type set, raises
NotImplementedError.

Conventions: `wo` points away from the surface toward the viewer, `wi`
toward the next vertex; `ns` is the shading normal as stored.  Singular
models report pdf 1 and f with f * |cos| equal to the throughput weight.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.materials import MaterialType

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))

_EMISSIVE = int(MaterialType.EMISSIVE)
_SPECULAR = int(MaterialType.SPECULAR)
_REFRACTION = int(MaterialType.REFRACTION)
_GGX = int(MaterialType.GGX)

PORTED_TYPES = frozenset(int(t) for t in (
    MaterialType.EMISSIVE, MaterialType.DIFFUSE, MaterialType.SPECULAR,
    MaterialType.REFRACTION, MaterialType.GGX))


def check_used_types(used):
    """Raise for a used-type set the port cannot shade."""
    if used is None:
        raise NotImplementedError(
            "shading needs the scene's static used_mtl_types")
    missing = sorted(set(int(t) for t in used) - PORTED_TYPES)
    if missing:
        names = [MaterialType(t).name for t in missing]
        raise NotImplementedError(f"material families not ported yet: {names}")


def _need(used, *types):
    """Static dispatch pruning by the scene's used-material-type set."""
    return any(int(t) in used for t in types)


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


# --- GGX microfacet (ggx.cpp:74-120 role) ----------------------------------


def _ggx_alpha(mat):
    return torch.clamp(vm.ipow(mat["roughness"], 2), min=1e-3)


def _ggx_d(nh, a):
    d = nh * nh * (a * a - 1.0) + 1.0
    return a * a / torch.clamp(PI * d * d, min=1e-12)


def _ggx_g1(nv, a):
    nv = torch.clamp(nv, min=1e-6)
    return 2.0 * nv / torch.clamp(
        nv + torch.sqrt(a * a + (1.0 - a * a) * nv * nv), min=1e-12)


def _microfacet_f0(mat):
    ior = mat["ior"]
    r = (ior - 1.0) / torch.clamp(ior + 1.0, min=1e-6)
    return r * r


def _microfacet_eval(mat, n, wo, wi):
    """Cook-Torrance GGX: (f [N,3], pdf [N])."""
    a = _ggx_alpha(mat)
    h = vm.normalize(wo + wi)
    nh = torch.clamp(vm.dot(n, h, keepdims=False), 0.0, 1.0)
    nv = vm.dot(n, wo, keepdims=False)
    nl = vm.dot(n, wi, keepdims=False)
    vh = torch.clamp(vm.dot(wo, h, keepdims=False), 0.0, 1.0)
    d = _ggx_d(nh, a)
    g = _ggx_g1(nv, a) * _ggx_g1(nl, a)
    f = fresnel_schlick(vh, _microfacet_f0(mat))
    spec = d * g * f / torch.clamp(4.0 * nv * nl, min=1e-6)
    valid = (nv > 0.0) & (nl > 0.0)
    fr = torch.where(valid[..., None], spec[..., None] * mat["base_color"], 0.0)
    pdf = torch.where(valid, d * nh / torch.clamp(4.0 * vh, min=1e-6), 0.0)
    return fr, pdf


def _microfacet_sample_h(mat, n, u1, u2):
    a = _ggx_alpha(mat)
    u1 = torch.clamp(u1, 1e-7, 1.0 - 1e-7)
    tan2 = a * a * u1 / (1.0 - u1)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    local = torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    return vm.normalize(vm.to_world(local, n))


# --- fused evaluation and sampling -----------------------------------------


def eval_bsdf_pdf(mat, ns, wo, wi, used):
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
    if _need(used, MaterialType.GGX):
        fv, pv = _microfacet_eval(mat, n, wo, wi)
        f = torch.where(t == _GGX, fv, f)
        pdf = torch.where(mtype == _GGX, pv, pdf)
    zero = (mtype == _SPECULAR) | (mtype == _REFRACTION) | (mtype == _EMISSIVE)
    f = torch.where(zero[..., None], 0.0, f)
    pdf = torch.where(zero, 0.0, pdf)
    return f, pdf


def sample_brdf(mat, ns, wo, u1, u2, u3, used):
    """Sample wi ~ p(wi | wo).  Returns {wi [N,3], pdf [N], bsdf [N,3],
    singular [N], transmission [N]}."""
    check_used_types(used)
    n = orient_normal(ns, wo)
    mtype = mat["type"]
    t3 = mtype[..., None]

    wi, _ = _cos_hemisphere_sample(n, u1, u2)
    if _need(used, MaterialType.GGX):
        h_ggx = _microfacet_sample_h(mat, n, u1, u2)
        wi_ggx = vm.normalize(2.0 * vm.dot(wo, h_ggx) * h_ggx - wo)
        wi = torch.where(t3 == _GGX, wi_ggx, wi)

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
    return {
        "wi": wi,
        "pdf": pdf,
        "bsdf": f,
        "singular": singular,
        "transmission": is_refr & ~choose_reflect,
    }
