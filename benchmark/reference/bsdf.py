"""BSDF sampling and evaluation of the eleven families, the car-paint
flakes and the retroreflective ERA table.

A frozen copy of the port's shading code (shading/brdf.py,
utils/flakes.py, utils/retroreflective.py's host table), kept in the
benchmark so that the reference stays fixed while the program changes.
Every family present in `used` is evaluated on every lane and the
per-lane material type selects the result.  Float tensors take the run's
floating type (vecmath.precision); hashes stay exact in int64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.vecmath import ftype
from benchmark.reference import vecmath as vm

EMISSIVE, DIFFUSE, OREN_NAYAR, SPECULAR, REFRACTION, GGX, BECKMANN = range(7)
MICROFACET_REFRACTION, VELVET, RETROREFLECTIVE, CAR_PAINT, DISNEY = range(7, 12)
MATERIAL_TYPES = {
    "EMISSIVE": EMISSIVE, "DIFFUSE": DIFFUSE, "OREN_NAYAR": OREN_NAYAR,
    "SPECULAR": SPECULAR, "REFRACTION": REFRACTION, "GGX": GGX, "BECKMANN": BECKMANN,
    "MICROFACET_REFRACTION": MICROFACET_REFRACTION, "VELVET": VELVET,
    "RETROREFLECTIVE": RETROREFLECTIVE, "CAR_PAINT": CAR_PAINT, "DISNEY": DISNEY,
}

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))


# --- car-paint flakes (Jenkins' lookup3 cell hash) --------------------------

_M32 = 0xFFFFFFFF
_INIT = (0xDEADBEEF + (4 << 2) + 13) & _M32
_INV = 1.0 / 4294967295.0


def _rotl(x, k):
    return ((x << k) & _M32) | (x >> (32 - k))


def _sub(a, b):
    return (a - b) & _M32


def _add(a, b):
    return (a + b) & _M32


def _bjfinal(a, b, c):
    """lookup3's final mix."""
    c = c ^ b
    c = _sub(c, _rotl(b, 14))
    a = a ^ c
    a = _sub(a, _rotl(c, 11))
    b = b ^ a
    b = _sub(b, _rotl(a, 25))
    c = c ^ b
    c = _sub(c, _rotl(b, 16))
    a = a ^ c
    a = _sub(a, _rotl(c, 4))
    b = b ^ a
    b = _sub(b, _rotl(a, 14))
    c = c ^ b
    c = _sub(c, _rotl(b, 24))
    return c


def _bjmix(a, b, c):
    """lookup3's mix."""
    a = _sub(a, c)
    a = a ^ _rotl(c, 4)
    c = _add(c, b)
    b = _sub(b, a)
    b = b ^ _rotl(a, 6)
    a = _add(a, c)
    c = _sub(c, b)
    c = c ^ _rotl(b, 8)
    b = _add(b, a)
    a = _sub(a, c)
    a = a ^ _rotl(c, 16)
    c = _add(c, b)
    b = _sub(b, a)
    b = b ^ _rotl(a, 19)
    a = _add(a, c)
    c = _sub(c, b)
    c = c ^ _rotl(b, 4)
    b = _add(b, a)
    return a, b, c


def _inthash4(k0, k1, k2, k3):
    """lookup3 hash of four uint32 keys (int64 tensors or ints)."""
    a = _add(k0, _INIT)
    b = _add(k1, _INIT)
    c = _add(k2, _INIT)
    a, b, c = _bjmix(a, b, c)
    a = _add(a, k3)
    return _bjfinal(a, b, c)


def _cell_key(p):
    """floor(p) as int32, reinterpreted as uint32: negative cells wrap to
    two's complement."""
    return torch.floor(p).to(torch.int32).to(torch.int64) & _M32


def _cellnoise3(px, py, pz):
    """Three uniforms in [0, 1] per integer cell.  The hash goes to float32
    rounding to nearest, as the reference's uint32 -> float32."""
    kx, ky, kz = _cell_key(px), _cell_key(py), _cell_key(pz)
    return tuple(_inthash4(kx, ky, kz, j).to(ftype()) * _INV for j in range(3))


_CELL_CENTERS = ((0.5, 0.5), (1.5, 0.5), (1.5, 1.5), (0.5, 1.5), (-0.5, 1.5),
                 (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5), (1.5, -0.5))


def flakes_gen(u, v, flake_scale, flake_size, flake_size_variance,
               flake_normal_orientation):
    """Per-lane flake lookup.  u, v [N]; the four parameters [N].
    Returns (nml [N,3] tangent-space flake normal, alpha [N], 1 where
    the uv lies on a flake)."""
    var = torch.clamp(flake_size_variance, 0.1, 1.0)
    px = flake_scale * u
    py = flake_scale * v
    bx = torch.floor(px)
    by = torch.floor(py)

    best_cz = torch.ones_like(px)
    best_cx = torch.zeros_like(px)
    best_cy = torch.zeros_like(px)
    found = torch.zeros_like(px, dtype=torch.bool)
    for cx0, cy0 in _CELL_CENTERS:
        ccx = bx + cx0
        ccy = by + cy0
        r0, r1, r2 = _cellnoise3(ccx, ccy, torch.zeros_like(ccx))
        ox = r0 * 2.0 - 1.0
        oy = r1 * 2.0 - 1.0
        oz = (r2 * 2.0 - 1.0) * var
        inv_len = 1.0 / torch.sqrt(torch.clamp(ox * ox + oy * oy + oz * oz, min=1e-12))
        fx = ccx + 0.5 * ox * inv_len
        fy = ccy + 0.5 * oy * inv_len
        fz = 0.5 * oz * inv_len
        dx = px - fx
        dy = py - fy
        d = torch.sqrt(dx * dx + dy * dy + fz * fz)
        take = (d < flake_size) & (fz < best_cz)
        best_cz = torch.where(take, fz, best_cz)
        best_cx = torch.where(take, ccx, best_cx)
        best_cy = torch.where(take, ccy, best_cy)
        found = found | take

    # the winning cell's random normal, faced to +z and mixed toward it
    r0, r1, r2 = _cellnoise3(best_cx, best_cy, torch.full_like(best_cx, 1.5))
    nx = r0 * 2.0 - 1.0
    ny = r1 * 2.0 - 1.0
    nz = r2 * 2.0 - 1.0
    flip = torch.where(nz < 0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    t = flake_normal_orientation
    nx = nx * (1.0 - t)
    ny = ny * (1.0 - t)
    nz = nz * (1.0 - t) + t
    inv_len = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-12))
    nml = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    flat = torch.tensor([0.0, 0.0, 1.0], dtype=nml.dtype, device=nml.device)
    nml = torch.where(found[..., None], nml, flat)
    return nml, found.to(ftype())


def flake_density(flake_size, aspect=1.0):
    """Expected flake coverage: min(pi * size^2 / aspect, 1)."""
    return torch.clamp(math.pi * flake_size * flake_size / aspect, max=1.0)


# --- effective retroreflective area of a corner-cube pair (host, numpy) ------

RAY_ORG_NUM = 100
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


def _need(used, *types):
    """Static dispatch pruning by the scene's used-material-type set
    (None: every family)."""
    return used is None or any(t in used for t in types)


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
    key = (str(device), ftype())
    if key not in _ERA_DEVICE:
        _ERA_DEVICE[key] = torch.from_numpy(_era_theta_table()[1]).to(device, ftype())
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
    fr = pos - i0.to(ftype())
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


def eval_bsdf_pdf(mat, ns, wo, wi, used=None):
    """f(wo, wi) [N,3] and the solid-angle pdf [N] of sample_brdf
    proposing wi; both zero for singular and emissive materials."""
    n = orient_normal(ns, wo)
    mtype = mat["type"]
    t = mtype[..., None]
    nl = torch.clamp(vm.dot(n, wi, keepdims=False), 0.0, 1.0)

    f = mat["base_color"] / PI * torch.ones_like(nl)[..., None]
    f = torch.where(nl[..., None] > 0, f, 0.0)
    pdf = nl / PI
    if _need(used, OREN_NAYAR):
        f = torch.where(t == OREN_NAYAR, _oren_nayar_eval(mat, n, wo, wi), f)
    if _need(used, VELVET):
        f = torch.where(t == VELVET, _velvet_eval(mat, n, wo, wi), f)
    for ty, both in (
        (GGX, lambda: _microfacet_eval(mat, n, wo, wi, "ggx")),
        (BECKMANN, lambda: _microfacet_eval(mat, n, wo, wi, "beckmann")),
        (DISNEY, lambda: _disney_eval_pdf(mat, n, wo, wi)),
        (MICROFACET_REFRACTION,
         lambda: _rough_dielectric_eval_pdf(mat, ns, wo, wi)),
        (RETROREFLECTIVE, lambda: _retro_eval_pdf(mat, n, wo, wi)),
        (CAR_PAINT, lambda: _carpaint_eval_pdf(mat, n, wo, wi)),
    ):
        if _need(used, ty):
            fv, pv = both()
            f = torch.where(t == int(ty), fv, f)
            pdf = torch.where(mtype == int(ty), pv, pdf)
    zero = (mtype == SPECULAR) | (mtype == REFRACTION) | (mtype == EMISSIVE)
    f = torch.where(zero[..., None], 0.0, f)
    pdf = torch.where(zero, 0.0, pdf)
    return f, pdf


def sample_brdf(mat, ns, wo, u1, u2, u3, used=None):
    """Sample wi ~ p(wi | wo).  Returns {wi [N,3], pdf [N], bsdf [N,3],
    singular [N], transmission [N]}."""
    n = orient_normal(ns, wo)
    mtype = mat["type"]
    t3 = mtype[..., None]

    # cosine-hemisphere family (diffuse, Oren-Nayar, velvet)
    wi, _ = _cos_hemisphere_sample(n, u1, u2)
    for ty, kind in ((GGX, "ggx"), (BECKMANN, "beckmann")):
        if _need(used, ty):
            wi_h = _reflect_about(wo, _microfacet_sample_h(mat, n, u1, u2, kind))
            wi = torch.where(t3 == int(ty), wi_h, wi)

    wi_spec = vm.reflect(wo, n)
    if _need(used, SPECULAR):
        wi = torch.where(t3 == SPECULAR, wi_spec, wi)

    if _need(used, REFRACTION):
        entering = vm.dot(ns, wo, keepdims=False) > 0.0
        eta_i = torch.where(entering, 1.0, mat["ior"])
        eta_t = torch.where(entering, mat["ior"], 1.0)
        cos_i = torch.clamp(vm.dot(n, wo, keepdims=False), 0.0, 1.0)
        F = fresnel_dielectric(cos_i, eta_i, eta_t)
        wt, tir = vm.refract(wo, n, (eta_i / eta_t)[..., None])
        choose_reflect = (u3 < F) | tir
        wi_refr = torch.where(choose_reflect[..., None], wi_spec, wt)
        wi = torch.where(t3 == REFRACTION, wi_refr, wi)
    else:
        choose_reflect = torch.ones_like(mtype, dtype=torch.bool)

    if _need(used, DISNEY):
        wi = torch.where(t3 == DISNEY,
                         _disney_sample(mat, n, wo, u1, u2, u3), wi)
    if _need(used, MICROFACET_REFRACTION):
        wi_rt, rt_transmit = _rough_dielectric_sample(mat, ns, wo, u1, u2, u3)
        wi = torch.where(t3 == MICROFACET_REFRACTION, wi_rt, wi)
    else:
        rt_transmit = torch.zeros_like(mtype, dtype=torch.bool)
    if _need(used, RETROREFLECTIVE):
        wi = torch.where(t3 == RETROREFLECTIVE,
                         _retro_sample(mat, n, wo, u1, u2, u3), wi)
    if _need(used, CAR_PAINT):
        wi = torch.where(t3 == CAR_PAINT,
                         _carpaint_sample(mat, n, wo, u1, u2, u3), wi)

    f, pdf = eval_bsdf_pdf(mat, ns, wo, wi, used)

    # singular overrides: pdf 1, f = weight / |cos|
    cos_wi = torch.abs(vm.dot(n, wi, keepdims=False))
    inv_cos = 1.0 / torch.clamp(cos_wi, min=1e-6)
    is_spec = mtype == SPECULAR
    is_refr = mtype == REFRACTION
    f = torch.where(is_spec[..., None], mat["base_color"] * inv_cos[..., None], f)
    f = torch.where(is_refr[..., None], mat["base_color"] * inv_cos[..., None], f)
    singular = is_spec | is_refr
    pdf = torch.where(singular, 1.0, pdf)
    transmission = (is_refr & ~choose_reflect) | (
        (mtype == MICROFACET_REFRACTION) & rt_transmit)
    return {
        "wi": wi,
        "pdf": pdf,
        "bsdf": f,
        "singular": singular,
        "transmission": transmission,
    }
