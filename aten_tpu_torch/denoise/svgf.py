"""SVGF: spatiotemporal variance-guided filtering, as whole-image ops.

Counterpart of aten_tpu/denoise/svgf.py (the reference's svgf_impl.h:
TemporalReprojection :286-384, EstimateVariance with the 7x7 young-pixel
fallback and the 3x3 Gauss :435-617, the 5-pass edge-aware a-trous
wavelet filter :673-806).  Every stencil tap is an edge-clamped shifted
copy of the image, so a step is eager elementwise PyTorch on the
image's device, with no kernel of its own.

Reprojection goes through the previous frame's camera matrices (W2V,
V2C) from the path tracer's first-hit world positions, and, for a scene
with instances, first through the instances' motion between the two
frames.  The history is read with one index per buffer at the
reprojected pixel; the reference packs the buffers into one wide take,
a TPU gather schedule that changes no value.
"""
from __future__ import annotations

import dataclasses

import torch

from aten_tpu_torch.core.camera import camera_matrices
from aten_tpu_torch.core.vecmath import dot, luminance


def _shift_axis(img, d, axis):
    """img shifted by d along `axis`, clamped at the edges:
    out[i] = img[clamp(i + d, 0, n - 1)]."""
    n = img.shape[axis]
    if d == 0:
        return img
    k = min(abs(d), n)
    size = [-1] * img.dim()
    size[axis] = k
    if d > 0:
        return torch.cat([img.narrow(axis, k, n - k), img.narrow(axis, n - 1, 1).expand(size)],
                         dim=axis)
    return torch.cat([img.narrow(axis, 0, 1).expand(size), img.narrow(axis, 0, n - k)], dim=axis)


def _shift(img, dy, dx):
    """Edge-clamped static shift: out[y, x] = img[y + dy, x + dx]."""
    return _shift_axis(_shift_axis(img, dy, 0), dx, 1)


# 5x5 B3-spline kernel (a-trous), outer product of [1,4,6,4,1]/16
_B3 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


@dataclasses.dataclass(frozen=True)
class SVGFParams:
    temporal_alpha: float = 0.2
    sigma_z: float = 1.0
    sigma_n: float = 128.0
    sigma_l: float = 4.0
    atrous_iters: int = 5  # svgf_types.h:121 atrous_iter_cnt = 5
    history_cap: int = 32
    young_threshold: int = 4


def init_state(height, width, device):
    """The empty history on `device`: no pixel valid, identity cameras."""
    f32 = {"dtype": torch.float32, "device": device}
    return {
        "color": torch.zeros((height, width, 3), **f32),
        "moments": torch.zeros((height, width, 2), **f32),
        "normal": torch.zeros((height, width, 3), **f32),
        "depth": torch.full((height, width), -1.0, **f32),
        "mtl": torch.full((height, width), -1, dtype=torch.int32, device=device),
        "history": torch.zeros((height, width), **f32),
        "w2v": torch.eye(4, **f32),
        "v2c": torch.eye(4, **f32),
        "valid": torch.zeros((height, width), dtype=torch.bool, device=device),
        # dynamic-object motion (optional): the previous frame's instance
        # L2W and the current frame's W2L
        "prev_l2w": None,
        "cur_w2l": None,
    }


def inst_l2w_from_w2l(inst_w2l):
    """Invert the scene's [I, 3, 4] W2L rows to L2W (R' = R^-1, t' = -R't)."""
    R = inst_w2l[..., :3]
    t = inst_w2l[..., 3]
    Rinv = torch.linalg.inv(R)
    tinv = -_rows(Rinv, t)
    return torch.cat([Rinv, tinv[..., None]], dim=-1)


def _rows(m, v):
    """m [..., R, C] times v [..., C], each row summed left to right."""
    out = m[..., 0] * v[..., 0:1]
    for j in range(1, m.shape[-1]):
        out = out + m[..., j] * v[..., j:j + 1]
    return out


def _project(pos, w2v, v2c, width, height):
    """World positions [H, W, 3] -> pixel coordinates (x, y) and the
    in-front mask."""
    ph = torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1)
    view = _rows(w2v, ph)
    clip = _rows(v2c, view)
    w = clip[..., 3]
    ndc = clip[..., :3] / torch.where(torch.abs(w) > 1e-8, w, 1e-8)[..., None]
    x = (ndc[..., 0] * 0.5 + 0.5) * width
    y = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    return x, y, w > 1e-6


def _gather_prev(state, iy, ix):
    """The history buffers at pixels (iy, ix), clamped into the image."""
    H, W = state["color"].shape[0], state["color"].shape[1]
    iy = torch.clamp(iy, 0, H - 1).long()
    ix = torch.clamp(ix, 0, W - 1).long()
    return {k: state[k][iy, ix]
            for k in ("color", "moments", "normal", "depth", "mtl", "history", "valid")}


def object_motion_pos(pos, inst, cur_w2l, prev_l2w):
    """The previous frame's world position of each pixel's surface point
    on a dynamic instance, prev_L2W[inst] . (cur_W2L[inst] . pos); pixels
    off every instance (inst < 0) pass through.  The analytic stand-in
    for the object term of the reference's rasterized motion buffer
    (host_renderer/main.cpp:150-163)."""
    I = cur_w2l.shape[0]
    iid = torch.clamp(torch.where(inst >= 0, inst, I - 1), 0, I - 1).long()
    w2l = cur_w2l[iid]  # [H, W, 3, 4]
    l2w = prev_l2w[iid]
    local = _rows(w2l[..., :3], pos) + w2l[..., 3]
    prev = _rows(l2w[..., :3], local) + l2w[..., 3]
    return torch.where((inst >= 0)[..., None], prev, pos)


def temporal_reproject(img, aovs, state, params: SVGFParams, width, height):
    """TemporalReprojection (svgf_impl.h:286): reproject through the
    previous camera, accept on normal, material and depth consistency,
    and blend colour and moments into the history."""
    lum = luminance(img)[..., 0]
    mom_cur = torch.stack([lum, lum * lum], dim=-1)

    pos = aovs["pos"]
    if state.get("prev_l2w") is not None and "inst" in aovs:
        pos = object_motion_pos(pos, aovs["inst"], state["cur_w2l"], state["prev_l2w"])
    x, y, infront = _project(pos, state["w2v"], state["v2c"], width, height)
    ix = torch.round(x - 0.5).to(torch.int32)
    iy = torch.round(y - 0.5).to(torch.int32)
    inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height) & infront
    prev = _gather_prev(state, iy, ix)

    ndot = dot(aovs["normal"], prev["normal"], keepdims=False)
    same_mtl = aovs["mtl"] == prev["mtl"]
    depth_ok = torch.abs(prev["depth"] - aovs["depth"]) < 0.1 * torch.clamp(
        aovs["depth"], min=1e-3)
    cur_ok = aovs["depth"] > 0.0
    accept = inside & prev["valid"] & cur_ok & (ndot > 0.8) & same_mtl & depth_ok

    history = torch.where(
        accept, torch.clamp(prev["history"] + 1.0, max=float(params.history_cap)), 1.0)
    alpha = torch.clamp(1.0 / history, min=params.temporal_alpha)
    a3 = alpha[..., None]
    color = torch.where(accept[..., None], (1.0 - a3) * prev["color"] + a3 * img, img)
    moments = torch.where(
        accept[..., None], (1.0 - a3) * prev["moments"] + a3 * mom_cur, mom_cur)
    return color, moments, history, cur_ok


def _normal_weight(n_q, normal, sigma_n):
    return torch.pow(torch.clamp(dot(n_q, normal, keepdims=False), min=0.0), sigma_n)


def estimate_variance(color, moments, history, aovs, params: SVGFParams):
    """EstimateVariance (svgf_impl.h:435): the temporal variance of
    mature pixels, a 7x7 bilateral spatial estimate for young ones, then
    a 3x3 Gauss."""
    var_t = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)

    lum = luminance(color)[..., 0]
    depth = aovs["depth"]
    normal = aovs["normal"]
    wsum = torch.zeros_like(lum)
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            l_q = _shift(lum, dy, dx)
            z_q = _shift(depth, dy, dx)
            n_q = _shift(normal, dy, dx)
            w_z = torch.exp(-torch.abs(z_q - depth) / (params.sigma_z + 1e-4))
            w = w_z * _normal_weight(n_q, normal, params.sigma_n)
            wsum = wsum + w
            m1 = m1 + w * l_q
            m2 = m2 + w * l_q * l_q
    m1 = m1 / torch.clamp(wsum, min=1e-6)
    m2 = m2 / torch.clamp(wsum, min=1e-6)
    var_s = torch.clamp(m2 - m1 * m1, min=0.0)

    var = torch.where(history >= params.young_threshold, var_t, var_s)
    # 3x3 Gauss (svgf_impl.h:560)
    g = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]
    out = torch.zeros_like(var)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            out = out + g[dy + 1][dx + 1] * _shift(var, dy, dx)
    return out / 16.0


def atrous_filter(color, variance, aovs, params: SVGFParams):
    """ExecAtrousWaveletFilter (svgf_impl.h:673): atrous_iters dilated 5x5
    passes with depth, normal and luminance edge stopping.  Returns (the
    filtered colour, the first pass's colour, next frame's history)."""
    normal = aovs["normal"]
    depth = aovs["depth"]
    history_color = color

    # screen-space depth gradients: the depth weight divides by the
    # depth change expected along the offset, so oblique surfaces keep
    # their same-plane neighbours
    dzdx = 0.5 * (_shift(depth, 0, 1) - _shift(depth, 0, -1))
    dzdy = 0.5 * (_shift(depth, 1, 0) - _shift(depth, -1, 0))

    for it in range(params.atrous_iters):
        step = 1 << it
        lum_p = luminance(color)[..., 0]
        sdev = torch.sqrt(torch.clamp(variance, min=0.0))
        csum = torch.zeros_like(color)
        vsum = torch.zeros_like(variance)
        wsum = torch.zeros_like(lum_p)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                dy, dx = ky * step, kx * step
                hk = _B3[ky + 2] * _B3[kx + 2]
                c_q = _shift(color, dy, dx)
                v_q = _shift(variance, dy, dx)
                l_q = luminance(c_q)[..., 0]
                z_q = _shift(depth, dy, dx)
                n_q = _shift(normal, dy, dx)
                expected_dz = torch.abs(dzdx * dx + dzdy * dy)
                w_z = torch.exp(-torch.abs(z_q - depth)
                                / (params.sigma_z * (expected_dz + 1e-2) + 1e-4))
                w_n = _normal_weight(n_q, normal, params.sigma_n)
                w_l = torch.exp(-torch.abs(l_q - lum_p) / (params.sigma_l * sdev + 1e-4))
                w = hk * w_z * w_n * w_l
                csum = csum + w[..., None] * c_q
                vsum = vsum + w * w * v_q
                wsum = wsum + w
        color = csum / torch.clamp(wsum[..., None], min=1e-6)
        variance = vsum / torch.clamp(wsum * wsum, min=1e-6)
        if it == 0:
            history_color = color  # the first pass's output feeds the history
    return color, history_color


def svgf_step(img, aovs, state, params, cam, width, height, scene=None):
    """One SVGF frame on img's device: (filtered [H, W, 3], new state).
    `cam` is the current camera, whose matrices the new state keeps for
    the next frame; `scene`, the current scene, gives an instanced
    scene's W2L rows (I + 1 of them, the last the identity) for object
    motion."""
    w2v, v2c = camera_matrices(cam, device=img.device)
    cur_w2l = scene["inst_w2l"] if scene is not None and "inst_w2l" in scene else None
    state = dict(state, cur_w2l=cur_w2l)
    color, moments, history, cur_ok = temporal_reproject(img, aovs, state, params,
                                                         width, height)
    variance = estimate_variance(color, moments, history, aovs, params)
    filtered, history_color = atrous_filter(color, variance, aovs, params)
    # pixels with no geometry keep their raw radiance (background)
    filtered = torch.where(cur_ok[..., None], filtered, img)
    new_state = {
        "color": history_color,
        "moments": moments,
        "normal": aovs["normal"],
        "depth": aovs["depth"],
        "mtl": aovs["mtl"],
        "history": history,
        "w2v": w2v,
        "v2c": v2c,
        "valid": cur_ok,
        # this frame's instance L2W is next frame's motion source
        "prev_l2w": inst_l2w_from_w2l(cur_w2l) if cur_w2l is not None else None,
        "cur_w2l": None,
    }
    return filtered, new_state


class SVGFDenoiser:
    """Counterpart of SVGFRenderer (svgf/svgf.cpp:461-639): a 1 spp path
    trace, then temporal reprojection, variance estimation, the a-trous
    passes and the history update, on `device`."""

    def __init__(self, width, height, params: SVGFParams = None, *, device="cuda"):
        self.width = width
        self.height = height
        self.params = params or SVGFParams()
        self.state = init_state(height, width, device)

    def step(self, img, aovs, cam, scene=None):
        """img [H, W, 3] noisy radiance; aovs from render_sample_with_aovs;
        cam the current camera; scene the current scene, for instanced
        dynamic scenes (its instance transforms give object motion)."""
        out, self.state = svgf_step(img, aovs, self.state, self.params, cam,
                                    self.width, self.height, scene=scene)
        return out
