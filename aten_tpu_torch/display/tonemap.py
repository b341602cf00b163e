"""Tone mapping and transfer-function post ops.

Counterpart of aten_tpu/display/tonemap.py (the reference's gamma,
GT tonemapper and sRGB OETF passes, shader/gamma_fs.glsl,
shader/gt_tonemapper_fs.glsl, shader/srgb_oetf_fs.glsl, and the
magnifier inset).  Each pass is an elementwise function of an
[H, W, 3] float32 image on its own device.
"""
from __future__ import annotations

import numpy as np
import torch

_SRGB_TO_XYZ = np.array([[0.4124, 0.3576, 0.1805],
                         [0.2126, 0.7152, 0.0722],
                         [0.0193, 0.1192, 0.9505]], np.float32)
_XYZ_TO_SRGB = np.array([[3.2406, -1.5372, -0.4986],
                         [-0.9689, 1.8758, 0.0415],
                         [0.0557, -0.2040, 1.0570]], np.float32)


def _mat3(m, v):
    """m [3, 3] float32 (numpy) times v [..., 3] float32, each row summed
    left to right in float32."""
    return torch.stack([float(m[i, 0]) * v[..., 0] + float(m[i, 1]) * v[..., 1]
                        + float(m[i, 2]) * v[..., 2] for i in range(3)], dim=-1)


def gamma(img, g=2.2):
    """Simple gamma correction (shader/gamma_fs.glsl)."""
    return torch.pow(torch.clamp(img, min=0.0), 1.0 / g)


def srgb_oetf(img):
    """Piecewise sRGB opto-electronic transfer (shader/srgb_oetf_fs.glsl)."""
    x = torch.clamp(img, 0.0, 1.0)
    lo = 12.92 * x
    hi = 1.055 * torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def exposure(img, ev=0.0):
    return img * (2.0 ** ev)


def _smoothstep(e0, e1, v):
    t = torch.clamp((v - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def gt_tonemap(img, end_of_toe=0.22, contrast=1.0, max_luminance=1.0,
               range_of_linear=0.4):
    """Gran Turismo 7 tonemapper in XYZ (shader/gt_tonemapper_fs.glsl):
    toe (power curve), linear segment and exponential shoulder, blended
    by smoothstep and step weights per channel; X and Z are rescaled by
    Y'/Y to keep the chromaticity."""
    rgb = torch.clamp(img, min=0.0)
    x = _mat3(_SRGB_TO_XYZ, rgb)

    l0 = (max_luminance - end_of_toe) * range_of_linear / contrast
    c = 1.33
    T = end_of_toe * torch.pow(torch.clamp(x / end_of_toe, min=1e-8), c)
    L = end_of_toe + contrast * (x - end_of_toe)
    S0 = end_of_toe + l0
    S1 = end_of_toe + contrast * l0
    C2 = contrast * max_luminance / max(max_luminance - S1, 1e-6)
    S = max_luminance - (max_luminance - S1) * torch.exp(-C2 * (x - S0) / max_luminance)

    w0 = 1.0 - _smoothstep(0.0, end_of_toe, x)
    w2 = (x >= S0).to(img.dtype)
    w1 = 1.0 - w0 - w2
    mapped = T * w0 + L * w1 + S * w2

    Y = x[..., 1:2]
    Y_dash = mapped[..., 1:2]
    scale = Y_dash / torch.clamp(Y, min=1e-8)
    xyz_out = torch.cat([x[..., 0:1] * scale, Y_dash, x[..., 2:3] * scale], dim=-1)
    return _mat3(_XYZ_TO_SRGB, xyz_out)


def magnifier(img, center_px, magnification=0.5, radius=64.0, line_width=2.0,
              line_color=(1.0, 0.0, 0.0)):
    """Circular magnifier inset (shader/magnifier_fs.glsl): inside the
    radius the lookup is pulled toward the centre, and a ring is drawn at
    the boundary.  center_px is (x, y) in pixels."""
    H, W = img.shape[:2]
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    cx, cy = center_px
    d = torch.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
    inside = d <= radius

    mx = xs * (1 - magnification) + magnification * cx
    my = ys * (1 - magnification) + magnification * cy
    sx = torch.where(inside, mx, xs)
    sy = torch.where(inside, my, ys)
    xi = torch.clamp(sx.to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(sy.to(torch.int32), 0, H - 1).long()
    out = img[yi, xi]

    ring = (d >= radius - line_width) & (d <= radius + line_width)
    color = torch.tensor(line_color, dtype=img.dtype, device=img.device)
    return torch.where(ring[..., None], color, out)
