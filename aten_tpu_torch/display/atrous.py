"""Standalone edge-aware a-trous filter post op.

Counterpart of aten_tpu/display/atrous.py (the reference's A-trous
display filter, filter/atrous.{h,cpp} and shader/atrous_fs.glsl): the
5x5 B3-spline dilated stencil of SVGF's wavelet pass, weighted by
colour, normal and depth alone (no variance), on any image with a
G-buffer.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.core.vecmath import luminance
from aten_tpu_torch.denoise.svgf import _B3, _normal_weight, _shift


def atrous(color, normal, depth, iters=5, sigma_c=0.3, sigma_n=128.0, sigma_z=1.0):
    """Edge-aware multi-pass a-trous blur of [H, W, 3] color."""
    for it in range(iters):
        step = 1 << it
        lum_p = luminance(color)[..., 0]
        csum = torch.zeros_like(color)
        wsum = torch.zeros_like(lum_p)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                dy, dx = ky * step, kx * step
                hk = _B3[ky + 2] * _B3[kx + 2]
                c_q = _shift(color, dy, dx)
                l_q = luminance(c_q)[..., 0]
                z_q = _shift(depth, dy, dx)
                n_q = _shift(normal, dy, dx)
                w_z = torch.exp(-torch.abs(z_q - depth) / (sigma_z * step + 1e-4))
                w_n = _normal_weight(n_q, normal, sigma_n)
                w_c = torch.exp(-torch.abs(l_q - lum_p) / (sigma_c + 1e-4))
                w = hk * w_z * w_n * w_c
                csum = csum + w[..., None] * c_q
                wsum = wsum + w
        color = csum / torch.clamp(wsum[..., None], min=1e-6)
    return color
