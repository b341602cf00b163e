"""Temporal anti-aliasing.

Counterpart of aten_tpu/display/taa.py (the reference's TAA pass,
filter/taa.{h,cpp} and shader/taa_fs.glsl): reproject the previous
frame, clip the history to the current 3x3 neighbourhood's colour box,
and blend.  Motion comes from the first-hit world positions and the
previous camera's matrices, as SVGF's does (denoise/svgf.py), in place
of the reference's raster motion buffer.
"""
from __future__ import annotations

import dataclasses

import torch

from aten_tpu_torch.denoise.svgf import _project, _shift


@dataclasses.dataclass(frozen=True)
class TAAParams:
    blend: float = 0.2       # weight of the current frame
    clip_gamma: float = 1.0  # neighbourhood box scale for the history clip


def init_history(height, width, device):
    return {
        "color": torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        "valid": torch.zeros((height, width), dtype=torch.bool, device=device),
    }


def _neighborhood_bounds(img):
    mn = img
    mx = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = _shift(img, dy, dx)
            mn = torch.minimum(mn, s)
            mx = torch.maximum(mx, s)
    return mn, mx


def taa_step(cur, pos_aov, depth_aov, history, prev_w2v, prev_v2c, params=None):
    """One TAA step: cur [H, W, 3] the current frame, pos_aov [H, W, 3]
    first-hit world positions, depth_aov [H, W] (< 0 where no hit),
    history from init_history, prev_w2v and prev_v2c the previous
    frame's camera matrices (core/camera.py::camera_matrices).  Returns
    (output, new history)."""
    if params is None:
        params = TAAParams()
    H, W = cur.shape[:2]
    # where this pixel's world point was last frame
    px, py, ok = _project(pos_aov, prev_w2v, prev_v2c, W, H)
    ix = torch.clamp(px.to(torch.int32), 0, W - 1).long()
    iy = torch.clamp(py.to(torch.int32), 0, H - 1).long()
    in_view = (px >= 0) & (px < W) & (py >= 0) & (py < H) & ok
    hist_col = history["color"][iy, ix]
    hist_ok = history["valid"][iy, ix] & in_view & (depth_aov > 0)

    # clip the history to the current 3x3 neighbourhood's colour box
    # (the reference's neighbour-weighted clamp, taa_fs.glsl:179-252)
    mn, mx = _neighborhood_bounds(cur)
    c = 0.5 * (mn + mx)
    e = 0.5 * (mx - mn) * params.clip_gamma + 1e-6
    hist_clipped = torch.clamp(hist_col, c - e, c + e)

    a = torch.where(hist_ok, params.blend, 1.0)[..., None]
    out = a * cur + (1.0 - a) * hist_clipped
    new_hist = {"color": out, "valid": torch.ones((H, W), dtype=torch.bool, device=cur.device)}
    return out, new_hist
