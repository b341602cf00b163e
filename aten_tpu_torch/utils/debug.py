"""Observability: AOV debug views, pixel picking, traversal heatmaps.

Counterpart of aten_tpu/utils/debug.py:21-97 (the reference renderer's
SVGF AOV views, its pixel picking and PathTimeProfiler's per-ray time
heatmap).  As in the reference, the heatmap's per-ray cost is the
traversal's node-step count: the oracle walk's `steps`
(accel/traverse.py::_traverse_plain), or on a card the same numbers from
the K1 kernel's kStats instantiation.
"""
from __future__ import annotations

import numpy as np
import torch


def _id_colors(ids):
    """Stable pseudo-random colour per id (negative -> black)."""
    x = (ids.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    r = ((x >> 16) & 0xFF).to(torch.float32) / 255.0
    g = ((x >> 8) & 0xFF).to(torch.float32) / 255.0
    b = (x & 0xFF).to(torch.float32) / 255.0
    col = torch.stack([r, g, b], dim=-1)
    return torch.where((ids >= 0)[..., None], col, 0.0)


def aov_debug_image(aovs, mode):
    """An AOV debug view [H, W, 3] in display range [0, 1].

    modes: normal | depth | albedo | prim_id | mtl_id | position
    """
    if mode == "normal":
        return aovs["normal"] * 0.5 + 0.5
    if mode == "albedo":
        return torch.clamp(aovs["albedo"], 0.0, 1.0)
    if mode == "depth":
        d = aovs["depth"]
        valid = d > 0
        dmax = torch.max(torch.where(valid, d, 0.0))
        x = torch.where(valid, d / torch.clamp(dmax, min=1e-6), 1.0)
        return (1.0 - x)[..., None].repeat_interleave(3, dim=-1)
    if mode == "prim_id":
        return _id_colors(aovs["prim"])
    if mode == "mtl_id":
        return _id_colors(aovs["mtl"])
    if mode == "position":
        p = aovs["pos"]
        lo = torch.amin(p, dim=(0, 1), keepdim=True)
        hi = torch.amax(p, dim=(0, 1), keepdim=True)
        return (p - lo) / torch.clamp(hi - lo, min=1e-6)
    raise ValueError(f"unknown AOV debug mode '{mode}'")


def pick_pixel(img, aovs, x, y):
    """The G-buffer under a pixel (SVGF pixel picking), as numpy and
    Python numbers."""
    return {
        "color": np.asarray(img[y, x].cpu()),
        "normal": np.asarray(aovs["normal"][y, x].cpu()),
        "depth": float(aovs["depth"][y, x]),
        "prim_id": int(aovs["prim"][y, x]),
        "mtl_id": int(aovs["mtl"][y, x]),
        "position": np.asarray(aovs["pos"][y, x].cpu()),
    }


def temperature(x):
    """[0, 1] -> blue..red temperature ramp (ComputeTemperature,
    path_time_profiler.h:63-97 style piecewise ramp)."""
    x = torch.clamp(x, 0.0, 1.0)[..., None]
    # blue -> cyan -> green -> yellow -> red
    r = torch.clamp(torch.where(x < 0.5, 0.0, (x - 0.5) * 4.0), 0.0, 1.0)
    g = torch.clamp(
        torch.where(x < 0.25, x * 4.0, torch.where(x < 0.75, 1.0, (1.0 - x) * 4.0)),
        0.0, 1.0,
    )
    b = torch.clamp(torch.where(x < 0.25, 1.0, 1.0 - (x - 0.25) * 4.0), 0.0, 1.0)
    return torch.cat([r, g, b], dim=-1)


def traversal_steps(scene, ro, rd, impl="plain"):
    """Each ray's node steps [N] int32: the oracle walk's `steps`
    (impl "plain", the reference's impl "jax"), or K1's kStats counts
    (impl "cuda": the kernel on a card, its plain version on the CPU),
    which on a scene without voxel LOD are the same numbers."""
    if impl == "cuda":
        from aten_tpu_torch.accel.traverse import _t0_of
        from aten_tpu_torch.ops.traverse_cuda import bvh_traverse

        ro, rd = ro.contiguous(), rd.contiguous()
        t0 = _t0_of(None, ro.shape[0], ro.device)
        return bvh_traverse(scene, ro, rd, t0, stats=True)[4]["node_steps"]
    from aten_tpu_torch.accel.traverse import traverse

    steps = traverse(scene, ro, rd, impl=impl).get("steps")
    return torch.zeros(ro.shape[0], dtype=torch.int32, device=ro.device) if steps is None \
        else steps


def traversal_heatmap(scene, ro, rd, width, height, impl="plain"):
    """Primary-ray traversal cost heatmap [H, W, 3] (the per-ray time
    profile heatmap analogue): each ray's node steps over the most of any
    ray, through `temperature`."""
    s = traversal_steps(scene, ro, rd, impl).to(torch.float32)
    norm = s / torch.clamp(torch.max(s), min=1.0)
    return temperature(norm.reshape(height, width))
