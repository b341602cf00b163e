"""Texture storage, mip chains and batched sampling.

Counterpart of aten_tpu/scene/textures.py.  Textures live as one padded
[T, MH, MW, 4] stack (RGBA, float32) with each texture's true size in a
side table, and a mip chain of 2x2 box reductions of the stack built on
the host in numpy, bit for bit the reference's.  Sampling is a batched
gather with bilinear filtering and wrap addressing (trilinear across two
mip levels in `sample_texture_lod`).  The three shade-time applications
multiply albedo maps into base_color, scale roughness by roughness maps,
and tilt the shading normal by tangent-space normal maps.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.core import vecmath as vm


class TextureTable:
    def __init__(self):
        self.images = []

    def add(self, img) -> int:
        """img: [H, W] or [H, W, 3|4] float array.  Returns the texture id."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        self.images.append(img)
        return len(self.images) - 1

    def numpy_arrays(self, mipmap=True) -> dict:
        """`tex_stack`, `tex_size` and, with mipmap, `tex_mip1`... as numpy."""
        if not self.images:
            return {"tex_stack": np.ones((1, 1, 1, 4), np.float32),
                    "tex_size": np.ones((1, 2), np.int32)}
        mh = max(i.shape[0] for i in self.images)
        mw = max(i.shape[1] for i in self.images)
        stack = np.zeros((len(self.images), mh, mw, 4), np.float32)
        size = np.zeros((len(self.images), 2), np.int32)
        for t, img in enumerate(self.images):
            h, w = img.shape[:2]
            stack[t, :h, :w] = img
            size[t] = (h, w)
        out = {"tex_stack": stack, "tex_size": size}
        if mipmap and min(mh, mw) >= 2:
            level = stack
            lv = 1
            while min(level.shape[1], level.shape[2]) >= 2:
                h2, w2 = level.shape[1] // 2, level.shape[2] // 2
                level = level[:, : 2 * h2, : 2 * w2].reshape(
                    len(self.images), h2, 2, w2, 2, 4).mean(axis=(2, 4))
                out[f"tex_mip{lv}"] = level
                lv += 1
        return out


def num_mip_levels(tex):
    """Levels of the chain in `tex` (a scene or a table dict); 1 = base only."""
    lv = 1
    while f"tex_mip{lv}" in tex:
        lv += 1
    return lv


def _bilinear(stack, tid, h, w, u, v):
    """Bilinear, wrap-addressed fetch from one level of the stack; tid
    [N] int64, h and w [N] float (the level's true size)."""
    MH, MW, C = stack.shape[1], stack.shape[2], stack.shape[3]
    flat = stack.reshape(stack.shape[0] * MH * MW, C)
    base = tid * (MH * MW)
    # floor modulo: wrapped and negative uvs fetch the wrapped texel
    uu = torch.remainder(u, 1.0)
    vv = torch.remainder(1.0 - torch.remainder(v, 1.0), 1.0)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wc = torch.clamp(w, min=1.0)
    hc = torch.clamp(h, min=1.0)

    def fetch(xi, yi):
        xi = torch.remainder(xi, wc).to(torch.int32).long()
        yi = torch.remainder(yi, hc).to(torch.int32).long()
        return flat[base + yi * MW + xi]

    return (fetch(x0, y0) * (1 - fx) * (1 - fy)
            + fetch(x0 + 1, y0) * fx * (1 - fy)
            + fetch(x0, y0 + 1) * (1 - fx) * fy
            + fetch(x0 + 1, y0 + 1) * fx * fy)


def _texture_ids(tex, tex_id):
    return torch.clamp(tex_id, 0, tex["tex_stack"].shape[0] - 1).long()


def sample_texture(tex, tex_id, u, v, default=1.0):
    """Bilinear fetch of level 0; tex_id [N] (-1 gives `default`).
    Returns rgba [N, 4]."""
    size = tex["tex_size"]
    tid = _texture_ids(tex, tex_id)
    h = size[:, 0][tid].to(torch.float32)
    w = size[:, 1][tid].to(torch.float32)
    c = _bilinear(tex["tex_stack"], tid, h, w, u, v)
    return torch.where((tex_id >= 0)[..., None], c, torch.full_like(c, default))


def sample_texture_lod(tex, tex_id, u, v, lod, default=1.0):
    """Trilinear fetch: bilinear at the mip levels floor(lod) and the one
    above, blended by lod's fraction; lod [N] float (0 = base).  A table
    without mips samples level 0."""
    L = num_mip_levels(tex)
    if L <= 1:
        return sample_texture(tex, tex_id, u, v, default)
    size = tex["tex_size"]
    tid = _texture_ids(tex, tex_id)
    h0 = size[:, 0][tid].to(torch.float32)
    w0 = size[:, 1][tid].to(torch.float32)
    lod = torch.clamp(lod, 0.0, L - 1.0)
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]

    levels = [tex["tex_stack"]] + [tex[f"tex_mip{lv}"] for lv in range(1, L)]
    per_level = torch.stack([
        _bilinear(st, tid,
                  torch.clamp(torch.floor(h0 / (1 << lv)), min=1.0),
                  torch.clamp(torch.floor(w0 / (1 << lv)), min=1.0), u, v)
        for lv, st in enumerate(levels)])  # [L, N, 4]
    idx0 = l0.to(torch.int64)
    idx1 = torch.clamp(idx0 + 1, max=L - 1)
    lane = torch.arange(per_level.shape[1], device=per_level.device)
    c = per_level[idx0, lane] * (1 - frac) + per_level[idx1, lane] * frac
    return torch.where((tex_id >= 0)[..., None], c, torch.full_like(c, default))


def footprint_lod(tex, tex_id, t, pixel_spread):
    """Isotropic LOD from hit distance: log2(t * pixel_spread * size),
    at least 0."""
    size = tex["tex_size"]
    tid = _texture_ids(tex, tex_id)
    wmax = torch.maximum(size[:, 0], size[:, 1])[tid].to(torch.float32)
    fp = torch.clamp(t * pixel_spread, min=1e-8)
    return torch.clamp(torch.log2(fp * wmax), min=0.0)


def apply_albedo(scene, mat, uv):
    """`mat` with albedo maps multiplied into base_color and their alpha
    under "tex_alpha"."""
    if "tex_stack" not in scene or not scene.get("has_albedo_maps", True):
        return mat
    rgba = sample_texture(scene, mat["albedo_map"], uv[..., 0], uv[..., 1], default=1.0)
    mat = dict(mat)
    mat["base_color"] = mat["base_color"] * rgba[..., :3]
    mat["tex_alpha"] = rgba[..., 3]
    return mat


def apply_normal_map(scene, mat, ns, uv):
    """The shading normal tilted by tangent-space normal maps."""
    if "tex_stack" not in scene or not scene.get("has_normal_maps", True):
        return ns
    rgba = sample_texture(scene, mat["normal_map"], uv[..., 0], uv[..., 1], default=0.5)
    nm = rgba[..., :3] * 2.0 - 1.0
    t, b = vm.onb(ns)
    perturbed = vm.normalize(nm[..., 0:1] * t + nm[..., 1:2] * b + nm[..., 2:3] * ns)
    return torch.where((mat["normal_map"] >= 0)[..., None], perturbed, ns)


def apply_roughness_map(scene, mat, uv):
    """`mat` with roughness scaled by roughness maps (their red channel)."""
    if "tex_stack" not in scene or not scene.get("has_roughness_maps", True):
        return mat
    rgba = sample_texture(scene, mat["roughness_map"], uv[..., 0], uv[..., 1], default=1.0)
    mat = dict(mat)
    has = mat["roughness_map"] >= 0
    mat["roughness"] = torch.where(has, mat["roughness"] * rgba[..., 0], mat["roughness"])
    return mat
