"""Material parameter table.

Counterpart of aten_tpu/scene/materials.py: materials are a
struct-of-arrays table, one row per material id, and shading pulls each
lane's row by plain indexing (the reference's one-hot MXU gather is a
TPU device trick the port does not need).
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class MaterialType(enum.IntEnum):
    EMISSIVE = 0
    DIFFUSE = 1
    OREN_NAYAR = 2
    SPECULAR = 3
    REFRACTION = 4
    GGX = 5
    BECKMANN = 6
    MICROFACET_REFRACTION = 7
    VELVET = 8
    RETROREFLECTIVE = 9
    CAR_PAINT = 10
    DISNEY = 11
    TOON = 12
    STYLIZED_BRDF = 13


# types with delta (singular) BSDFs, and those that carry light through
# the surface
SINGULAR_TYPES = (MaterialType.SPECULAR, MaterialType.REFRACTION)
TRANSMISSIVE_TYPES = (MaterialType.REFRACTION, MaterialType.MICROFACET_REFRACTION)

_SCALAR_FIELDS = dict(
    alpha=1.0,
    stencil=0.0,
    roughness=0.25,
    ior=1.5,
    shininess=1.0,
    subsurface=0.0,
    metallic=0.0,
    specular=0.5,
    specular_tint=0.0,
    anisotropic=0.0,
    sheen=0.0,
    sheen_tint=0.5,
    clearcoat=0.0,
    clearcoat_gloss=1.0,
    toon_type=0.0,
    toon_receive_shadow=1.0,
    toon_hl_translation_t=0.0,
    toon_hl_translation_b=0.0,
    toon_hl_scale_t=0.0,
    toon_hl_scale_b=0.0,
    toon_hl_split_t=0.0,
    toon_hl_split_b=0.0,
    toon_hl_square_sharp=1.0,
    toon_hl_square_magnitude=0.0,
    toon_rim_enable=0.0,
    toon_rim_width=0.3,
    toon_rim_softness=0.5,
    toon_rim_spread=1.0,
    toon_stylized_y_min=0.0,
    toon_stylized_y_max=1.0,
    clearcoat_ior=3.0,
    clearcoat_roughness=0.25,
    flake_scale=400.0,
    flake_size=0.25,
    flake_size_variance=0.7,
    flake_normal_orientation=0.5,
    flake_color_multiplier=1.0,
)
_VEC_FIELDS = dict(
    toon_rim_color=(1.0, 1.0, 1.0),
    clearcoat_color=(1.0, 1.0, 1.0),
    flakes_color=(1.0, 1.0, 0.0),
)
_MAP_FIELDS = ("albedo_map", "normal_map", "roughness_map", "medium",
               "toon_remap_tex", "toon_target_light")


class MaterialTable:
    """Host-side builder of the material table (same rows and columns
    as the reference's)."""

    def __init__(self):
        self.rows = []

    def add(self, mtype: MaterialType, base_color=(1.0, 1.0, 1.0), **kw) -> int:
        row = {"type": int(mtype), "base_color": tuple(float(c) for c in base_color)}
        for k, v in _SCALAR_FIELDS.items():
            row[k] = float(kw.pop(k, v))
        for k, v in _VEC_FIELDS.items():
            row[k] = tuple(float(c) for c in kw.pop(k, v))
        for k in _MAP_FIELDS:
            row[k] = int(kw.pop(k, -1))
        if kw:
            raise TypeError(f"unknown material fields: {sorted(kw)}")
        self.rows.append(row)
        return len(self.rows) - 1

    def numpy_arrays(self):
        rows = self.rows or [
            {"type": int(MaterialType.DIFFUSE), "base_color": (0.5, 0.5, 0.5),
             **_SCALAR_FIELDS, **_VEC_FIELDS,
             **{k: -1 for k in _MAP_FIELDS}}
        ]
        out = {
            "type": np.asarray([r["type"] for r in rows], np.int32),
            "base_color": np.array([r["base_color"] for r in rows], np.float32),
        }
        for k in _SCALAR_FIELDS:
            out[k] = np.asarray([r[k] for r in rows], np.float32)
        for k in _VEC_FIELDS:
            out[k] = np.array([r[k] for r in rows], np.float32)
        for k in _MAP_FIELDS:
            out[k] = np.asarray([r[k] for r in rows], np.int32)
        return out


def gather_material(mtl_arrays, mtl_id):
    """Per-lane material rows: {field: tensor[N, ...]} plus the clamped
    source id under "mtl_id"."""
    m = torch.clamp(mtl_id, 0, mtl_arrays["type"].shape[0] - 1).long()
    out = {k: v[m] for k, v in mtl_arrays.items()}
    out["mtl_id"] = m
    return out
