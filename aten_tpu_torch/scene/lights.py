"""Light table and batched light sampling.

Counterpart of aten_tpu/scene/lights.py: area (triangle-range or
sphere), image-based (the scene's envmap, scene/envmap.py), point, spot
and directional lights, sampled per lane and selected by light type.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.envmap import sample_ibl

TWO_PI = float(np.float32(2.0 * np.pi))


class LightType(enum.IntEnum):
    AREA = 0
    IBL = 1
    DIRECTIONAL = 2
    POINT = 3
    SPOT = 4


class LightTable:
    def __init__(self):
        self.rows = []

    def add(
        self,
        ltype: LightType,
        le=(1.0, 1.0, 1.0),
        pos=(0.0, 0.0, 0.0),
        dir=(0.0, -1.0, 0.0),
        inner_angle=0.5,
        outer_angle=0.6,
        obj_kind=-1,  # 0 = triangle range, 1 = sphere, -1 = none
        tri_start=0,
        tri_count=0,
        sphere_id=-1,
        area=1.0,
    ) -> int:
        d = np.asarray(dir, np.float32)
        d = d / max(np.linalg.norm(d), 1e-20)
        self.rows.append(
            dict(
                type=int(ltype),
                le=tuple(float(c) for c in le),
                pos=tuple(float(c) for c in pos),
                dir=tuple(float(c) for c in d),
                inner_angle=float(inner_angle),
                outer_angle=float(outer_angle),
                obj_kind=int(obj_kind),
                tri_start=int(tri_start),
                tri_count=int(tri_count),
                sphere_id=int(sphere_id),
                area=float(area),
            )
        )
        return len(self.rows) - 1

    def numpy_arrays(self, tri_areas: np.ndarray):
        """Table columns; per-area-light triangle CDFs are padded to the
        widest emitter so sampling is a fixed-shape count."""
        rows = self.rows
        if not rows:
            # one dummy row so indexing stays well-formed; num_lights=0 masks it
            dummy = LightTable()
            dummy.add(LightType.POINT, le=(0.0, 0.0, 0.0))
            rows = dummy.rows
        max_tris = max([r["tri_count"] for r in rows] + [1])
        cdf = np.ones((len(rows), max_tris), np.float32)
        for i, r in enumerate(rows):
            if r["obj_kind"] == 0 and r["tri_count"] > 0:
                a = tri_areas[r["tri_start"] : r["tri_start"] + r["tri_count"]]
                c = np.cumsum(a) / max(a.sum(), 1e-20)
                cdf[i, : r["tri_count"]] = c
                cdf[i, r["tri_count"] :] = 1.0

        def col(k, dtype):
            return np.asarray([r[k] for r in rows], dtype)

        return {
            "type": col("type", np.int32),
            "le": col("le", np.float32),
            "pos": col("pos", np.float32),
            "dir": col("dir", np.float32),
            "inner_angle": col("inner_angle", np.float32),
            "outer_angle": col("outer_angle", np.float32),
            "obj_kind": col("obj_kind", np.int32),
            "tri_start": col("tri_start", np.int32),
            "tri_count": col("tri_count", np.int32),
            "sphere_id": col("sphere_id", np.int32),
            "area": col("area", np.float32),
            "tri_cdf": cdf,
        }


def _sample_area_light(scene, lrow, p, u1, uv):
    """Uniform point on the emitter's surface; pdf in area measure."""
    lights = scene["lights"]
    cdf_rows = lights["tri_cdf"][lrow["_index"]]  # [N, MT]
    k = torch.sum((u1[..., None] > cdf_rows).to(torch.int32), dim=-1)
    k = torch.minimum(torch.clamp(k, min=0),
                      torch.clamp(lrow["tri_count"] - 1, min=0))
    tidx = torch.clamp(lrow["tri_start"] + k, 0, scene["tri_v0"].shape[0] - 1).long()
    v0 = scene["tri_v0"][tidx]
    e1 = scene["tri_e1"][tidx]
    e2 = scene["tri_e2"][tidx]
    su = torch.sqrt(torch.clamp(uv[0], 1e-8, 1.0))
    b1 = (1.0 - su)[..., None]
    b2 = (uv[1] * su)[..., None]
    tri_pos = v0 + b1 * e1 + b2 * e2
    tri_nml = vm.normalize(vm.cross(e1, e2))

    sid = torch.clamp(lrow["sphere_id"], 0, scene["sph_center"].shape[0] - 1).long()
    c = scene["sph_center"][sid]
    r = scene["sph_radius"][sid][..., None]
    z = 1.0 - 2.0 * uv[0]
    s = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    phi = TWO_PI * uv[1]
    sph_nml = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    sph_pos = c + r * sph_nml

    is_tri = (lrow["obj_kind"] == 0)[..., None]
    pos = torch.where(is_tri, tri_pos, sph_pos)
    nml = torch.where(is_tri, tri_nml, sph_nml)
    to_l = pos - p
    dist = vm.length(to_l, keepdims=False)
    wi = to_l / torch.clamp(dist[..., None], min=1e-20)
    pdf_area = 1.0 / torch.clamp(lrow["area"], min=1e-20)
    false = torch.zeros_like(dist, dtype=torch.bool)
    return {
        "pos": pos,
        "nml": nml,
        "dir": wi,
        "dist": dist,
        "le": lrow["le"],
        "pdf": pdf_area,
        "singular": false,
        "infinite": false,
        "area_measure": ~false,
    }


def _sample_point_light(lrow, p):
    to_l = lrow["pos"] - p
    dist = vm.length(to_l, keepdims=False)
    wi = to_l / torch.clamp(dist[..., None], min=1e-20)
    le = lrow["le"] / torch.clamp(dist * dist, min=1e-8)[..., None]
    false = torch.zeros_like(dist, dtype=torch.bool)
    return {
        "pos": lrow["pos"],
        "nml": -wi,
        "dir": wi,
        "dist": dist,
        "le": le,
        "pdf": torch.ones_like(dist),
        "singular": ~false,
        "infinite": false,
        "area_measure": false,
    }


def _sample_spot_light(lrow, p):
    base = _sample_point_light(lrow, p)
    cos_dir = vm.dot(-base["dir"], lrow["dir"], keepdims=False)
    cos_in = torch.cos(lrow["inner_angle"])
    cos_out = torch.cos(lrow["outer_angle"])
    t = torch.clamp((cos_dir - cos_out) / torch.clamp(cos_in - cos_out, min=1e-6), 0.0, 1.0)
    falloff = t * t * (3.0 - 2.0 * t)
    return dict(base, le=base["le"] * falloff[..., None])


def _sample_directional_light(lrow, p):
    wi = -lrow["dir"]
    shape = p.shape[:-1]
    big = torch.full(shape, 1e30, dtype=torch.float32, device=p.device)
    false = torch.zeros(shape, dtype=torch.bool, device=p.device)
    return {
        "pos": p + wi * 1e30,
        "nml": lrow["dir"],
        "dir": wi,
        "dist": big,
        "le": lrow["le"],
        "pdf": torch.ones(shape, dtype=torch.float32, device=p.device),
        "singular": ~false,
        "infinite": ~false,
        "area_measure": false,
    }


def sample_light(scene, light_idx, p, u1, uv):
    """Sample light `light_idx` [N] from points p [N,3]; per-lane select
    over the light type."""
    lights = scene["lights"]
    li = torch.clamp(light_idx, 0, lights["type"].shape[0] - 1).long()
    lrow = {k: v[li] for k, v in lights.items() if k != "tri_cdf"}
    lrow["_index"] = li
    ltype = lrow["type"]

    res_area = _sample_area_light(scene, lrow, p, u1, uv)
    res_point = _sample_point_light(lrow, p)
    res_spot = _sample_spot_light(lrow, p)
    res_dir = _sample_directional_light(lrow, p)
    # without an envmap an IBL row takes the directional result, as in
    # the reference
    res_ibl = sample_ibl(scene, p, uv) if "envmap" in scene else res_dir

    def sel(key):
        vals = [res_area[key], res_ibl[key], res_dir[key], res_point[key], res_spot[key]]
        out = vals[0]
        for t, v in enumerate(vals[1:], start=1):
            m = ltype == t
            if out.ndim > m.ndim:
                m = m[..., None]
            out = torch.where(m, v, out)
        return out

    return {k: sel(k) for k in res_area}
