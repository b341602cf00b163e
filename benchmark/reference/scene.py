"""The reference's scene: a builder with the scene-description interface
the benchmark's configurations drive, frozen into plain tensors.

It takes the same calls as the program's builder (add_material,
add_mesh, add_quad, add_sphere, add_area_light_tris, set_envmap,
set_background), so the benchmark hands both sides one description.  It
keeps the material defaults of the path tracer's material table, the
triangle-area CDF of each area light, the envmap's alias table, and its
own tree (walk.py).  `build` puts every float in the run's floating type.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import bsdf, lights, walk
from benchmark.reference.vecmath import ftype

# the material fields the shading reads, and their defaults
SCALAR_FIELDS = dict(
    roughness=0.25, ior=1.5, subsurface=0.0, metallic=0.0, specular=0.5,
    specular_tint=0.0, sheen=0.0, sheen_tint=0.5, clearcoat=0.0, clearcoat_gloss=1.0,
    clearcoat_ior=3.0, clearcoat_roughness=0.25, flake_scale=400.0, flake_size=0.25,
    flake_size_variance=0.7, flake_normal_orientation=0.5, flake_color_multiplier=1.0,
)
VEC_FIELDS = dict(clearcoat_color=(1.0, 1.0, 1.0), flakes_color=(1.0, 1.0, 0.0))


class ReferenceScene:
    """The frozen scene: tensors, a few counts, and the tree."""

    def __init__(self, arrays, static):
        self.arrays = arrays
        self.static = static

    def __getitem__(self, k):
        return self.arrays[k] if k in self.arrays else self.static[k]

    def __contains__(self, k):
        return k in self.arrays or k in self.static

    def with_fields(self, materials=None, lights_=None):
        """A scene sharing every tensor but the material and light tables
        given (for the trained fields)."""
        arrays = dict(self.arrays)
        if materials is not None:
            arrays["materials"] = materials
        if lights_ is not None:
            arrays["lights"] = lights_
        return ReferenceScene(arrays, self.static)


class Builder:
    def __init__(self):
        self.materials = []
        self.pos, self.nml, self.uv, self.faces, self.fmtl = [], [], [], [], []
        self.nverts = 0
        self.nfaces = 0
        self.tri_light = {}
        self.spheres = []
        self.light_rows = []
        self.envmap = None
        self.bg = (0.0, 0.0, 0.0)

    def add_material(self, mtype, base_color=(1.0, 1.0, 1.0), **kw):
        row = {"type": int(mtype), "base_color": tuple(float(c) for c in base_color)}
        for k, v in SCALAR_FIELDS.items():
            row[k] = float(kw.pop(k, v))
        for k, v in VEC_FIELDS.items():
            row[k] = tuple(float(c) for c in kw.pop(k, v))
        if kw:
            raise ValueError(f"the reference shades no material fields {sorted(kw)}")
        self.materials.append(row)
        return len(self.materials) - 1

    def add_mesh(self, pos, faces, mtl_id, nml=None, uv=None):
        pos = np.asarray(pos, np.float32).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        if nml is None:
            nml = np.zeros_like(pos)
            fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]], pos[faces[:, 2]] - pos[faces[:, 0]])
            fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
            for a in range(3):
                np.add.at(nml, faces[:, a], fn)
            nml = nml / np.maximum(np.linalg.norm(nml, axis=1, keepdims=True), 1e-20)
        self.pos.append(pos)
        self.nml.append(np.asarray(nml, np.float32).reshape(-1, 3))
        self.uv.append(np.zeros((len(pos), 2), np.float32) if uv is None
                       else np.asarray(uv, np.float32).reshape(-1, 2))
        self.faces.append(faces + self.nverts)
        self.fmtl.append(np.full(len(faces), mtl_id, np.int64))
        self.nverts += len(pos)
        start = self.nfaces
        self.nfaces += len(faces)
        return start, len(faces)

    def add_quad(self, p0, p1, p2, p3, mtl_id):
        return self.add_mesh(np.asarray([p0, p1, p2, p3], np.float32), [[0, 1, 2], [0, 2, 3]],
                             mtl_id)

    def add_sphere(self, center, radius, mtl_id):
        self.spheres.append((*map(float, center), float(radius), int(mtl_id)))
        return len(self.spheres) - 1

    def add_area_light_tris(self, tri_start, tri_count, le):
        pos = np.concatenate(self.pos)
        faces = np.concatenate(self.faces)
        area = 0.0
        for t in range(tri_start, tri_start + tri_count):
            i0, i1, i2 = faces[t]
            area += 0.5 * np.linalg.norm(np.cross(pos[i1] - pos[i0], pos[i2] - pos[i0]))
        self.light_rows.append({"type": lights.AREA, "le": tuple(map(float, le)),
                                "tri_start": tri_start, "tri_count": tri_count,
                                "area": float(area)})
        for t in range(tri_start, tri_start + tri_count):
            self.tri_light[t] = len(self.light_rows) - 1
        return len(self.light_rows) - 1

    def set_envmap(self, img):
        self.envmap = np.asarray(img, np.float32)
        self.light_rows.append({"type": lights.IBL, "le": (1.0, 1.0, 1.0), "tri_start": 0,
                                "tri_count": 0, "area": 1.0})

    def set_background(self, color):
        self.bg = tuple(float(c) for c in color)

    def build(self, device):
        f = ftype()
        pos = np.concatenate(self.pos)
        vn = np.concatenate(self.nml)
        vuv = np.concatenate(self.uv)
        faces = np.concatenate(self.faces)
        i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
        tv0, te1, te2 = pos[i0], pos[i1] - pos[i0], pos[i2] - pos[i0]
        tarea = 0.5 * np.linalg.norm(np.cross(te1, te2), axis=1)
        tlight = np.full(len(faces), -1, np.int64)
        for t, lid in self.tri_light.items():
            tlight[t] = lid
        if self.spheres:
            sph = np.asarray(self.spheres, np.float64)
            sc, sr, smtl = sph[:, :3].astype(np.float32), sph[:, 3].astype(np.float32), sph[:, 4]
        else:
            sc, sr, smtl = np.zeros((1, 3), np.float32), np.zeros(1, np.float32), np.zeros(1)
        p0, p1, p2 = tv0, tv0 + te1, tv0 + te2
        bmin = [np.minimum(np.minimum(p0, p1), p2)]
        bmax = [np.maximum(np.maximum(p0, p1), p2)]
        if self.spheres:
            bmin.append(sc - sr[:, None])
            bmax.append(sc + sr[:, None])
        tree = walk.build_tree(np.concatenate(bmin), np.concatenate(bmax))

        def fl(x):
            return torch.tensor(np.asarray(x, np.float32), dtype=f, device=device)

        def ii(x):
            return torch.tensor(np.asarray(x, np.int64), device=device)

        rows = self.materials
        mats = {"type": ii([r["type"] for r in rows]),
                "base_color": fl([r["base_color"] for r in rows])}
        for k in list(SCALAR_FIELDS) + list(VEC_FIELDS):
            mats[k] = fl([r[k] for r in rows])
        lrows = self.light_rows
        max_tris = max([r["tri_count"] for r in lrows] + [1])
        cdf = np.ones((len(lrows), max_tris), np.float32)
        for i, r in enumerate(lrows):
            if r["tri_count"]:
                a = tarea[r["tri_start"]:r["tri_start"] + r["tri_count"]]
                cdf[i, :r["tri_count"]] = np.cumsum(a) / max(a.sum(), 1e-20)
        lts = {"type": ii([r["type"] for r in lrows]), "le": fl([r["le"] for r in lrows]),
               "tri_start": ii([r["tri_start"] for r in lrows]),
               "tri_count": ii([r["tri_count"] for r in lrows]),
               "area": fl([r["area"] for r in lrows]), "tri_cdf": fl(cdf)}
        arrays = {
            "tri_v0": fl(tv0), "tri_e1": fl(te1), "tri_e2": fl(te2),
            "tri_n0": fl(vn[i0]), "tri_n1": fl(vn[i1]), "tri_n2": fl(vn[i2]),
            "tri_uv0": fl(vuv[i0]), "tri_uv1": fl(vuv[i1]), "tri_uv2": fl(vuv[i2]),
            "tri_mtl": ii(np.concatenate(self.fmtl)), "tri_light": ii(tlight),
            "sph_center": fl(sc), "sph_radius": fl(sr), "sph_mtl": ii(smtl),
            "materials": mats, "lights": lts, "bg": fl(self.bg),
            "tree": {"depth": tree["depth"], "node_bmin": fl(tree["node_bmin"]),
                     "node_bmax": fl(tree["node_bmax"]),
                     "leaf_prims": ii(tree["leaf_prims"])},
        }
        if self.envmap is not None:
            env = lights.build_env_tables(self.envmap)
            arrays.update({"envmap": fl(env["envmap"]), "env_weight": fl(env["env_weight"]),
                           "env_cut": fl(env["env_cut"]), "env_alias": ii(env["env_alias"]),
                           "env_payload": fl(env["env_payload"])})
        used = {r["type"] for r in rows} | {bsdf.DIFFUSE}
        static = {"num_tris": len(faces), "num_spheres": len(self.spheres),
                  "num_lights": len(lrows), "used": frozenset(used)}
        return ReferenceScene(arrays, static)
