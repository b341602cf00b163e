"""Wavefront .obj / .mtl loading into the SceneBuilder registry.

Counterpart of aten_tpu/scene/objloader.py, which it follows line for
line so both packages build the same arrays from one file: v/vn/vt/f
records, negative indices, polygon fan triangulation, `usemtl` groups
split into one mesh per material, a material-override callback, and the
.mtl records Kd/Ks/Ke/Ni/Ns/d/map_Kd/map_bump, textures loaded once per
file through io/image.py.
"""
from __future__ import annotations

import os

import numpy as np

from aten_tpu_torch.io.image import load_texture
from aten_tpu_torch.scene.materials import MaterialType


def parse_mtl(path):
    """Parse a .mtl file -> {name: {kd, ks, ke, ni, ns, d}}."""
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="ignore") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0].lower()
            if key == "newmtl":
                cur = {"kd": (0.7, 0.7, 0.7), "ks": (0, 0, 0), "ke": (0, 0, 0),
                       "ni": 1.5, "ns": 0.0, "d": 1.0, "map_kd": None}
                mats[tok[1] if len(tok) > 1 else ""] = cur
            elif cur is None:
                continue
            elif key in ("kd", "ks", "ke") and len(tok) >= 4:
                cur[key] = tuple(float(x) for x in tok[1:4])
            elif key in ("ni", "ns", "d") and len(tok) >= 2:
                cur[key] = float(tok[1])
            elif key == "map_kd" and len(tok) >= 2:
                cur["map_kd"] = tok[-1]
            elif key in ("map_bump", "bump", "norm") and len(tok) >= 2:
                cur["map_bump"] = tok[-1]
    return mats


def _mtl_to_material(builder, m, base_dir=None, tex_cache=None):
    """Heuristic .mtl -> MaterialType mapping (mirrors the reference's
    material callback defaulting to diffuse); loads map_Kd / normal maps
    into the texture table (ImageLoader role)."""
    kw = {}
    if base_dir is not None and tex_cache is not None:
        def tex_of(fname, srgb):
            if not fname:
                return -1
            p = os.path.join(base_dir, fname)
            if p not in tex_cache:
                if not os.path.exists(p):
                    tex_cache[p] = -1
                else:
                    tex_cache[p] = load_texture(builder, p, srgb_to_linear=srgb)
            return tex_cache[p]

        a = tex_of(m.get("map_kd"), True)
        if a >= 0:
            kw["albedo_map"] = a
        bump = m.get("map_bump")
        # -nml/-norm names are tangent-space normal maps; real height maps
        # would need bump2normal conversion (cli/bump2normal.py)
        if bump and ("nml" in bump.lower() or "norm" in bump.lower()):
            n = tex_of(bump, False)
            if n >= 0:
                kw["normal_map"] = n
    ke = m.get("ke", (0, 0, 0))
    if max(ke) > 0:
        return builder.add_material(MaterialType.EMISSIVE, base_color=ke)
    if m.get("d", 1.0) < 1.0:
        return builder.add_material(
            MaterialType.REFRACTION, base_color=m["kd"], ior=m.get("ni", 1.5)
        )
    ks = m.get("ks", (0, 0, 0))
    if max(ks) > 0.5 and m.get("ns", 0) > 200:
        return builder.add_material(MaterialType.SPECULAR, base_color=ks)
    if max(ks) > 0.1:
        rough = float(np.clip(np.sqrt(2.0 / (m.get("ns", 10.0) + 2.0)), 0.03, 1.0))
        return builder.add_material(
            MaterialType.GGX, base_color=m["kd"], roughness=rough,
            ior=m.get("ni", 1.5), **kw,
        )
    return builder.add_material(MaterialType.DIFFUSE, base_color=m["kd"], **kw)


def load_obj(builder, path, mtl_override=None, scale=1.0, offset=(0, 0, 0)):
    """Load an .obj into `builder`. Returns {material_name: (tri_start, count)}.

    mtl_override: optional callable(name, mtl_dict) -> material id, the
    analogue of ObjLoader's material callback (ObjLoader.h:36).
    """
    vs, vns, vts = [], [], []
    # faces grouped by material name
    groups = {}
    cur_mtl = ""
    mtl_defs = {}
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="ignore") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                vs.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vn":
                vns.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vt":
                vts.append([float(tok[1]), float(tok[2]) if len(tok) > 2 else 0.0])
            elif key == "mtllib":
                mtl_defs.update(parse_mtl(os.path.join(base_dir, tok[1])))
            elif key == "usemtl":
                cur_mtl = tok[1] if len(tok) > 1 else ""
            elif key == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = int(parts[0])
                    vi = vi - 1 if vi > 0 else len(vs) + vi
                    ti = ni = -1
                    if len(parts) > 1 and parts[1]:
                        ti = int(parts[1])
                        ti = ti - 1 if ti > 0 else len(vts) + ti
                    if len(parts) > 2 and parts[2]:
                        ni = int(parts[2])
                        ni = ni - 1 if ni > 0 else len(vns) + ni
                    corners.append((vi, ti, ni))
                g = groups.setdefault(cur_mtl, [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    g.append((corners[0], corners[k], corners[k + 1]))

    vs = np.asarray(vs, np.float32) * scale + np.asarray(offset, np.float32)
    vns_np = np.asarray(vns, np.float32) if vns else np.zeros((0, 3), np.float32)
    vts_np = np.asarray(vts, np.float32) if vts else np.zeros((0, 2), np.float32)

    result = {}
    tex_cache = {}
    for name, faces in groups.items():
        if not faces:
            continue
        if mtl_override is not None:
            mid = mtl_override(name, mtl_defs.get(name, {}))
        elif name in mtl_defs:
            mid = _mtl_to_material(builder, mtl_defs[name], base_dir, tex_cache)
        else:
            mid = builder.add_material(MaterialType.DIFFUSE, base_color=(0.7, 0.7, 0.7))
        # Expand to unique (v, vt, vn) corner records for this group.
        fa = np.asarray(
            [[c for c in tri] for tri in faces], np.int64
        )  # [F, 3, 3] (vi, ti, ni)
        corner = fa.reshape(-1, 3)
        uniq, inv = np.unique(corner, axis=0, return_inverse=True)
        pos = vs[uniq[:, 0]]
        has_n = (uniq[:, 2] >= 0).all() and len(vns_np)
        nml = vns_np[uniq[:, 2]] if has_n else None
        has_t = (uniq[:, 1] >= 0).all() and len(vts_np)
        uv = vts_np[uniq[:, 1]] if has_t else None
        tri = inv.reshape(-1, 3)
        result[name] = builder.add_mesh(pos, tri, mid, nml=nml, uv=uv)
    return result
