"""Wavefront OBJ and MTL writer.

Counterpart of aten_tpu/io/obj_writer.py (a copy, writing the same
text): v/vn/vt records, per-material `usemtl` groups and an .mtl
companion from material table rows.
"""
from __future__ import annotations

import os

import numpy as np


def write_obj(path, pos, faces, nml=None, uv=None, face_mtl=None,
              mtl_names=None, mtl_path=None):
    """Write an indexed mesh.

    pos [V,3]; faces [F,3] int; optional nml [V,3], uv [V,2]; optional
    per-face material ids + names create usemtl groups and an .mtl ref.
    """
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    lines = ["# exported by aten_tpu.io.obj_writer"]
    if mtl_path:
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
    for p in pos:
        lines.append(f"v {p[0]:g} {p[1]:g} {p[2]:g}")
    if uv is not None:
        for t in np.asarray(uv, np.float32).reshape(-1, 2):
            lines.append(f"vt {t[0]:g} {t[1]:g}")
    if nml is not None:
        for n in np.asarray(nml, np.float32).reshape(-1, 3):
            lines.append(f"vn {n[0]:g} {n[1]:g} {n[2]:g}")

    def vref(i):
        i1 = i + 1
        if uv is not None and nml is not None:
            return f"{i1}/{i1}/{i1}"
        if nml is not None:
            return f"{i1}//{i1}"
        if uv is not None:
            return f"{i1}/{i1}"
        return str(i1)

    if face_mtl is None:
        for f in faces:
            lines.append(f"f {vref(f[0])} {vref(f[1])} {vref(f[2])}")
    else:
        face_mtl = np.asarray(face_mtl, np.int64)
        order = np.argsort(face_mtl, kind="stable")
        cur = None
        for fi in order:
            m = int(face_mtl[fi])
            if m != cur:
                name = mtl_names[m] if mtl_names else f"material_{m}"
                lines.append(f"usemtl {name}")
                cur = m
            f = faces[fi]
            lines.append(f"f {vref(f[0])} {vref(f[1])} {vref(f[2])}")
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def write_mtl(path, materials, names=None):
    """Write a .mtl companion from MaterialTable rows (Kd = base_color,
    Ni = ior, Ns from roughness)."""
    rows = getattr(materials, "rows", materials)
    lines = []
    for i, r in enumerate(rows):
        name = names[i] if names else f"material_{i}"
        c = r["base_color"]
        lines += [
            f"newmtl {name}",
            f"Kd {c[0]:g} {c[1]:g} {c[2]:g}",
            f"Ni {r.get('ior', 1.5):g}",
            f"Ns {max(0.0, (1.0 - r.get('roughness', 0.5)) * 1000.0):g}",
            "",
        ]
    with open(path, "w") as fp:
        fp.write("\n".join(lines))
