"""Scenes from a configuration's description, for either side.

A configuration file (configs/<name>.json) describes its scene as data:
materials, procedural meshes, quads, spheres, area lights, the
background or a procedural envmap, and the camera.  `populate` replays
the description through any builder with the scene-builder interface
(add_material, add_mesh, add_quad, add_sphere, add_area_light_tris,
set_envmap, set_background): the program's `SceneBuilder` and the
reference's `Builder` get the same calls, in the same order, on the same
arrays, which the benchmark makes here from closed forms.
"""
from __future__ import annotations

import numpy as np


def torus_knot_mesh(n_u, n_v, p, q, scale, tube, center):
    """A closed (p, q) torus-knot tube of n_u rings of n_v vertices in its
    Frenet frame: float32 positions, normals, uv and int64 faces [2 n_u n_v, 3]."""
    t = np.arange(n_u, dtype=np.float64) * (2.0 * np.pi / n_u)
    r = 2.0 + np.cos(q * t)
    c = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], -1)
    dr = -q * np.sin(q * t)
    d1 = np.stack([dr * np.cos(p * t) - p * r * np.sin(p * t),
                   dr * np.sin(p * t) + p * r * np.cos(p * t),
                   -q * np.cos(q * t)], -1)
    ddr = -q * q * np.cos(q * t)
    d2 = np.stack([ddr * np.cos(p * t) - 2 * p * dr * np.sin(p * t) - p * p * r * np.cos(p * t),
                   ddr * np.sin(p * t) + 2 * p * dr * np.cos(p * t) - p * p * r * np.sin(p * t),
                   q * q * np.sin(q * t)], -1)
    tan = d1 / np.linalg.norm(d1, axis=1, keepdims=True)
    nrm = d2 - np.sum(d2 * tan, axis=1, keepdims=True) * tan
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    bin_ = np.cross(tan, nrm)
    phi = np.arange(n_v, dtype=np.float64) * (2.0 * np.pi / n_v)
    ring = (np.cos(phi)[None, :, None] * nrm[:, None, :]
            + np.sin(phi)[None, :, None] * bin_[:, None, :])
    pos = (c[:, None, :] * scale + tube * ring) + np.asarray(center)
    iu, iv = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = iu * n_v + iv
    b = ((iu + 1) % n_u) * n_v + iv
    cc = ((iu + 1) % n_u) * n_v + (iv + 1) % n_v
    d = iu * n_v + (iv + 1) % n_v
    faces = np.concatenate([np.stack([a, b, cc], -1).reshape(-1, 3),
                            np.stack([a, cc, d], -1).reshape(-1, 3)]).astype(np.int64)
    uv = np.stack([iu / n_u, iv / n_v], -1).reshape(-1, 2)
    return (pos.reshape(-1, 3).astype(np.float32), ring.reshape(-1, 3).astype(np.float32),
            uv.astype(np.float32), faces)


def sky_sun_envmap(height, width, sun_peak, sun_theta, sun_phi, sun_width):
    """Equirect sky [height, width, 3]: a blue gradient over theta plus a
    gaussian sun of peak `sun_peak` at (sun_theta, sun_phi)."""
    th = np.linspace(0, np.pi, height)[:, None]
    ph = np.linspace(0, 2 * np.pi, width)[None, :]
    sky = np.stack([0.35 + 0.4 * np.cos(th / 2) + 0 * ph,
                    0.45 + 0.35 * np.cos(th / 2) + 0 * ph,
                    0.7 + 0.25 * np.cos(th / 2) + 0 * ph], -1)
    sun = sun_peak * np.exp(-((th - sun_theta) ** 2 + (ph - sun_phi) ** 2) / sun_width)
    return (sky + sun[..., None] * np.array([1.0, 0.9, 0.7])).astype(np.float32)


MESHES = {"torus_knot": torus_knot_mesh}
ENVMAPS = {"sky_sun": sky_sun_envmap}


def _params(d):
    return {k: v for k, v in d.items() if k not in ("kind", "material")}


def populate(b, scene, types):
    """Replay the description `scene` through builder `b`; `types` maps a
    material family's name to the builder's id.  Returns the prim count."""
    ids = {}
    for m in scene["materials"]:
        fields = {k: v for k, v in m.items() if k not in ("name", "type")}
        ids[m["name"]] = b.add_material(types[m["type"]], **fields)
    prims = 0
    for mesh in scene.get("meshes", ()):
        pos, nml, uv, faces = MESHES[mesh["kind"]](**_params(mesh))
        b.add_mesh(pos, faces, ids[mesh["material"]], nml=nml, uv=uv)
        prims += len(faces)
    for quad in scene.get("quads", ()):
        start, count = b.add_quad(*quad["corners"], ids[quad["material"]])
        prims += count
        if "light_le" in quad:
            b.add_area_light_tris(start, count, le=quad["light_le"])
    for sph in scene.get("spheres", ()):
        b.add_sphere(sph["center"], sph["radius"], ids[sph["material"]])
        prims += 1
    if "envmap" in scene:
        env = scene["envmap"]
        b.set_envmap(ENVMAPS[env["kind"]](**_params(env)))
    if "background" in scene:
        b.set_background(scene["background"])
    return prims


def camera(scene, width, height):
    """The camera description with the image size."""
    return dict(scene["camera"], width=width, height=height)
