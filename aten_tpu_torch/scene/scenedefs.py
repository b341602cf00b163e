"""Built-in test scenes.

Counterpart of aten_tpu/scene/scenedefs.py.  Each scene is a `populate_*`
function that fills any builder with the reference builder's interface
(add_material, add_mesh, add_quad, add_sphere, add_area_light_tris,
set_background, set_envmap) and returns the camera, plus a wrapper that builds the
port's Scene on a device, the card unless the caller names the CPU.  The tests hand the same populate
functions the reference `aten_tpu` builder, so both packages hold the
identical scene.  The asset scenes at the end (`obj_cornell_box`,
`dragon_scene`, `sponza_scene`, `crytek_class_scene`) read the
reference's asset tree `REF_ASSET_DIR` through scene/objloader.py.
"""
from __future__ import annotations

import os

import numpy as np

from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.io.image import load_image
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.objloader import _mtl_to_material, load_obj
from aten_tpu_torch.scene.scene import SceneBuilder


def populate_cornell_box(b, width, height, use_spheres=True):
    """The classic Cornell box (reference scenedefs.py:17)."""
    white = b.add_material(MaterialType.DIFFUSE, base_color=(0.73, 0.73, 0.73))
    red = b.add_material(MaterialType.DIFFUSE, base_color=(0.65, 0.05, 0.05))
    green = b.add_material(MaterialType.DIFFUSE, base_color=(0.12, 0.45, 0.15))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(36.0, 33.0, 26.0))
    mirror = b.add_material(MaterialType.SPECULAR, base_color=(0.99, 0.99, 0.99))
    glass = b.add_material(MaterialType.REFRACTION, base_color=(0.99, 0.99, 0.99), ior=1.5)

    s = 1.0  # half-size
    b.add_quad([-s, -s, s], [s, -s, s], [s, -s, -s], [-s, -s, -s], white)
    b.add_quad([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s], white)
    b.add_quad([-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s], white)
    b.add_quad([-s, -s, s], [-s, -s, -s], [-s, s, -s], [-s, s, s], red)
    b.add_quad([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s], green)
    l = 0.35
    ls, lc = b.add_quad(
        [-l, s - 1e-3, l], [-l, s - 1e-3, -l], [l, s - 1e-3, -l], [l, s - 1e-3, l], emit
    )
    b.add_area_light_tris(ls, lc, le=(36.0, 33.0, 26.0))
    if use_spheres:
        b.add_sphere((-0.42, -0.65, -0.30), 0.35, mirror)
        b.add_sphere((0.45, -0.65, 0.30), 0.35, glass)
    return PinholeCamera(
        origin=(0.0, 0.0, 3.45), lookat=(0.0, 0.0, 0.0), vfov_deg=45.0,
        width=width, height=height,
    )


def cornell_box(width=512, height=512, use_spheres=True, *, device="cuda"):
    b = SceneBuilder()
    cam = populate_cornell_box(b, width, height, use_spheres)
    return b.build(device), cam


def populate_material_test_scene(b, width, height, envmap=None):
    """The material zoo (reference scenedefs.py:59): a diffuse floor and
    one unit sphere per BRDF family, eleven in a row, under a quad area
    light and a blue-grey background, or under the envmap `envmap`
    ([H, W, 3]) and its image-based light."""
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.6, 0.6, 0.6))
    mats = [
        b.add_material(MaterialType.DIFFUSE, base_color=(0.7, 0.3, 0.3)),
        b.add_material(MaterialType.OREN_NAYAR, base_color=(0.7, 0.6, 0.2), roughness=0.8),
        b.add_material(MaterialType.SPECULAR, base_color=(0.95, 0.95, 0.95)),
        b.add_material(MaterialType.REFRACTION, base_color=(0.98, 0.98, 0.98), ior=1.5),
        b.add_material(MaterialType.GGX, base_color=(0.9, 0.7, 0.3), roughness=0.25, ior=2.0),
        b.add_material(MaterialType.BECKMANN, base_color=(0.3, 0.6, 0.9), roughness=0.35,
                       ior=2.0),
        b.add_material(MaterialType.VELVET, base_color=(0.6, 0.2, 0.5), roughness=0.4),
        b.add_material(MaterialType.DISNEY, base_color=(0.8, 0.3, 0.2), roughness=0.35,
                       metallic=0.6, sheen=0.3, clearcoat=0.5),
        b.add_material(MaterialType.MICROFACET_REFRACTION, base_color=(0.95, 0.95, 0.98),
                       roughness=0.15, ior=1.5),
        b.add_material(MaterialType.RETROREFLECTIVE, base_color=(0.9, 0.9, 0.6),
                       roughness=0.15),
        b.add_material(MaterialType.CAR_PAINT, base_color=(0.7, 0.1, 0.1), roughness=0.3),
    ]
    ext = 40.0
    b.add_quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext], floor)
    n = len(mats)
    for i, m in enumerate(mats):
        b.add_sphere(((i - (n - 1) / 2.0) * 2.2, 1.0, 0.0), 1.0, m)
    if envmap is not None:
        b.set_envmap(envmap)
    else:
        emit = b.add_material(MaterialType.EMISSIVE, base_color=(18.0, 17.0, 15.0))
        ls, lc = b.add_quad([-4, 8, 4], [-4, 8, -4], [4, 8, -4], [4, 8, 4], emit)
        b.add_area_light_tris(ls, lc, le=(18.0, 17.0, 15.0))
        b.set_background((0.25, 0.3, 0.4))
    return PinholeCamera(
        origin=(0.0, 3.5, 14.0), lookat=(0.0, 1.0, 0.0), vfov_deg=40.0,
        width=width, height=height,
    )


def material_test_scene(width=512, height=512, envmap=None, *, device="cuda"):
    """The material zoo: 15 prims with its area light, 13 with an envmap."""
    b = SceneBuilder()
    cam = populate_material_test_scene(b, width, height, envmap)
    return b.build(device), cam


def populate_toon_scene(b, width, height, stylized=False, **toon_mtl):
    """The toon fixture (reference scenedefs.py:318-356): two toon spheres,
    one on the diffuse base and one with a stylized GGX highlight, both
    keyed to one point light through a 64-texel 4-band remap ramp, the
    first with a rim light, on a diffuse floor.  `stylized` makes both
    StylizedBrdf; `toon_mtl` adds fields to both toon materials (alpha)."""
    lid = b.add_point_light((4.0, 7.0, 6.0), (420.0, 400.0, 380.0))
    ramp = np.zeros((1, 64, 3), np.float32)
    for i in range(64):
        u = (i + 0.5) / 64
        band = 0.18 if u < 0.25 else (0.45 if u < 0.55 else (0.8 if u < 0.85 else 1.0))
        ramp[0, i] = band
    remap = b.add_texture(ramp)
    mtype = MaterialType.STYLIZED_BRDF if stylized else MaterialType.TOON
    toon_d = b.add_material(
        mtype, base_color=(0.85, 0.45, 0.35),
        toon_remap_tex=remap, toon_target_light=lid,
        toon_rim_enable=1.0, toon_rim_color=(0.4, 0.45, 0.7),
        toon_rim_width=0.35, toon_rim_softness=0.4, toon_rim_spread=1.0, **toon_mtl,
    )
    toon_s = b.add_material(
        mtype, base_color=(0.4, 0.55, 0.9),
        toon_remap_tex=remap, toon_target_light=lid,
        toon_type=1.0, roughness=0.2, ior=6.0,
        toon_hl_split_t=0.25, toon_hl_square_sharp=2.0,
        toon_hl_square_magnitude=0.3, **toon_mtl,
    )
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.6, 0.6, 0.6))
    ext = 20.0
    b.add_quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext], floor)
    b.add_sphere((-1.4, 1.2, 0.0), 1.2, toon_d)
    b.add_sphere((1.4, 1.2, 0.0), 1.2, toon_s)
    b.set_background((0.1, 0.12, 0.16))
    return PinholeCamera(
        origin=(0.0, 2.5, 8.0), lookat=(0.0, 1.2, 0.0), vfov_deg=40.0,
        width=width, height=height,
    )


def toon_scene(width=512, height=512, stylized=False, *, device="cuda"):
    """The toon fixture: 4 prims (two floor triangles, two spheres), one
    point light, a 1x64 remap texture."""
    b = SceneBuilder()
    cam = populate_toon_scene(b, width, height, stylized)
    return b.build(device), cam


def sky_envmap(height=64, width=128):
    """The procedural sky-and-sun equirect map of the reference bench's
    material-zoo IBL config (bench.py:208-216): a blue gradient over
    theta plus a gaussian sun of peak 60 near theta 0.9, phi 1.2."""
    th = np.linspace(0, np.pi, height)[:, None]
    ph = np.linspace(0, 2 * np.pi, width)[None, :]
    sky = np.stack([
        0.35 + 0.4 * np.cos(th / 2) + 0 * ph,
        0.45 + 0.35 * np.cos(th / 2) + 0 * ph,
        0.7 + 0.25 * np.cos(th / 2) + 0 * ph,
    ], -1)
    sun = 60.0 * np.exp(-((th - 0.9) ** 2 + (ph - 1.2) ** 2) / 0.01)
    return (sky + sun[..., None] * np.array([1.0, 0.9, 0.7])).astype(np.float32)


def texture_maps(seed=0, n=16):
    """Seeded [n, n] test maps: a two-tone checker albedo (RGB), a
    tangent-space normal map tilted up to 0.35 per axis, and a roughness
    map in [0.3, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n]
    check = ((x + y) % 2)[..., None]
    albedo = np.where(check, rng.uniform(0.6, 1.0, 3), rng.uniform(0.1, 0.4, 3))
    tilt = rng.uniform(-0.35, 0.35, (n, n, 2))
    nrm = np.concatenate([tilt, np.sqrt(1.0 - (tilt ** 2).sum(-1, keepdims=True))], -1)
    rough = rng.uniform(0.3, 1.0, (n, n))
    return (albedo.astype(np.float32), (nrm * 0.5 + 0.5).astype(np.float32),
            rough.astype(np.float32))


def populate_textured_scene(b, width, height, seed=0):
    """A GGX floor carrying an albedo, a normal and a roughness map, its uv
    running over [-1, 2] so that the maps wrap, a GGX sphere and a quad
    area light (the port's texture fixture)."""
    albedo, nrm, rough = (b.add_texture(t) for t in texture_maps(seed))
    floor = b.add_material(MaterialType.GGX, base_color=(0.9, 0.9, 0.9), roughness=0.6,
                           ior=1.8, albedo_map=albedo, normal_map=nrm, roughness_map=rough)
    ball = b.add_material(MaterialType.GGX, base_color=(0.9, 0.6, 0.3), roughness=0.3, ior=2.0)
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(20.0, 19.0, 17.0))
    e = 4.0
    b.add_mesh([[-e, 0, e], [e, 0, e], [e, 0, -e], [-e, 0, -e]], [[0, 1, 2], [0, 2, 3]], floor,
               uv=[[-1.0, -1.0], [2.0, -1.0], [2.0, 2.0], [-1.0, 2.0]])
    b.add_sphere((0.8, 0.8, -0.5), 0.8, ball)
    ls, lc = b.add_quad([-1, 5, 1], [-1, 5, -1], [1, 5, -1], [1, 5, 1], emit)
    b.add_area_light_tris(ls, lc, le=(20.0, 19.0, 17.0))
    b.set_background((0.2, 0.25, 0.3))
    return PinholeCamera(
        origin=(0.0, 3.0, 6.0), lookat=(0.0, 0.3, 0.0), vfov_deg=50.0,
        width=width, height=height,
    )


def textured_scene(width=512, height=512, seed=0, *, device="cuda"):
    """The texture fixture: 5 prims, three 16x16 maps with mip chains."""
    b = SceneBuilder()
    cam = populate_textured_scene(b, width, height, seed)
    return b.build(device), cam


def torus_knot_mesh(n_u=400, n_v=128, p=2, q=3, scale=0.65, tube=0.25,
                    center=(0.0, 1.7, 0.0)):
    """Closed (p, q) torus-knot tube: n_u rings of n_v vertices around the
    knot curve, 2*n_u*n_v triangles.  Returns float32 pos [V,3], normals
    [V,3], uv [V,2] and int64 faces [F,3], all from closed forms.

    The knot lies in the xy plane (facing a camera on +z); its frame is
    the curve's Frenet frame, well defined because a torus knot has no
    point of zero curvature.
    """
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
            + np.sin(phi)[None, :, None] * bin_[:, None, :])  # [n_u, n_v, 3]
    pos = (c[:, None, :] * scale + tube * ring) + np.asarray(center)
    iu, iv = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = iu * n_v + iv
    b = ((iu + 1) % n_u) * n_v + iv
    cc = ((iu + 1) % n_u) * n_v + (iv + 1) % n_v
    d = iu * n_v + (iv + 1) % n_v
    faces = np.concatenate([
        np.stack([a, b, cc], -1).reshape(-1, 3),
        np.stack([a, cc, d], -1).reshape(-1, 3),
    ]).astype(np.int64)
    uv = np.stack([iu / n_u, iv / n_v], -1).reshape(-1, 2)
    return (pos.reshape(-1, 3).astype(np.float32),
            ring.reshape(-1, 3).astype(np.float32),
            uv.astype(np.float32), faces)


def populate_procedural_mesh_scene(b, width, height, n_u=400, n_v=128, **knot_mtl):
    """The reference's dragon_scene (scenedefs.py:142-167) with the dragon
    replaced by a torus-knot tube of 2*n_u*n_v triangles: GGX gold mesh,
    grey floor, one quad area light, dim background.  `knot_mtl` adds
    fields to the knot's material (alpha, stencil)."""
    gold = b.add_material(
        MaterialType.GGX, base_color=(0.95, 0.75, 0.35), roughness=0.25, ior=2.5,
        **knot_mtl)
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(26.0, 25.0, 23.0))
    pos, nml, uv, faces = torus_knot_mesh(n_u, n_v)
    b.add_mesh(pos, faces, gold, nml=nml, uv=uv)
    ext = 30.0
    b.add_quad([-ext, -0.6, ext], [ext, -0.6, ext], [ext, -0.6, -ext], [-ext, -0.6, -ext], floor)
    ls, lc = b.add_quad([-4, 14, 4], [-4, 14, -4], [4, 14, -4], [4, 14, 4], emit)
    b.add_area_light_tris(ls, lc, le=(26.0, 25.0, 23.0))
    b.set_background((0.12, 0.14, 0.18))
    return PinholeCamera(
        origin=(0.0, 4.0, 14.0), lookat=(0.0, 1.5, 0.0), vfov_deg=40.0,
        width=width, height=height,
    )


def procedural_mesh_scene(width=512, height=512, n_u=400, n_v=128, *,
                          device="cuda"):
    """The slice fixture: 2*n_u*n_v + 4 prims (102,404 at the default)."""
    b = SceneBuilder()
    cam = populate_procedural_mesh_scene(b, width, height, n_u, n_v)
    return b.build(device), cam


def cutout_mask(seed=0, n=64):
    """A seeded [n, n, 4] RGBA cutout, a stand-in for a foliage card: five
    leaf-green discs whose alpha is 1 inside, 0 outside and ramps over a
    soft edge of about two texels, the colour varying per disc."""
    rng = np.random.default_rng(seed)
    y, x = (np.mgrid[0:n, 0:n] + 0.5) / n
    alpha = np.zeros((n, n))
    rgb = np.zeros((n, n, 3))
    for _ in range(5):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        r = rng.uniform(0.12, 0.22)
        a = np.clip((r - np.hypot(x - cx, y - cy)) * n / 2.0, 0.0, 1.0)
        col = np.array([0.15, 0.45, 0.1]) * rng.uniform(0.7, 1.3, 3)
        rgb = np.where((a > alpha)[..., None], col, rgb)
        alpha = np.maximum(alpha, a)
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.float32)


def populate_alpha_mesh_scene(b, width, height, n_u=400, n_v=128, seed=0):
    """The alpha fixture: the mesh scene with the knot at alpha 0.7 and 64
    alpha-mapped quads, horizontal, in four layers of a 4x4 grid of 2x2
    cards between the area light (y = 14) and the knot (y 6 to 10.5,
    each layer shifted by up to 0.4 from the seed), all taking
    `cutout_mask(seed)` as their albedo map: foliage cards, so a shadow
    ray toward the light passes through several of them.  2*n_u*n_v + 132
    prims."""
    cam = populate_procedural_mesh_scene(b, width, height, n_u, n_v, alpha=0.7)
    leaf = b.add_material(MaterialType.DIFFUSE, base_color=(1.0, 1.0, 1.0),
                          albedo_map=b.add_texture(cutout_mask(seed)))
    rng = np.random.default_rng(seed)
    uv = [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]
    for y in (6.0, 7.5, 9.0, 10.5):
        dx, dz = rng.uniform(-0.4, 0.4, 2)
        for i in range(4):
            for j in range(4):
                x0, z0 = -4.0 + 2.0 * i + dx, -4.0 + 2.0 * j + dz
                b.add_mesh([[x0, y, z0], [x0 + 2, y, z0], [x0 + 2, y, z0 + 2], [x0, y, z0 + 2]],
                           [[0, 1, 2], [0, 2, 3]], leaf, uv=uv)
    return cam


def alpha_mesh_scene(width=512, height=512, n_u=400, n_v=128, seed=0, *, device="cuda"):
    """The alpha fixture: 102,532 prims at the default, on K1."""
    b = SceneBuilder()
    cam = populate_alpha_mesh_scene(b, width, height, n_u, n_v, seed)
    return b.build(device), cam


def populate_stencil_mesh_scene(b, width, height, n_u=400, n_v=128):
    """The stencil fixture: the mesh scene with the knot ALWAYS (stencil
    2) and a red STENCIL quad (stencil 1) upright at z = 5 between the
    camera and the knot's lower left, x in [-3, 1], y in [-0.2, 3.4].
    Through the quad the camera sees the knot; where only the floor lies
    behind it, the quad shades.  2*n_u*n_v + 6 prims."""
    cam = populate_procedural_mesh_scene(b, width, height, n_u, n_v, stencil=2.0)
    portal = b.add_material(MaterialType.DIFFUSE, base_color=(0.8, 0.15, 0.1), stencil=1.0)
    b.add_quad([-3.0, -0.2, 5.0], [1.0, -0.2, 5.0], [1.0, 3.4, 5.0], [-3.0, 3.4, 5.0], portal)
    return cam


def stencil_mesh_scene(width=512, height=512, n_u=400, n_v=128, *, device="cuda"):
    """The stencil fixture: 102,406 prims at the default, on K1."""
    b = SceneBuilder()
    cam = populate_stencil_mesh_scene(b, width, height, n_u, n_v)
    return b.build(device), cam


def large_mesh_scene(width=512, height=512, n_u=1000, n_v=256, *, device="cuda"):
    """The mesh scene's setting with a knot of 2*n_u*n_v triangles:
    512,004 prims at the default, triangle-only, so its build carries the
    Plücker layout (46.89 MB of reference pools, over the 32 MB line) and
    its traversal runs kernel K3."""
    return procedural_mesh_scene(width, height, n_u, n_v, device=device)


def populate_many_light_scene(b, width, height, num_lights=126, seed=0):
    """The reference's ManyLightScene (scenedefs.py:359-379), the ReSTIR
    fixture: a diffuse floor, 25 GGX spheres on a 5x5 grid and
    `num_lights` point lights, their positions and colours drawn from
    np.random.default_rng(seed) in the reference's order."""
    rng = np.random.default_rng(seed)
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    ball = b.add_material(MaterialType.GGX, base_color=(0.8, 0.8, 0.85), roughness=0.3,
                          ior=2.0)
    ext = 20.0
    b.add_quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext], floor)
    for i in range(5):
        for j in range(5):
            b.add_sphere(((i - 2) * 3.0, 1.0, (j - 2) * 3.0), 1.0, ball)
    for _ in range(num_lights):
        p = rng.uniform([-12, 0.5, -12], [12, 6.0, 12])
        c = rng.uniform(0.2, 1.0, 3) * 4.0
        b.add_point_light(tuple(p), tuple(c))
    return PinholeCamera(
        origin=(0.0, 8.0, 22.0), lookat=(0.0, 1.0, 0.0), vfov_deg=45.0,
        width=width, height=height,
    )


def many_light_scene(width=512, height=512, num_lights=126, seed=0, *, device="cuda"):
    """The ReSTIR fixture: 27 prims (the dense test) and num_lights point
    lights."""
    b = SceneBuilder()
    cam = populate_many_light_scene(b, width, height, num_lights, seed)
    return b.build(device), cam


def _l2w(translate, rot_y=0.0, scale=(1.0, 1.0, 1.0)):
    """4x4 local-to-world T * R_y * S as float32."""
    c, s = np.cos(rot_y), np.sin(rot_y)
    r = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = translate
    return m.astype(np.float32)


def populate_instanced_mesh_scene(b, width, height, n_u=400, n_v=128):
    """The mesh scene's setting around an instanced field.

    World geometry: the grey floor, the quad area light and the dim
    background of `populate_procedural_mesh_scene`.  Object A, the
    torus-knot tube of 2*n_u*n_v triangles in object-local coordinates
    (GGX gold), stands 16 times on a 4x4 grid, each instance with its own
    rotation about y and uniform scale in [0.5, 0.8].  Object B, one
    analytic glass sphere, is instanced twice, once with a non-uniform
    scale (an ellipsoid, whose normals need the instance normal matrix).
    19 instances with the world's identity instance; 2*n_u*n_v + 5 prims.
    """
    gold = b.add_material(
        MaterialType.GGX, base_color=(0.95, 0.75, 0.35), roughness=0.25, ior=2.5
    )
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(26.0, 25.0, 23.0))
    glass = b.add_material(MaterialType.REFRACTION, base_color=(0.99, 0.99, 0.99),
                           ior=1.5)
    knot = b.create_object()
    pos, nml, uv, faces = torus_knot_mesh(n_u, n_v, center=(0.0, 0.0, 0.0))
    b.add_mesh(pos, faces, gold, nml=nml, uv=uv, obj=knot)
    ext = 30.0
    b.add_quad([-ext, -0.6, ext], [ext, -0.6, ext], [ext, -0.6, -ext], [-ext, -0.6, -ext], floor)
    ls, lc = b.add_quad([-4, 14, 4], [-4, 14, -4], [4, 14, -4], [4, 14, 4], emit)
    b.add_area_light_tris(ls, lc, le=(26.0, 25.0, 23.0))
    b.set_background((0.12, 0.14, 0.18))
    ball = b.create_object()
    b.add_sphere((0.0, 0.0, 0.0), 1.0, glass, obj=ball)

    # the knot reaches 2.2 units from its centre in x and y (tube radius
    # 0.25 around a curve of radius <= 3 * 0.65), so a centre at
    # y = -0.6 + 2.2 s sets an instance of scale s on the floor
    for k in range(16):
        i, j = divmod(k, 4)
        s = 0.5 + 0.3 * ((5 * k) % 16) / 15.0
        b.add_instance(knot, _l2w((4.5 * j - 6.75, -0.6 + 2.2 * s, 4.5 * i - 7.5),
                                  rot_y=0.4 * k - 1.3, scale=(s, s, s)))
    b.add_instance(ball, _l2w((-2.25, 0.4, 9.5)))
    b.add_instance(ball, _l2w((2.25, 0.15, 9.5), rot_y=0.6, scale=(1.5, 0.75, 0.9)))
    return PinholeCamera(
        origin=(0.0, 15.0, 24.0), lookat=(0.0, 0.0, 0.5), vfov_deg=40.0,
        width=width, height=height,
    )


def instanced_mesh_scene(width=512, height=512, n_u=400, n_v=128, *,
                         device="cuda"):
    """The instanced fixture: 19 instances over 2*n_u*n_v + 5 prims
    (102,405 at the default), 16 of them instances of the knot."""
    b = SceneBuilder()
    cam = populate_instanced_mesh_scene(b, width, height, n_u, n_v)
    return b.build(device), cam


def _add_box(b, lo, hi, mtl):
    """Axis-aligned box as 12 triangles, outward normals (reference
    scenedefs.py:246-255)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    b.add_quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1], mtl)  # +z
    b.add_quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0], mtl)  # -z
    b.add_quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1], mtl)  # +x
    b.add_quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0], mtl)  # -x
    b.add_quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0], mtl)  # +y
    b.add_quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1], mtl)  # -y


def populate_homogeneous_volume_scene(b, width, height, sigma_s=0.8, sigma_a=0.05, g=0.4):
    """Fog in a box (reference scenedefs.py:258-283): a null-boundary
    cube filled with a scattering medium, an area light above, a diffuse
    floor; 16 prims."""
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.6, 0.6, 0.6))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(24.0, 23.0, 21.0))
    med = b.add_medium(sigma_a=(sigma_a,) * 3, sigma_s=(sigma_s,) * 3, g=g)
    boundary = b.add_material(
        MaterialType.REFRACTION, base_color=(1.0, 1.0, 1.0), ior=1.0, medium=med)
    ext = 12.0
    b.add_quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext], floor)
    _add_box(b, (-3, 0.02, -3), (3, 6, 3), boundary)
    ls, lc = b.add_quad([-2, 9, 2], [-2, 9, -2], [2, 9, -2], [2, 9, 2], emit)
    b.add_area_light_tris(ls, lc, le=(24.0, 23.0, 21.0))
    b.set_background((0.05, 0.06, 0.08))
    return PinholeCamera(
        origin=(0.0, 4.0, 14.0), lookat=(0.0, 2.5, 0.0), vfov_deg=42.0,
        width=width, height=height,
    )


def homogeneous_volume_scene(width=256, height=256, sigma_s=0.8, sigma_a=0.05, g=0.4, *,
                             device="cuda"):
    b = SceneBuilder()
    cam = populate_homogeneous_volume_scene(b, width, height, sigma_s, sigma_a, g)
    return b.build(device), cam


def populate_hetero_volume_scene(b, width, height, res=48):
    """The procedural smoke ball (reference scenedefs.py:286-315), delta
    tracked through a res^3 grid in a null-boundary box; 16 prims: the
    density is a soft sphere falloff times a low-frequency ripple."""
    z, y, x = np.meshgrid(
        np.linspace(-1, 1, res), np.linspace(-1, 1, res), np.linspace(-1, 1, res),
        indexing="ij",
    )
    r = np.sqrt(x * x + y * y + z * z)
    dens = np.clip(1.0 - r, 0.0, 1.0) ** 1.5
    dens *= 0.75 + 0.25 * np.sin(6.0 * x) * np.sin(5.0 * y + 1.0) * np.sin(7.0 * z)
    dens = np.clip(dens * 2.0, 0.0, 1.0).astype(np.float32)

    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(20.0, 19.0, 18.0))
    lo, hi = (-2.0, 0.2, -2.0), (2.0, 4.2, 2.0)
    med = b.add_medium(
        sigma_a=(0.2, 0.2, 0.2), sigma_s=(3.0, 3.0, 3.0), g=0.2,
        grid=dens, grid_bmin=lo, grid_bmax=hi,
    )
    boundary = b.add_material(
        MaterialType.REFRACTION, base_color=(1.0, 1.0, 1.0), ior=1.0, medium=med)
    ext = 12.0
    b.add_quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext], floor)
    _add_box(b, lo, hi, boundary)
    ls, lc = b.add_quad([-2, 8, 2], [-2, 8, -2], [2, 8, -2], [2, 8, 2], emit)
    b.add_area_light_tris(ls, lc, le=(20.0, 19.0, 18.0))
    b.set_background((0.06, 0.07, 0.09))
    return PinholeCamera(
        origin=(0.0, 3.0, 11.0), lookat=(0.0, 2.0, 0.0), vfov_deg=42.0,
        width=width, height=height,
    )


def hetero_volume_scene(width=256, height=256, res=48, *, device="cuda"):
    b = SceneBuilder()
    cam = populate_hetero_volume_scene(b, width, height, res)
    return b.build(device), cam


# the fog box around the mesh fixture's knot (it spans x, y, z within
# +-2.2, -0.5..3.9, +-0.9; the floor lies at y = -0.6)
FOG_BOX = ((-3.0, -0.58, -2.0), (3.0, 4.5, 2.0))


def populate_fog_knot_scene(b, width, height, n_u=400, n_v=128, grid_res=None):
    """The mesh fixture (`populate_procedural_mesh_scene`) inside a
    null-boundary box of fog, 2*n_u*n_v + 16 prims: a homogeneous medium
    (sigma_s 0.15, sigma_a 0.02, g 0.3) or, with grid_res, the
    `smoke_plume(grid_res)` grid through `add_grid_medium` (sigma_s 2,
    sigma_a 0.1, g 0.3)."""
    from aten_tpu_torch.volume.grids import add_grid_medium, smoke_plume

    cam = populate_procedural_mesh_scene(b, width, height, n_u, n_v)
    lo, hi = FOG_BOX
    if grid_res is None:
        med = b.add_medium(sigma_a=(0.02,) * 3, sigma_s=(0.15,) * 3, g=0.3)
        boundary = b.add_material(
            MaterialType.REFRACTION, base_color=(1.0, 1.0, 1.0), ior=1.0, medium=med)
        _add_box(b, lo, hi, boundary)
    else:
        add_grid_medium(b, smoke_plume(grid_res), lo, hi, sigma_s=(2.0,) * 3,
                        sigma_a=(0.1,) * 3, g=0.3)
    return cam


def fog_knot_scene(width=512, height=512, n_u=400, n_v=128, grid_res=None, *, device="cuda"):
    b = SceneBuilder()
    cam = populate_fog_knot_scene(b, width, height, n_u, n_v, grid_res)
    return b.build(device), cam


# The reference's asset tree (read-only).  The scenes below read it, as
# the reference's do (scenedefs.py:114-245); where it is absent they
# raise when they open their first file.
REF_ASSET_DIR = "/root/reference/asset"


def obj_cornell_box(width=512, height=512, le=(36.0, 33.0, 26.0), *, device="cuda"):
    """The reference's ObjCornellBoxScene: asset/cornellbox/orig.obj with
    its 'light' material overridden to an emissive area light."""
    path = os.path.join(REF_ASSET_DIR, "cornellbox", "orig.obj")
    b = SceneBuilder()

    def override(name, mtl):
        if name == "light":
            return b.add_material(MaterialType.EMISSIVE, base_color=le)
        return _mtl_to_material(b, mtl) if mtl else b.add_material(
            MaterialType.DIFFUSE, base_color=(0.6, 0.6, 0.6))

    groups = load_obj(b, path, mtl_override=override)
    ls, lc = groups["light"]
    b.add_area_light_tris(ls, lc, le=le)
    cam = PinholeCamera(
        origin=(0.0, 1.0, 3.0), lookat=(0.0, 1.0, 0.0), vfov_deg=45.0,
        width=width, height=height,
    )
    return b.build(device), cam


def dragon_scene(width=512, height=512, *, device="cuda"):
    """The 100k-triangle dragon (asset/dragon/dragon.obj) on a floor."""
    b = SceneBuilder()
    gold = b.add_material(
        MaterialType.GGX, base_color=(0.95, 0.75, 0.35), roughness=0.25, ior=2.5)
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(26.0, 25.0, 23.0))
    load_obj(b, os.path.join(REF_ASSET_DIR, "dragon", "dragon.obj"),
             mtl_override=lambda n, m: gold)
    ext = 30.0
    b.add_quad([-ext, -0.6, ext], [ext, -0.6, ext], [ext, -0.6, -ext], [-ext, -0.6, -ext], floor)
    ls, lc = b.add_quad([-4, 14, 4], [-4, 14, -4], [4, 14, -4], [4, 14, 4], emit)
    b.add_area_light_tris(ls, lc, le=(26.0, 25.0, 23.0))
    b.set_background((0.12, 0.14, 0.18))
    cam = PinholeCamera(
        origin=(0.0, 4.0, 14.0), lookat=(0.0, 1.5, 0.0), vfov_deg=40.0,
        width=width, height=height,
    )
    return b.build(device), cam


def sponza_scene(width=512, height=512, *, device="cuda"):
    """asset/sponza/sponza_lod.obj (12.8k triangles) under a sun and sky."""
    b = SceneBuilder()
    load_obj(b, os.path.join(REF_ASSET_DIR, "sponza", "sponza_lod.obj"))
    b.add_directional_light((-0.35, -1.0, 0.2), le=(6.0, 5.8, 5.2))
    b.set_background((0.6, 0.75, 0.95))
    cam = PinholeCamera(
        origin=(-7.0, 2.0, 0.0), lookat=(10.0, 2.5, 0.0), vfov_deg=55.0,
        width=width, height=height,
    )
    return b.build(device), cam


def crytek_class_scene(width=512, height=512, dragons=3, *, device="cuda"):
    """The reference's stand-in for its Crytek Sponza config: the
    sponza_lod interior, `dragons` scaled dragons (~12.8k + dragons x 100k
    triangles) and two banners textured with the Crytek fabric texture
    where it is present, under a sun and sky."""
    b = SceneBuilder()
    load_obj(b, os.path.join(REF_ASSET_DIR, "sponza", "sponza_lod.obj"))
    gold = b.add_material(
        MaterialType.GGX, base_color=(0.9, 0.72, 0.38), roughness=0.3, ior=2.3)
    for i in range(dragons):
        load_obj(b, os.path.join(REF_ASSET_DIR, "dragon", "dragon.obj"),
                 mtl_override=lambda n, m: gold,
                 scale=0.45, offset=(4.0 * i - 1.0, 0.45, -1.6))
    banner_tex = os.path.join(REF_ASSET_DIR, "crytek_sponza", "sponza_fabric_blue_diff.png")
    if os.path.exists(banner_tex):
        tid = b.add_texture(load_image(banner_tex))
        bm = b.add_material(MaterialType.DIFFUSE, base_color=(1, 1, 1), albedo_map=tid)
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        for x0 in (-4.0, 2.0):
            pos = np.array([[x0, 5.0, -2.2], [x0 + 2.5, 5.0, -2.2],
                            [x0 + 2.5, 8.0, -2.2], [x0, 8.0, -2.2]], np.float32)
            b.add_mesh(pos, [[0, 1, 2], [0, 2, 3]], bm, uv=uv)
    b.add_directional_light((-0.35, -1.0, 0.2), le=(6.0, 5.8, 5.2))
    b.set_background((0.6, 0.75, 0.95))
    cam = PinholeCamera(
        origin=(-7.0, 2.0, 0.0), lookat=(10.0, 2.5, 0.0), vfov_deg=55.0,
        width=width, height=height,
    )
    return b.build(device), cam
