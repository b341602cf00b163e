"""Scene registry and the flat tensor scene.

Counterpart of aten_tpu/scene/scene.py: `SceneBuilder` is the mutable
host-side registry and `SceneBuilder.build(device)` freezes it into a
`Scene` of torch tensors on one device plus static host fields, with the
same keys, values and static flags as the reference's `SceneData`
(minus the TPU kernel layouts, which the port does not use).

A scene gets a treelet layout only where the kernel policy
(accel/traverse.py::KERNEL) runs that layout's kernel on it.  Under the
policy "smt", a single-level scene on the reference's treelet branch
(ops/trl_layout.py::uses_trl) gets the port's K4 layout (`trl_*` arrays)
and the statics `traversal` = "smt" and `trl_window`.  Under "v3" and
"plk", one on which the reference would run its Plücker treelet kernel
K3 (ops/plk_layout.py::uses_plk) gets the port's K3 layout (`plk_*`
arrays) and the statics `traversal` = "plk" and `plk_window`.  Every
other single-level scene runs the K1 kernel and gets its packed node and
prim records (ops/bvh_layout.py, `bvh_nodes` and `bvh_prims`).
`kernel_layouts` makes that choice.  `with_trl_layout` attaches the K4
layout to a built scene, for `traverse(impl="smt")` under another
policy, `with_plk_layout` K3's, for `traverse(impl="plk")`, and
`with_bvh_layout` K1's records, for `traverse(impl="cuda")` on a scene
built for K3 or K4.  On a voxel-LOD scene (accel/voxel.py) each builds
its layout from the tree baked at the scene's `lod_bake_depth`.

The drain window (the most slots a fat leaf holds) defaults to
ops/plk_layout.py's WINDOW (ATEN_TRL_WINDOW, read once at import).  As in
the reference (traverse_pallas.py:681, :2136), the build runs K3 and K4
only at that window, and K3 only where it is a power of two; a scene
whose window K3 does not take runs K1, whose walk of the uncut tree
gives the hits of the reference's drain at any window (its MT path).
`with_trl_layout(window=)` and `with_plk_layout(window=)` attach a
layout of another window, which the kernels run at that window.

Instanced objects (`create_object`, `add_instance`, `obj=` on the
geometry adds) build the two-level pool of accel/tlas.py, with the K5
kernel's packed records of it (ops/tlas_layout.py, `tl_nodes`,
`tl_insts` and `tl_prims`).

`set_envmap` adds the envmap's tables (scene/envmap.py) and, by default,
an image-based light; `add_texture` registers a texture, and the build
adds the texture stack and its mip chain (scene/textures.py) with the
statics `has_albedo_maps`, `has_roughness_maps` and `has_normal_maps`.

`build(bvh_cache=path)` takes the single-level tree from an .npz
(`save_bvh_cache` writes one) when its `prim_order` covers the scene's
prims, and builds it otherwise; the kernel policy then picks and builds
the layout from that tree as from a built one.

A tree rebuilt on the device for a posed mesh (accel/lbvh.py) is not in
preorder; it carries K1's records from the rebuild, and
`with_plk_layout`, `with_trl_layout` and `with_bvh_layout` refuse it.

`Scene.replace` swaps arrays or statics; a new tree or new geometry
drops every layout of the old one and attaches K1's records of the new
tree (an SBVH's duplicated references included, accel/build.py).

`add_medium` registers a participating medium (volume/medium.py), which
a transmissive material carries by its `medium` id; the build adds the
medium rows (`med_*`) and, with a density grid, its stack, box and
majorants (`grid_*`).
Materials with alpha below 1 or a stencil tag set the statics
`has_alpha` and `has_stencil`, which the path tracer reads.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from aten_tpu_torch.accel import traverse
from aten_tpu_torch.accel.build import LEAF_MAX, build_bvh
from aten_tpu_torch.accel.tlas import build_two_level
from aten_tpu_torch.device import resolve_device
from aten_tpu_torch.ops import bvh_layout, plk_layout, tlas_layout, trl_layout
from aten_tpu_torch.scene.envmap import build_env_tables
from aten_tpu_torch.scene.lights import LightTable, LightType
from aten_tpu_torch.scene.materials import MaterialTable, MaterialType
from aten_tpu_torch.scene.textures import TextureTable
from aten_tpu_torch.volume.medium import MediumTable


class Scene:
    """Frozen scene: dict-like access over tensors on `device` and
    static host values (counts and feature flags)."""

    def __init__(self, arrays: dict, static: dict, device: torch.device):
        self._arrays = arrays
        self._static = static
        self.device = device

    def __getitem__(self, k):
        if k in self._arrays:
            return self._arrays[k]
        return self._static[k]

    def get(self, k, default=None):
        if k in self._arrays:
            return self._arrays[k]
        return self._static.get(k, default)

    def __contains__(self, k):
        return k in self._arrays or k in self._static

    @property
    def arrays(self):
        return self._arrays

    @property
    def static(self):
        return self._static

    def replace(self, **kw):
        """A new Scene with the named statics, or arrays (tensors, numpy
        arrays or nested dicts of them, moved to the scene's device),
        replaced: the reference's SceneData.replace.  Where a value
        changes the tree (BVH_KEYS) or the geometry K1's prim records copy
        (GEOMETRY_KEYS), what was built from the old values goes: every
        kernel layout (KERNEL_PREFIXES) and its statics, and with a new
        tree the voxel-LOD annotation of the old one.  K1's records of the
        new tree are attached (`with_bvh_layout`), so the scene runs K1
        and no kernel walks a layout of the old tree.  A two-level scene's
        tree and geometry are not replaced (its K5 records would go
        stale): that raises."""
        static = {**self._static, **{k: v for k, v in kw.items() if k in self._static}}
        arrays = {**self._arrays, **to_tensors(
            {k: v for k, v in kw.items() if k not in self._static}, self.device)}
        changed = {k for k in BVH_KEYS + GEOMETRY_KEYS
                   if k in kw and not _same_tensor(self._arrays.get(k), arrays[k])}
        if not changed:
            return Scene(arrays, static, self.device)
        if static["num_instances"]:
            raise ValueError(f"replace: {sorted(changed)} of a two-level scene; rebuild it "
                             "with SceneBuilder")
        drop_arrays, drop_static = (), KERNEL_STATICS
        if changed & set(BVH_KEYS):
            from aten_tpu_torch.accel import voxel

            drop_arrays, drop_static = voxel.ARRAY_KEYS, KERNEL_STATICS + VOXEL_STATICS
        scene = Scene({k: v for k, v in arrays.items()
                       if not k.startswith(KERNEL_PREFIXES) and k not in drop_arrays},
                      {k: v for k, v in static.items() if k not in drop_static}, self.device)
        return with_bvh_layout(scene)


_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_tensor(a, b):
    """a and b have the same shape, dtype and bits."""
    if a is b:
        return True
    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        return False
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = (x.contiguous().view(_INT_OF_SIZE[x.element_size()]) for x in (a, b))
    return bool(torch.equal(a, b))


def to_tensors(arrays: dict, device):
    """A (possibly nested) dict of numpy arrays, scalars or tensors -> the
    same dict of tensors on device."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out[k] = to_tensors(v, device)
        elif torch.is_tensor(v):
            out[k] = v.to(device)
        else:
            out[k] = torch.tensor(np.asarray(v), device=device)
    return out


# the single-level BVH's arrays (accel/build.py)
BVH_KEYS = (
    "nodes_bmin", "nodes_bmax", "nodes_hit", "nodes_miss",
    "nodes_prim_start", "nodes_prim_count", "prim_order",
)
_BVH_DTYPES = {"nodes_bmin": np.float32, "nodes_bmax": np.float32}
# the geometry K1's prim records copy (ops/bvh_layout.py::prim_records)
GEOMETRY_KEYS = ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")
# the statics of a voxel-LOD annotation (accel/voxel.py)
VOXEL_STATICS = ("has_voxel_lod", "lod_bake_depth")

# the kernels' layouts, which a scene carries one of (besides K1's
# records where `with_bvh_layout` attached them), and their statics
KERNEL_PREFIXES = ("bvh_", "plk_", "trl_")
KERNEL_STATICS = ("traversal", "plk_window", "trl_window")


def without_kernel_layouts(scene: Scene) -> Scene:
    """`scene` with no kernel layout (KERNEL_PREFIXES) and none of their
    statics: the layouts of a geometry that changed."""
    return Scene({k: v for k, v in scene.arrays.items() if not k.startswith(KERNEL_PREFIXES)},
                 {k: v for k, v in scene.static.items() if k not in KERNEL_STATICS},
                 scene.device)


def host_bvh(scene: Scene, what: str) -> dict:
    """The BVH and geometry arrays of `scene`, a built single-level scene,
    as numpy, to build `what` from."""
    if scene["num_instances"]:
        raise ValueError(f"{what}: only single-level scenes have one; this one has instances")
    return {k: scene[k].detach().cpu().numpy() for k in BVH_KEYS + GEOMETRY_KEYS}


def _layout_tree(scene: Scene, what: str):
    """(tree, geometry, voxel ids) a kernel layout of `scene` is built
    from: its own BVH, or for a voxel-LOD scene the tree baked at its
    `lod_bake_depth` (ops/lod_layout.py) with its voxel leaves' ids."""
    host = host_bvh(scene, what)
    inner = host["nodes_prim_start"] < 0
    if (host["nodes_hit"][inner] != np.nonzero(inner)[0] + 1).any():
        raise ValueError(f"{what}: the scene's tree is not in preorder (an LBVH rebuilt for "
                         "a pose, which carries K1's records from its rebuild); K3's and "
                         "K4's layouts of such a tree are not built")
    if not scene.get("has_voxel_lod"):
        return host, host, None
    from aten_tpu_torch.ops.lod_layout import baked_tree

    baked, vox = baked_tree(host, scene["nodes_voxel_mtl"].cpu().numpy(),
                            scene["nodes_depth"].cpu().numpy(), scene["lod_bake_depth"],
                            scene["num_tris"] + scene["num_spheres"])
    return baked, host, vox


def kernel_layouts(bvh, geo, num_tris, vox=None):
    """(arrays, statics) of the one layout the kernel policy
    (accel/traverse.py::KERNEL) runs on a single-level scene with the
    threaded BVH `bvh` and geometry `geo` (numpy): K4's under "smt" on
    the treelet branch, K3's where `uses_plk` picks it and the default
    window is one K3 takes, else K1's records; the treelet layouts at
    the default window.  vox: the voxel ids of a tree baked for voxel
    LOD."""
    tv0, te1, te2 = geo["tri_v0"], geo["tri_e1"], geo["tri_e2"]
    sc, sr = geo["sph_center"], geo["sph_radius"]
    n_nodes, n_prims = bvh["nodes_hit"].shape[0], bvh["prim_order"].shape[0]
    treelet = trl_layout.uses_trl(n_nodes, n_prims, 0)
    if treelet and traverse.KERNEL == "smt":
        lay = trl_layout.build_trl_layout(bvh, tv0, te1, te2, sc, sr, num_tris, vox=vox)
        return ({k: lay[k] for k in trl_layout.ARRAY_KEYS},
                {"traversal": "smt", "trl_window": lay["trl_window"]})
    if treelet and traverse.KERNEL in ("v3", "plk") and plk_layout.is_k3_window(
            plk_layout.WINDOW):
        lay = plk_layout.build_plk_layout(bvh, tv0, te1, te2, num_tris, vox=vox)
        if plk_layout.uses_plk(n_nodes, n_prims, lay, traverse.KERNEL):
            return ({k: lay[k] for k in plk_layout.ARRAY_KEYS},
                    {"traversal": "plk", "plk_window": lay["plk_window"]})
    return bvh_layout.build_bvh_layout(bvh, tv0, te1, te2, sc, sr, num_tris, vox=vox), {}


def with_trl_layout(scene: Scene, window=plk_layout.WINDOW) -> Scene:
    """`scene`, a built single-level scene, with the K4 layout of its own
    BVH (of a voxel-LOD scene: its baked tree) at drain window `window`
    attached (the `trl_*` arrays and the static `trl_window`) and its
    `traversal` left as it was: for `traverse(impl="smt")` under a
    kernel policy whose build did not attach the layout, or at another
    window."""
    tree, g, vox = _layout_tree(scene, "the K4 layout")
    lay = trl_layout.build_trl_layout(tree, g["tri_v0"], g["tri_e1"], g["tri_e2"],
                                      g["sph_center"], g["sph_radius"], scene["num_tris"],
                                      vox=vox, window=window)
    arrays = {**scene.arrays,
              **to_tensors({k: lay[k] for k in trl_layout.ARRAY_KEYS}, scene.device)}
    return Scene(arrays, {**scene.static, "trl_window": lay["trl_window"]}, scene.device)


def with_plk_layout(scene: Scene, window=plk_layout.WINDOW) -> Scene:
    """`scene`, a built single-level triangle-only scene, with the K3
    layout of its own BVH (of a voxel-LOD scene: its baked tree) at drain
    window `window` attached (the `plk_*` arrays and the static
    `plk_window`) and its `traversal` left as it was: for
    `traverse(impl="plk")` on a scene whose build chose another kernel,
    or at another window."""
    tree, g, vox = _layout_tree(scene, "the K3 layout")
    lay = plk_layout.build_plk_layout(tree, g["tri_v0"], g["tri_e1"], g["tri_e2"],
                                      scene["num_tris"], vox=vox, window=window)
    if lay is None:
        raise ValueError("the K3 layout: the scene has spheres, and the Plücker test "
                         "is for triangles only")
    arrays = {**scene.arrays,
              **to_tensors({k: lay[k] for k in plk_layout.ARRAY_KEYS}, scene.device)}
    return Scene(arrays, {**scene.static, "plk_window": lay["plk_window"]}, scene.device)


def with_bvh_layout(scene: Scene) -> Scene:
    """`scene`, a built single-level scene, with K1's packed records of its
    own BVH (of a voxel-LOD scene: its baked tree) attached (`bvh_nodes`,
    `bvh_prims`) and its `traversal` left as it was: for
    `traverse(impl="cuda")` on a scene whose build chose K3 or K4."""
    tree, g, vox = _layout_tree(scene, "K1's records")
    lay = bvh_layout.build_bvh_layout(tree, g["tri_v0"], g["tri_e1"], g["tri_e2"],
                                      g["sph_center"], g["sph_radius"], scene["num_tris"],
                                      vox=vox)
    return Scene({**scene.arrays, **to_tensors(lay, scene.device)}, scene.static, scene.device)


def read_bvh_cache(path, n_prims):
    """The BVH arrays (BVH_KEYS) of the .npz at `path` if it exists and its
    prim_order covers n_prims prims, else None."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if z["prim_order"].shape[0] != n_prims:
            return None
        return {k: np.asarray(z[k], _BVH_DTYPES.get(k, np.int32)) for k in BVH_KEYS}


def save_bvh_cache(scene: Scene, path):
    """Write the BVH of `scene`, a built single-level scene, to the .npz
    `path` that `SceneBuilder.build(bvh_cache=path)` reads."""
    np.savez(path, **{k: v for k, v in host_bvh(scene, "a BVH cache").items()
                      if k in BVH_KEYS})


def check_leaf_sizes(prim_count):
    """The traversers test at most LEAF_MAX prims per leaf."""
    if int(np.max(prim_count)) > LEAF_MAX:
        raise ValueError(
            f"BVH leaf holds {int(np.max(prim_count))} prims > LEAF_MAX={LEAF_MAX}")


class SceneBuilder:
    def __init__(self):
        self.materials = MaterialTable()
        self.lights = LightTable()
        self.textures = TextureTable()
        self.media = MediumTable()
        self._vpos = []  # per-mesh [V,3] float32 chunks
        self._vnml = []
        self._vuv = []
        self._nverts = 0
        self._faces = []  # per-mesh [F,4] int64 chunks (i0, i1, i2, mtl)
        self._nfaces = 0
        self._face_mesh = []  # per-mesh [F] mesh id chunks
        self._face_obj = []  # per-mesh [F] object id chunks (-1 = world)
        self._tri_light = {}  # face index -> light id (default -1)
        self._spheres = []  # (cx, cy, cz, r, mtl_id)
        self._sph_light = []
        self._sph_obj = []
        self._mesh_counter = 0
        self._num_objects = 0
        self._instances = []  # (obj_id, l2w 4x4)
        self._envmap = None
        self._bg = (0.0, 0.0, 0.0)

    # -- materials ---------------------------------------------------------
    def add_material(self, mtype: MaterialType, **kw) -> int:
        return self.materials.add(mtype, **kw)

    def add_texture(self, img) -> int:
        """Register an [H, W] or [H, W, 3|4] image; returns its id, for a
        material's albedo_map, normal_map or roughness_map."""
        return self.textures.add(img)

    def add_medium(self, **kw) -> int:
        """Register a participating medium (MediumTable.add); a transmissive
        material carries it with add_material(..., medium=id)."""
        return self.media.add(**kw)

    # -- objects / instances (two-level TLAS/BLAS) -------------------------
    def create_object(self) -> int:
        """New instanceable object; pass it as obj= to the geometry adds,
        whose coordinates are then object-local."""
        self._num_objects += 1
        return self._num_objects - 1

    def add_instance(self, obj_id: int, l2w) -> int:
        """Instance `obj_id` with a 4x4 local-to-world transform."""
        if not 0 <= obj_id < self._num_objects:
            raise ValueError(f"no object {obj_id}")
        m = np.asarray(l2w, np.float32).reshape(4, 4)
        self._instances.append((int(obj_id), m))
        return len(self._instances) - 1

    # -- geometry ----------------------------------------------------------
    def add_sphere(self, center, radius, mtl_id: int, obj: int | None = None) -> int:
        self._spheres.append((*map(float, center), float(radius), int(mtl_id)))
        self._sph_light.append(-1)
        self._sph_obj.append(-1 if obj is None else int(obj))
        return len(self._spheres) - 1

    def add_mesh(self, pos, faces, mtl_id, nml=None, uv=None, obj=None):
        """Add an indexed triangle mesh. Returns (tri_start, tri_count).

        pos [V,3]; faces [F,3] int; mtl_id scalar or [F]; nml [V,3] or
        None (area-weighted from the faces); uv [V,2] or None; obj the
        object the faces belong to (None: world geometry).
        """
        pos = np.asarray(pos, np.float32).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        if nml is None:
            nml = np.zeros_like(pos)
            fn = np.cross(
                pos[faces[:, 1]] - pos[faces[:, 0]],
                pos[faces[:, 2]] - pos[faces[:, 0]],
            )
            fl = np.linalg.norm(fn, axis=1, keepdims=True)
            fn = fn / np.maximum(fl, 1e-20)
            for a in range(3):
                np.add.at(nml, faces[:, a], fn)
            nml = nml / np.maximum(np.linalg.norm(nml, axis=1, keepdims=True), 1e-20)
        nml = np.asarray(nml, np.float32).reshape(-1, 3)
        if uv is None:
            uv = np.zeros((len(pos), 2), np.float32)
        uv = np.asarray(uv, np.float32).reshape(-1, 2)
        base = self._nverts
        self._vpos.append(pos)
        self._vnml.append(nml)
        self._vuv.append(uv)
        self._nverts += len(pos)
        mtl = np.broadcast_to(np.asarray(mtl_id, np.int64), (len(faces),))
        self._faces.append(np.concatenate([faces + base, mtl[:, None]], axis=1))
        self._face_mesh.append(np.full(len(faces), self._mesh_counter, np.int32))
        self._face_obj.append(np.full(len(faces), -1 if obj is None else int(obj),
                                      np.int64))
        self._mesh_counter += 1
        tri_start = self._nfaces
        self._nfaces += len(faces)
        return tri_start, len(faces)

    def add_quad(self, p0, p1, p2, p3, mtl_id: int, obj=None):
        """Two-triangle quad from 4 corners (ccw). Returns (tri_start, 2)."""
        pos = np.asarray([p0, p1, p2, p3], np.float32)
        return self.add_mesh(pos, [[0, 1, 2], [0, 2, 3]], mtl_id, obj=obj)

    def _positions(self):
        return (np.concatenate(self._vpos) if self._vpos
                else np.zeros((0, 3), np.float32))

    def _face_array(self):
        return (np.concatenate(self._faces) if self._faces
                else np.zeros((0, 4), np.int64))

    # -- lights ------------------------------------------------------------
    def _face_objects(self):
        return (np.concatenate(self._face_obj) if self._face_obj
                else np.zeros(0, np.int64))

    def add_area_light_tris(self, tri_start, tri_count, le) -> int:
        if (self._face_objects()[tri_start : tri_start + tri_count] >= 0).any():
            raise ValueError(
                "area lights on instanced objects are not supported (light "
                "sampling would need per-instance L2W); add the emitter as "
                "world geometry")
        pos = self._positions()
        faces = self._face_array()
        area = 0.0
        for t in range(tri_start, tri_start + tri_count):
            i0, i1, i2, _ = faces[t]
            area += 0.5 * np.linalg.norm(
                np.cross(pos[i1] - pos[i0], pos[i2] - pos[i0])
            )
        lid = self.lights.add(
            LightType.AREA, le=le, obj_kind=0, tri_start=tri_start,
            tri_count=tri_count, area=float(area),
        )
        for t in range(tri_start, tri_start + tri_count):
            self._tri_light[t] = lid
        return lid

    def add_area_light_sphere(self, sphere_id, le) -> int:
        r = self._spheres[sphere_id][3]
        lid = self.lights.add(
            LightType.AREA, le=le, obj_kind=1, sphere_id=sphere_id,
            area=float(4.0 * np.pi * r * r),
        )
        self._sph_light[sphere_id] = lid
        return lid

    def add_point_light(self, pos, le) -> int:
        return self.lights.add(LightType.POINT, le=le, pos=pos)

    def add_spot_light(self, pos, dir, le, inner_angle, outer_angle) -> int:
        return self.lights.add(
            LightType.SPOT, le=le, pos=pos, dir=dir,
            inner_angle=inner_angle, outer_angle=outer_angle,
        )

    def add_directional_light(self, dir, le) -> int:
        return self.lights.add(LightType.DIRECTIONAL, le=le, dir=dir)

    def set_envmap(self, img, add_light=True) -> None:
        """Equirect [H, W, 3] radiance map for misses and, with add_light,
        an image-based light sampled by NEE."""
        self._envmap = np.asarray(img, np.float32)
        if add_light:
            self.lights.add(LightType.IBL)

    def set_background(self, color) -> None:
        self._bg = tuple(float(c) for c in color)

    # -- freeze ------------------------------------------------------------
    def numpy_arrays(self, bvh_cache=None):
        """(arrays, static): the scene as numpy arrays (nested dicts for
        the material and light tables) and static host values; a
        single-level tree from the .npz `bvh_cache` where it fits."""
        vpos = self._positions()
        vnml = (np.concatenate(self._vnml) if self._vnml
                else np.zeros((0, 3), np.float32))
        vuv = (np.concatenate(self._vuv) if self._vuv
               else np.zeros((0, 2), np.float32))
        faces = self._face_array()
        num_tris = len(faces)
        num_sph = len(self._spheres)
        if num_tris + num_sph == 0:
            raise ValueError("empty scene")

        if num_tris > 0:
            i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
            tv0 = vpos[i0]
            te1 = vpos[i1] - vpos[i0]
            te2 = vpos[i2] - vpos[i0]
            tn0, tn1, tn2 = vnml[i0], vnml[i1], vnml[i2]
            tuv0, tuv1, tuv2 = vuv[i0], vuv[i1], vuv[i2]
            tmtl = faces[:, 3].astype(np.int32)
            tlight = np.full(num_tris, -1, np.int32)
            for t, lid in self._tri_light.items():
                tlight[t] = lid
            tmesh = np.concatenate(self._face_mesh)
            tarea = 0.5 * np.linalg.norm(np.cross(te1, te2), axis=1)
        else:  # dummy row so indexing stays shaped
            tv0 = np.zeros((1, 3), np.float32)
            te1 = np.array([[1e-12, 0, 0]], np.float32)
            te2 = np.array([[0, 1e-12, 0]], np.float32)
            tn0 = tn1 = tn2 = np.array([[0, 0, 1]], np.float32)
            tuv0 = tuv1 = tuv2 = np.zeros((1, 2), np.float32)
            tmtl = np.zeros(1, np.int32)
            tlight = np.full(1, -1, np.int32)
            tmesh = np.full(1, -1, np.int32)
            tarea = np.zeros(1, np.float32)

        if num_sph > 0:
            sc = np.asarray([s[:3] for s in self._spheres], np.float32)
            sr = np.asarray([s[3] for s in self._spheres], np.float32)
            smtl = np.asarray([s[4] for s in self._spheres], np.int32)
            slight = np.asarray(self._sph_light, np.int32)
        else:
            sc = np.zeros((1, 3), np.float32)
            sr = np.zeros(1, np.float32)
            smtl = np.zeros(1, np.int32)
            slight = np.full(1, -1, np.int32)

        # primitive boxes: triangles, then spheres (global prim id space)
        boxes_min, boxes_max = [], []
        if num_tris > 0:
            p0 = tv0
            p1 = tv0 + te1
            p2 = tv0 + te2
            boxes_min.append(np.minimum(np.minimum(p0, p1), p2) - 1e-5)
            boxes_max.append(np.maximum(np.maximum(p0, p1), p2) + 1e-5)
        if num_sph > 0:
            boxes_min.append(sc - sr[:, None] - 1e-5)
            boxes_max.append(sc + sr[:, None] + 1e-5)
        all_bmin = np.concatenate(boxes_min)
        all_bmax = np.concatenate(boxes_max)
        k5 = None
        if self._instances:
            bvh = self._two_level(all_bmin, all_bmax)
            check_leaf_sizes(bvh["tl_pc"])
            num_instances = bvh["inst_obj"].shape[0]
            k5 = tlas_layout.build_tlas_layout(bvh, tv0, te1, te2, sc, sr, num_tris)
        else:
            bvh = read_bvh_cache(bvh_cache, all_bmin.shape[0]) if bvh_cache else None
            if bvh is None:
                bvh = build_bvh(all_bmin, all_bmax)
            check_leaf_sizes(bvh["nodes_prim_count"])
            num_instances = 0
        # each layout only where the kernel policy can run its kernel
        kernel_arrays, kernel_static = {}, {}
        if num_instances == 0:
            kernel_arrays, kernel_static = kernel_layouts(
                bvh, {"tri_v0": tv0, "tri_e1": te1, "tri_e2": te2, "sph_center": sc,
                      "sph_radius": sr}, num_tris)

        tri_areas = tarea[:num_tris] if num_tris else np.zeros(0, np.float32)
        arrays = {
            "tri_v0": tv0,
            "tri_e1": te1,
            "tri_e2": te2,
            "tri_n0": tn0,
            "tri_n1": tn1,
            "tri_n2": tn2,
            "tri_uv0": tuv0,
            "tri_uv1": tuv1,
            "tri_uv2": tuv2,
            "tri_mtl": tmtl,
            "tri_light": tlight,
            "tri_mesh": tmesh,
            "tri_area": tarea.astype(np.float32),
            "sph_center": sc,
            "sph_radius": sr,
            "sph_mtl": smtl,
            "sph_light": slight,
            "materials": self.materials.numpy_arrays(),
            "lights": self.lights.numpy_arrays(tri_areas),
            "bg": np.asarray(self._bg, np.float32),
            **bvh,
        }
        if self._envmap is not None:
            arrays.update(build_env_tables(self._envmap))
        if self.textures.images:
            arrays.update(self.textures.numpy_arrays())
        if self.media.rows:
            arrays.update(self.media.numpy_arrays())
        rows = self.materials.rows
        static = {
            "num_tris": num_tris,
            "num_spheres": num_sph,
            "num_lights": len(self.lights.rows),
            "num_instances": num_instances,
            "has_alpha": any(r["alpha"] < 1.0 for r in rows),
            "has_stencil": any(r["stencil"] != 0.0 for r in rows),
            "has_albedo_maps": any(r["albedo_map"] >= 0 for r in rows),
            "has_roughness_maps": any(r["roughness_map"] >= 0 for r in rows),
            "has_normal_maps": any(r["normal_map"] >= 0 for r in rows),
            "used_mtl_types": tuple(sorted(
                {r["type"] for r in rows} | {int(MaterialType.DIFFUSE)}
            )),
        }
        if k5 is not None:
            arrays.update(k5)
        arrays.update(kernel_arrays)
        static.update(kernel_static)
        return arrays, static

    def _two_level(self, all_bmin, all_bmax):
        """Two-level pool (reference scene.py:316-348): prims grouped per
        object; world geometry becomes one more object with an identity
        instance, counted in num_instances."""
        prim_obj = np.concatenate([
            self._face_objects(), np.asarray(self._sph_obj, np.int64)])
        instances = list(self._instances)
        n_obj = self._num_objects
        if (prim_obj < 0).any():
            prim_obj = np.where(prim_obj < 0, n_obj, prim_obj)
            instances.append((n_obj, np.eye(4, dtype=np.float32)))
            n_obj += 1
        obj_prim_boxes = []
        for o in range(n_obj):
            pids = np.nonzero(prim_obj == o)[0].astype(np.int32)
            if len(pids) == 0:
                raise ValueError(f"object {o} has no geometry")
            obj_prim_boxes.append((all_bmin[pids], all_bmax[pids], pids))
        return build_two_level(
            obj_prim_boxes, np.asarray([i[0] for i in instances], np.int32),
            np.stack([i[1] for i in instances]))

    def build(self, device="cuda", bvh_cache=None) -> Scene:
        """Freeze into a Scene on `device` (the card unless the caller
        names the CPU; without a card, "cuda" raises).  bvh_cache: an .npz
        of a single-level BVH (`save_bvh_cache`), used when its prim
        count matches the scene's, else the BVH is built."""
        dev = resolve_device(device)
        arrays, static = self.numpy_arrays(bvh_cache)
        return Scene(to_tensors(arrays, dev), static, dev)
