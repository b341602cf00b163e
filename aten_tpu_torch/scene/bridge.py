"""Bring a reference scene's arrays into the port.

`from_numpy` takes the arrays of an `aten_tpu` SceneData, already turned
into numpy by the caller (nested dicts for the material and light
tables), and its static dict, and returns the port's Scene on `device`.
It is how a test holds both packages to the identical scene without the
port importing JAX.  Instanced scenes come with their two-level pool
(`tl_*`, `inst_*`) in place of the single-level BVH, and get the K5
kernel's packed records of it (ops/tlas_layout.py).  A single-level
scene runs the K1 kernel, so it gets K1's packed records
(ops/bvh_layout.py).  Both are built as the scene builder builds them.
A voxel-LOD scene (accel/voxel.py) brings its annotation
(`nodes_voxel_mtl`, `nodes_depth`) and its `lod_depth`; its K1 records
are those of its tree baked at that depth (ops/lod_layout.py), built
here: the reference's own LOD layout (`trl_*`) is never taken.
An envmap comes with its tables (scene/envmap.py) and textures with
their stack, sizes and mip chain (scene/textures.py), taken as they are.
Participating media come with their rows (`med_*`) and, with a density
grid, its stack, box and majorants (`grid_*`; volume/medium.py).
The reference's TPU layouts (its kernel layouts, the packed `tri_attr`
gather table, the staged `env_quad` rows and the grid's staged corner
rows `grid_corners`) are dropped.  Any other array the port does not
know raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np

from aten_tpu_torch.accel.voxel import ARRAY_KEYS as LOD_KEYS
from aten_tpu_torch.device import resolve_device
from aten_tpu_torch.ops import bvh_layout, lod_layout, tlas_layout
from aten_tpu_torch.scene.envmap import TABLE_KEYS as ENV_KEYS
from aten_tpu_torch.scene.scene import BVH_KEYS, Scene, check_leaf_sizes, to_tensors
from aten_tpu_torch.volume.medium import ARRAY_KEYS as MEDIUM_KEYS
from aten_tpu_torch.volume.medium import GRID_KEYS

# arrays the port uses
PORT_KEYS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_mtl", "tri_light", "tri_mesh",
    "tri_area", "sph_center", "sph_radius", "sph_mtl", "sph_light",
    "materials", "lights", "bg",
)
# the two-level pool of an instanced scene (a single-level one has BVH_KEYS)
TWO_LEVEL_KEYS = (
    "tl_bmin", "tl_bmax", "tl_hit", "tl_miss", "tl_ps", "tl_pc", "tl_inst",
    "tl_prim_order", "inst_obj", "inst_w2l", "inst_nmtx", "inst_l2w",
)
# texture arrays: the stack, the sizes and the mip levels tex_mip1...
TEX_KEYS = ("tex_stack", "tex_size")
TEX_MIP_PREFIX = "tex_mip"
# TPU layouts (Pallas node/prim rows, the instanced tt_ rows, the packed
# tri_attr gather table, the staged envmap quad rows, the grid's corner rows)
TPU_LAYOUT_PREFIXES = ("pl_", "trl_", "tt_", "tri_attr", "env_quad", "grid_corners")
STATIC_KEYS = (
    "num_tris", "num_spheres", "num_lights", "num_instances", "has_alpha",
    "has_stencil", "has_albedo_maps", "has_roughness_maps",
    "has_normal_maps", "used_mtl_types",
)


def from_numpy(arrays: dict, static: dict, device) -> Scene:
    dev = resolve_device(device)
    keys = PORT_KEYS + (TWO_LEVEL_KEYS if "tl_bmin" in arrays else BVH_KEYS)
    if "envmap" in arrays:
        keys += ENV_KEYS
    if "tex_stack" in arrays:
        keys += TEX_KEYS + tuple(k for k in arrays if k.startswith(TEX_MIP_PREFIX))
    if "med_sigma_a" in arrays:
        keys += MEDIUM_KEYS
    if "grid_density" in arrays:
        keys += GRID_KEYS
    lod = bool(static.get("has_voxel_lod"))
    if lod:
        keys += LOD_KEYS
    unported = sorted(
        k for k in arrays
        if k not in keys and not k.startswith(TPU_LAYOUT_PREFIXES))
    if unported:
        raise NotImplementedError(f"scene arrays not ported yet: {unported}")
    check_leaf_sizes(arrays["tl_pc" if "tl_bmin" in arrays else "nodes_prim_count"])
    lights = {k: v for k, v in arrays["lights"].items() if k != "num"}
    picked = {k: arrays[k] for k in keys}
    picked["lights"] = lights
    geo = [arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")]
    out_static = {k: static[k] for k in STATIC_KEYS}
    if "tl_bmin" in arrays:
        picked.update(tlas_layout.build_tlas_layout(arrays, *geo, static["num_tris"]))
    elif lod:
        depth = int(np.asarray(arrays["lod_depth"]))
        baked, vox = lod_layout.baked_tree(
            arrays, arrays["nodes_voxel_mtl"], arrays["nodes_depth"], depth,
            static["num_tris"] + static["num_spheres"])
        picked.update(bvh_layout.build_bvh_layout(baked, *geo, static["num_tris"], vox=vox))
        picked["lod_depth"] = np.asarray(depth, np.int32)
        out_static.update(has_voxel_lod=True, lod_bake_depth=depth)
    else:
        picked.update(bvh_layout.build_bvh_layout(arrays, *geo, static["num_tris"]))
    return Scene(to_tensors(picked, dev), out_static, dev)
