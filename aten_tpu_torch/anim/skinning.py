"""Linear-blend skinning and the per-frame scene update.

Counterpart of aten_tpu/anim/skinning.py: skinning is one batched
gather and weighted sum over all vertices, normals are rebuilt by a
scatter-add of the faces' area-weighted normals, and `apply_pose`
refreshes the scene's pre-expanded triangle arrays, then rebuilds its
tree on the device (accel/lbvh.py).  Pose -> skin -> LBVH -> K1's
records runs on the scene's device with no host sync when the mesh and
palette are tensors there (`DeformableMesh.to`).

Every array derived from the deformed triangles is refreshed or
dropped: tri_v0/e1/e2, tri_n0/n1/n2 and tri_area are replaced; an area
light on the deformed triangles gets its area and triangle CDF anew;
the kernel layouts of the old geometry (K1's records, and K3's and K4's
layouts, which the reference keeps) are dropped, and the rebuild
attaches K1's records of the new tree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aten_tpu_torch.accel.lbvh import rebuild_scene_bvh
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.scene.scene import Scene, without_kernel_layouts


def skin_vertices(palette, pos, nml, weights, joints):
    """LBS: palette [J,3,4], pos/nml [V,3], weights [V,4], joints [V,4].

    Returns (skinned_pos [V,3], skinned_nml [V,3]).  Normals use the
    rotation part of the blended matrix (rigid and uniform-scale
    palettes)."""
    m = palette[joints.long()]  # [V,4,3,4]
    blended = torch.sum(m * weights[..., None, None], dim=1)  # [V,3,4]
    rot = blended[:, :, :3]
    p = torch.einsum("vij,vj->vi", rot, pos) + blended[:, :, 3]
    n = torch.einsum("vij,vj->vi", rot, nml)
    return p, vm.normalize(n)


def vertex_normals(pos, faces):
    """Area-weighted vertex normals by scatter-add."""
    faces = faces.long()
    fn = vm.cross(pos[faces[:, 1]] - pos[faces[:, 0]], pos[faces[:, 2]] - pos[faces[:, 0]])
    n = torch.zeros_like(pos)
    for a in range(3):
        n = n.index_add(0, faces[:, a], fn)
    return vm.normalize(n)


@dataclasses.dataclass(frozen=True)
class DeformableMesh:
    """Bind-pose skinned mesh occupying the triangle range [tri_start,
    tri_start + F) of a built scene.  Its arrays are numpy, or tensors on
    one device (`to`)."""

    tri_start: int
    faces: np.ndarray      # [F,3] vertex indices (object-local)
    bind_pos: np.ndarray   # [V,3]
    bind_nml: np.ndarray   # [V,3]
    weights: np.ndarray    # [V,4]
    joints: np.ndarray     # [V,4] int

    @staticmethod
    def attach(builder, pos, faces, mtl_id, weights, joints, nml=None):
        """Register bind-pose geometry with a SceneBuilder; returns the
        DeformableMesh handle (for use after builder.build())."""
        pos = np.asarray(pos, np.float32)
        faces_a = np.asarray(faces, np.int64)
        if nml is None:
            nml = vertex_normals(torch.from_numpy(pos), torch.from_numpy(faces_a)).numpy()
        tri_start, _ = builder.add_mesh(pos, faces_a, mtl_id, nml=nml)
        w = np.asarray(weights, np.float32)
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
        return DeformableMesh(
            tri_start=tri_start,
            faces=faces_a,
            bind_pos=pos,
            bind_nml=np.asarray(nml, np.float32),
            weights=w,
            joints=np.asarray(joints, np.int32),
        )

    def to(self, device):
        """The mesh with its arrays as tensors on `device` (faces and
        joints int64)."""
        def t(a, dtype):
            return torch.as_tensor(a, device=device).to(dtype)

        return DeformableMesh(self.tri_start, t(self.faces, torch.int64),
                              t(self.bind_pos, torch.float32), t(self.bind_nml, torch.float32),
                              t(self.weights, torch.float32), t(self.joints, torch.int64))


def _posed_lights(lights, tri_area, start, count):
    """The light table with the area and triangle CDF of every area light
    on triangles in [start, start + count) recomputed from tri_area, as
    the scene build computes them (scene/lights.py)."""
    first, n = lights["tri_start"].long(), lights["tri_count"].long()
    cdf = lights["tri_cdf"]
    k = torch.arange(cdf.shape[1], device=cdf.device)
    valid = k[None, :] < n[:, None]
    idx = torch.clamp(first[:, None] + k[None, :], 0, tri_area.shape[0] - 1)
    a = torch.where(valid, tri_area[idx], 0.0)
    total = torch.sum(a, dim=1)
    new_cdf = torch.where(valid, torch.cumsum(a, 1) / torch.clamp(total, min=1e-20)[:, None], 1.0)
    posed = ((lights["obj_kind"] == 0) & (n > 0) & (first < start + count)
             & (first + n > start))
    return {**lights, "tri_cdf": torch.where(posed[:, None], new_cdf, cdf),
            "area": torch.where(posed, total, lights["area"])}


def apply_pose(scene: Scene, mesh: DeformableMesh, palette, rebuild=True) -> Scene:
    """`scene` with `mesh` skinned by the [J,3,4] palette: its triangle
    arrays refreshed and, with rebuild, its tree rebuilt on the device
    with K1's records (accel/lbvh.py::rebuild_scene_bvh).  Without
    rebuild, the kernel layouts are dropped (a later rebuild_scene_bvh
    attaches K1's).  Single-level scenes only."""
    if scene["num_instances"]:
        raise ValueError("apply_pose: only single-level scenes; this one has instances")
    if scene.get("has_voxel_lod"):
        raise ValueError("apply_pose: a voxel-LOD scene's annotation is of its bind pose")
    dev = scene.device
    mesh = mesh.to(dev)
    faces = mesh.faces
    p, _ = skin_vertices(palette, mesh.bind_pos, mesh.bind_nml, mesh.weights, mesh.joints)
    n = vertex_normals(p, faces)
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    start, count = mesh.tri_start, faces.shape[0]

    def upd(name, val):
        out = scene[name].clone()
        out[start:start + count] = val
        return out

    e1 = p[i1] - p[i0]
    e2 = p[i2] - p[i0]
    tri_area = upd("tri_area", 0.5 * vm.length(vm.cross(e1, e2), keepdims=False))
    posed = without_kernel_layouts(Scene({
        **scene.arrays,
        "tri_v0": upd("tri_v0", p[i0]), "tri_e1": upd("tri_e1", e1),
        "tri_e2": upd("tri_e2", e2), "tri_n0": upd("tri_n0", n[i0]),
        "tri_n1": upd("tri_n1", n[i1]), "tri_n2": upd("tri_n2", n[i2]), "tri_area": tri_area,
        "lights": _posed_lights(scene["lights"], tri_area, start, count)}, scene.static, dev))
    return rebuild_scene_bvh(posed) if rebuild else posed
