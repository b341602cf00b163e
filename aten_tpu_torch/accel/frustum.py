"""Frustum against BVH (visibility culling).

Counterpart of aten_tpu/accel/frustum.py (the reference's
ThreadedBvhFrustum.cpp and math/frustum.h): six inward-facing planes of a
pinhole camera, and the plane/AABB "p-vertex" test over every node of
the tree at once instead of a walk of the hit/miss links.  A node is out
only if its corner farthest along some plane's normal is outside that
plane, so the answer is conservative; a prim inherits its leaf's verdict
through the leaf's `prim_order` range, and can be refined against its
own box.  The planes are computed on the host in float64 and cast to
float32, as in the reference; the tests run as torch ops on the device
of the tree's tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def frustum_planes_from_camera(cam):
    """[6, 4] float32 numpy planes (nx, ny, nz, d), n.x + d >= 0 inside,
    of a pinhole camera: near at the eye, right, left, top, bottom, and
    far at `cam.far` (default 1e6)."""
    o = np.asarray(cam.origin, np.float64)
    fwd = np.asarray(cam.lookat, np.float64) - o
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.asarray(getattr(cam, "up", (0.0, 1.0, 0.0)), np.float64)
    right = np.cross(fwd, up_hint)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    tan_v = np.tan(np.deg2rad(cam.vfov_deg) * 0.5)
    tan_h = tan_v * (cam.width / cam.height)

    def plane(n):
        n = n / np.linalg.norm(n)
        return np.array([n[0], n[1], n[2], -np.dot(n, o)], np.float64)

    far = getattr(cam, "far", 1e6)
    planes = [
        plane(fwd),
        plane(np.cross(up, fwd + right * tan_h)),
        plane(np.cross(fwd - right * tan_h, up)),
        plane(np.cross(fwd + up * tan_v, right)),
        plane(np.cross(right, fwd - up * tan_v)),
        np.array([-fwd[0], -fwd[1], -fwd[2], -np.dot(-fwd, o + fwd * far)], np.float64),
    ]
    return np.stack(planes).astype(np.float32)


def intersect_frustum_nodes(planes, nodes_bmin, nodes_bmax):
    """[K] bool: the boxes that touch the frustum.  Tensors stay on their
    device; numpy boxes are tested on the CPU."""
    bmin = torch.as_tensor(nodes_bmin, dtype=torch.float32)
    bmax = torch.as_tensor(nodes_bmax, dtype=torch.float32, device=bmin.device)
    planes = torch.as_tensor(np.asarray(planes, np.float32), device=bmin.device)
    n, d = planes[:, :3], planes[:, 3]
    pvert = torch.where(n[None] >= 0.0, bmax[:, None, :], bmin[:, None, :])  # [K,6,3]
    dist = (pvert * n[None]).sum(-1) + d[None]
    return (dist >= 0.0).all(dim=1)


def visible_prims(scene, planes, prim_bmin=None, prim_bmax=None):
    """(prim mask [P] over prim ids, node mask [K]): the prims inside or
    touching the frustum through their leaves, on the tree's device.
    `scene`: the port's Scene or a dict of tensors or arrays with
    nodes_bmin/bmax, nodes_prim_start/count and prim_order (an SBVH's
    repeated ids included).  With per-prim boxes, the prims of kept
    leaves are tested against the frustum one by one; the answer stays a
    superset of the prims truly visible.  The leaves' ranges expand with
    one repeat_interleave, no loop over leaves."""
    node_in = intersect_frustum_nodes(planes, scene["nodes_bmin"], scene["nodes_bmax"])
    dev = node_in.device
    ps = torch.as_tensor(scene["nodes_prim_start"], device=dev).long()
    pc = torch.as_tensor(scene["nodes_prim_count"], device=dev).long()
    order = torch.as_tensor(scene["prim_order"], device=dev).long()
    num_prims = int(order.max()) + 1 if order.numel() else 0
    keep = node_in & (ps >= 0)
    start, count = ps[keep], pc[keep]
    # slot j of leaf i: start_i + (j - first slot of leaf i)
    first = torch.cumsum(count, 0) - count
    slot = torch.repeat_interleave(start - first, count) + torch.arange(
        int(count.sum()), device=dev)
    mask = torch.zeros(num_prims, dtype=torch.bool, device=dev)
    mask[order[slot]] = True
    if prim_bmin is not None:
        cand = torch.nonzero(mask).squeeze(1)
        bmin = torch.as_tensor(prim_bmin, device=dev)[cand]
        bmax = torch.as_tensor(prim_bmax, device=dev)[cand]
        fine = intersect_frustum_nodes(planes, bmin, bmax)
        mask = torch.zeros_like(mask)
        mask[cand[fine]] = True
    return mask, node_in
