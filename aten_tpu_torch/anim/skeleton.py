"""Skeleton pose computation (forward kinematics).

Counterpart of aten_tpu/anim/skeleton.py: joints with parent links and
local TRS, composed into global joint matrices, then multiplied with the
inverse-bind matrices into the skinning palette.

The joint hierarchy is grouped into topological levels on the host, and
FK runs one batched matmul per level over the joints of that level.  The
levels' index tensors are made once per skeleton and device, so a pose
on the card copies nothing from the host after the first.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def quat_to_mat(q):
    """[..., 4] quaternions (x, y, z, w) -> [..., 3, 3] rotation matrices."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def trs_to_mat(t, q, s):
    """Translation [..., 3], quaternion [..., 4], scale [..., 3] ->
    [..., 4, 4]."""
    r = quat_to_mat(q) * s[..., None, :]
    m = torch.zeros(t.shape[:-1] + (4, 4), dtype=torch.float32, device=t.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Static hierarchy: parents[j] < j (a root has -1)."""

    parents: tuple  # [J] ints
    bind_t: np.ndarray  # [J,3] local bind translation
    bind_q: np.ndarray  # [J,4] local bind rotation (x,y,z,w)
    bind_s: np.ndarray  # [J,3] local bind scale

    def __post_init__(self):
        for j, p in enumerate(self.parents):
            if p >= j:
                raise ValueError(f"joint {j}'s parent {p} must precede it")

    @property
    def num_joints(self):
        return len(self.parents)

    def levels(self):
        """Topological levels: a list of index arrays, roots first."""
        return _levels(tuple(self.parents))

    def inverse_bind(self):
        """[J, 4, 4] float32 numpy inverse global bind matrices (the
        skinning palette is global(pose) @ inverse_bind)."""
        g = global_matrices(self, torch.from_numpy(np.asarray(self.bind_t, np.float32)),
                            torch.from_numpy(np.asarray(self.bind_q, np.float32)),
                            torch.from_numpy(np.asarray(self.bind_s, np.float32)))
        return np.linalg.inv(g.numpy()).astype(np.float32)


def _levels(parents):
    depth = [0] * len(parents)
    for j, p in enumerate(parents):
        depth[j] = 0 if p < 0 else depth[p] + 1
    return [np.asarray([j for j in range(len(parents)) if depth[j] == d])
            for d in range(max(depth) + 1)]


@functools.lru_cache(maxsize=64)
def _level_index(parents, device):
    """[(joints, their parents)] of each level below the roots, as int64
    tensors on `device`."""
    par = np.asarray(parents)
    return [(torch.as_tensor(lvl, dtype=torch.int64, device=device),
             torch.as_tensor(par[lvl], dtype=torch.int64, device=device))
            for lvl in _levels(parents)[1:]]


def global_matrices(skel: Skeleton, t, q, s):
    """FK: local TRS tensors [J, ·] -> global joint matrices [J, 4, 4];
    each level's joints take one batched matmul with their parents'."""
    local = trs_to_mat(t, q, s)
    g = local
    for lvl, pidx in _level_index(tuple(skel.parents), local.device):
        g = g.index_put((lvl,), torch.matmul(g[pidx], local[lvl]))
    return g


def skinning_palette(skel: Skeleton, t, q, s, inv_bind):
    """[J, 3, 4] palette rows: global(pose) @ inverse_bind.  inv_bind
    [J, 4, 4]: a tensor on the pose's device keeps the call free of host
    copies."""
    g = global_matrices(skel, t, q, s)
    m = torch.matmul(g, torch.as_tensor(inv_bind, device=g.device))
    return m[:, :3, :4]
