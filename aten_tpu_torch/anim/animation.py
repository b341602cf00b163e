"""Keyframe animation curves (translation, rotation and scale channels).

Counterpart of aten_tpu/anim/animation.py: channels are padded [J, K, C]
arrays, sampled for all joints at once by counting the keys at or before
t, with a lerp for vectors and a slerp for quaternions.  A clip holds
numpy arrays; `AnimationClip.to(device)` gives one whose arrays are
tensors on that device, which `sample` then reads with no host copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def slerp(q0, q1, u):
    """Batched quaternion slerp with the lerp fallback for tiny angles."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)  # shortest arc
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_t = torch.sin(theta)
    safe = sin_t > 1e-5
    w0 = torch.where(safe, torch.sin((1 - u) * theta) / torch.where(safe, sin_t, 1.0), 1 - u)
    w1 = torch.where(safe, torch.sin(u * theta) / torch.where(safe, sin_t, 1.0), u)
    q = w0 * q0 + w1 * q1
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


@dataclasses.dataclass(frozen=True)
class AnimationClip:
    """Per-joint keyframed TRS channels, padded to a common key count.

    times [J,K] (non-decreasing per joint; padded by repeating the last
    key), trans [J,K,3], rot [J,K,4] quaternions (x,y,z,w), scale
    [J,K,3]: numpy arrays, or tensors on one device (`to`).
    """

    times: np.ndarray
    trans: np.ndarray
    rot: np.ndarray
    scale: np.ndarray

    @staticmethod
    def from_tracks(tracks):
        """tracks: list (per joint) of dicts {times [K_j], trans [K_j,3],
        rot [K_j,4], scale [K_j,3]}; ragged K_j padded to the largest."""
        J = len(tracks)
        K = max(len(t["times"]) for t in tracks)
        times = np.zeros((J, K), np.float32)
        trans = np.zeros((J, K, 3), np.float32)
        rot = np.zeros((J, K, 4), np.float32)
        scale = np.ones((J, K, 3), np.float32)
        for j, tr in enumerate(tracks):
            k = len(tr["times"])
            times[j, :k] = tr["times"]
            times[j, k:] = tr["times"][-1]
            trans[j, :k] = tr["trans"]
            trans[j, k:] = tr["trans"][-1]
            rot[j, :k] = tr["rot"]
            rot[j, k:] = tr["rot"][-1]
            scale[j, :k] = tr["scale"]
            scale[j, k:] = tr["scale"][-1]
        return AnimationClip(times, trans, rot, scale)

    def to(self, device):
        """The clip with its arrays as float32 tensors on `device`."""
        return AnimationClip(*(torch.as_tensor(a, dtype=torch.float32, device=device)
                               for a in (self.times, self.trans, self.rot, self.scale)))

    @property
    def duration(self):
        return float(self.times.max())

    def sample(self, t):
        """All joints at time t (a float, or a float32 tensor on the clip's
        device) -> (trans [J,3], rot [J,4], scale [J,3]) tensors."""
        times = torch.as_tensor(self.times)
        J, K = times.shape
        if torch.is_tensor(t):
            tt = torch.clamp(t.to(torch.float32), min=0.0)
        else:  # t rounded to float32, as the reference's clip does
            tt = max(float(np.float32(t)), 0.0)
        # per-joint bracketing key: k1 = the first key with time > t
        k1 = torch.sum((times <= tt).to(torch.int64), dim=1)
        k1 = torch.clamp(k1, 1, K - 1)
        k0 = torch.clamp(k1 - 1, min=0)  # K = 1: the reference's index -1 wraps to 0
        t0 = torch.gather(times, 1, k0[:, None])[:, 0]
        t1 = torch.gather(times, 1, k1[:, None])[:, 0]
        u = torch.where(t1 > t0, (tt - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0)
        u = torch.clamp(u, 0.0, 1.0)[:, None]

        def gather(arr, k):
            arr = torch.as_tensor(arr)
            return torch.gather(arr, 1, k[:, None, None].expand(J, 1, arr.shape[2]))[:, 0]

        tr = (1 - u) * gather(self.trans, k0) + u * gather(self.trans, k1)
        sc = (1 - u) * gather(self.scale, k0) + u * gather(self.scale, k1)
        q = slerp(gather(self.rot, k0), gather(self.rot, k1), u)
        return tr, q, sc
