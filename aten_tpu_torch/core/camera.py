"""Cameras.

Counterpart of aten_tpu/core/camera.py.  A camera is a frozen dataclass
of host numbers; `arrays(device)` turns it into the tensors the ray
generator reads.  Only the pinhole camera is ported so far: thin-lens
and equirect cameras raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from aten_tpu_torch.core import vecmath as vm


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    origin: tuple
    lookat: tuple
    up: tuple = (0.0, 1.0, 0.0)
    vfov_deg: float = 45.0
    width: int = 512
    height: int = 512

    def basis(self):
        return vm.look_at(self.origin, self.lookat, self.up)

    def arrays(self, device):
        """Camera parameters as float32 tensors on `device`."""
        r, u, f = self.basis()
        aspect = self.width / self.height
        half_h = math.tan(math.radians(self.vfov_deg) * 0.5)
        half_w = aspect * half_h

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return {
            "origin": t(self.origin),
            "right": t(r * half_w * 2.0),
            "up": t(u * half_h * 2.0),
            "forward": t(f),
            "dist": t(1.0),
        }


def generate_ray(cam_arrays, s, t):
    """Batched pinhole ray generation (camera/pinhole.h:64).  s, t: [N]
    film coordinates in [0,1).  Returns (ro, rd), each [N, 3]."""
    o = cam_arrays["origin"]
    p = (
        o
        + cam_arrays["forward"] * cam_arrays["dist"]
        + (s[..., None] - 0.5) * cam_arrays["right"]
        + (t[..., None] - 0.5) * cam_arrays["up"]
    )
    rd = vm.normalize(p - o)
    ro = torch.broadcast_to(o, rd.shape)
    return ro, rd


def generate_ray_thinlens(cam_arrays, s, t, u1, u2):
    raise NotImplementedError("thin-lens camera is not ported yet")


def generate_ray_equirect(cam_arrays, s, t):
    raise NotImplementedError("equirect camera is not ported yet")


def camera_type_of(cam):
    """Static camera-type tag; only the pinhole camera is ported."""
    if type(cam) is not PinholeCamera:
        raise NotImplementedError(
            f"{type(cam).__name__}: thin-lens and equirect cameras are not ported yet")
    return "pinhole"
