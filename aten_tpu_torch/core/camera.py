"""Cameras.

Counterpart of aten_tpu/core/camera.py.  A camera is a frozen dataclass
of host numbers; `arrays(device)` turns it into the tensors the ray
generator reads: the pinhole camera, the thin-lens camera (depth of
field, its lens sample drawn by the caller) and the equirect (lat-long)
camera, whose arrays `generate_ray` tells apart by their keys.
`CameraOperator` moves a camera (dolly, orbit, pan) on the host, and
`camera_matrices` gives its world-to-view and view-to-clip matrices.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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


def _tensor(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def generate_ray(cam_arrays, s, t):
    """Batched pinhole ray generation (camera/pinhole.h:64).  s, t: [N]
    film coordinates in [0,1).  Returns (ro, rd), each [N, 3].  An
    equirect camera's arrays (they hold "fwd") go to
    `generate_ray_equirect`, as in the reference."""
    if "fwd" in cam_arrays:
        return generate_ray_equirect(cam_arrays, s, t)
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


@dataclasses.dataclass(frozen=True)
class ThinLensCamera(PinholeCamera):
    """Depth of field: a disc on the lens, focused on the plane at
    focus_dist (camera/thinlens.h)."""

    lens_radius: float = 0.05
    focus_dist: float = 1.0

    def arrays(self, device):
        a = super().arrays(device)
        a["lens_radius"] = _tensor(self.lens_radius, device)
        a["focus_dist"] = _tensor(self.focus_dist, device)
        return a


def generate_ray_thinlens(cam_arrays, s, t, u1, u2):
    """Thin-lens rays; u1, u2 [N] the lens-disc samples in [0,1)."""
    o = cam_arrays["origin"]
    fwd = cam_arrays["forward"]
    focus = cam_arrays["focus_dist"]
    # the point on the focal plane through the pinhole ray
    p = (
        o
        + fwd * focus
        + (s[..., None] - 0.5) * cam_arrays["right"] * focus
        + (t[..., None] - 0.5) * cam_arrays["up"] * focus
    )
    # a point on the lens disc
    r = torch.sqrt(u1)[..., None] * cam_arrays["lens_radius"]
    phi = (2.0 * np.pi) * u2[..., None]
    right_n = vm.normalize(cam_arrays["right"])
    up_n = vm.normalize(cam_arrays["up"])
    lens_p = o + r * (torch.cos(phi) * right_n + torch.sin(phi) * up_n)
    rd = vm.normalize(p - lens_p)
    return lens_p, rd


@dataclasses.dataclass(frozen=True)
class EquirectCamera:
    """360-degree lat-long camera (camera/equirect.h): film (s, t) maps to
    a direction on the sphere in the camera's basis."""

    origin: tuple
    lookat: tuple
    up: tuple = (0.0, 1.0, 0.0)
    width: int = 1024
    height: int = 512

    def basis(self):
        return vm.look_at(self.origin, self.lookat, self.up)

    def arrays(self, device):
        r, u, f = self.basis()
        return {"origin": _tensor(self.origin, device), "right": _tensor(r, device),
                "upv": _tensor(u, device), "fwd": _tensor(f, device)}


def generate_ray_equirect(cam_arrays, s, t):
    """s in [0,1) -> azimuth (a full turn, 0.5 forward), t in [0,1) ->
    polar angle (t = 1 up)."""
    phi = (s - 0.5) * (2.0 * np.pi)
    theta = (1.0 - t) * np.pi
    sin_t = torch.sin(theta)
    local = torch.stack(
        [sin_t * torch.sin(phi), torch.cos(theta), sin_t * torch.cos(phi)], dim=-1)
    rd = (
        local[..., 0:1] * cam_arrays["right"]
        + local[..., 1:2] * cam_arrays["upv"]
        + local[..., 2:3] * cam_arrays["fwd"]
    )
    ro = torch.broadcast_to(cam_arrays["origin"], rd.shape)
    return ro, vm.normalize(rd)


class CameraOperator:
    """Orbit, dolly and pan controls over a camera on the host
    (camera/CameraOperator.{h,cpp}): each returns a new camera."""

    @staticmethod
    def dolly(cam, amount):
        eye = np.asarray(cam.origin, np.float32)
        at = np.asarray(cam.lookat, np.float32)
        f = at - eye
        d = np.linalg.norm(f)
        f = f / max(d, 1e-9)
        step = min(amount, d - 1e-3) if amount > 0 else amount
        return dataclasses.replace(cam, origin=tuple(eye + f * step))

    @staticmethod
    def orbit(cam, yaw, pitch):
        """Rotate the eye about the lookat point (radians)."""
        eye = np.asarray(cam.origin, np.float32)
        at = np.asarray(cam.lookat, np.float32)
        up = np.asarray(cam.up, np.float32)
        v = eye - at
        r = np.linalg.norm(v)
        upn = up / np.linalg.norm(up)
        # the horizontal frame (a, b) of the plane orthogonal to up
        seed = np.array([0.0, 0.0, 1.0], np.float32)
        if abs(np.dot(seed, upn)) > 0.99:
            seed = np.array([1.0, 0.0, 0.0], np.float32)
        b = seed - np.dot(seed, upn) * upn
        b /= np.linalg.norm(b)
        a = np.cross(upn, b)
        y = np.dot(v, upn)
        az = np.arctan2(np.dot(v, a), np.dot(v, b))
        el = np.arctan2(y, max(np.linalg.norm(v - y * upn), 1e-9))
        az += yaw
        el = np.clip(el + pitch, -1.55, 1.55)
        nh = r * np.cos(el)
        v_new = nh * (np.sin(az) * a + np.cos(az) * b) + r * np.sin(el) * upn
        return dataclasses.replace(cam, origin=tuple(at + v_new))

    @staticmethod
    def pan(cam, dx, dy):
        """Translate the eye and the lookat point in the view plane."""
        r, u, f = cam.basis()
        off = r * dx + u * dy
        return dataclasses.replace(
            cam,
            origin=tuple(np.asarray(cam.origin) + off),
            lookat=tuple(np.asarray(cam.lookat) + off),
        )


def camera_matrices(cam, device="cuda"):
    """World-to-view and view-to-clip matrices [4, 4] of a pinhole camera
    (ComputeCameraMatrices, renderer/pathtracing/pt_params.h:177), built
    on the host in float32 and returned as tensors on `device`, the card
    unless the caller names the CPU."""
    r, u, f = cam.basis()
    eye = np.asarray(cam.origin, np.float32)
    w2v = np.eye(4, dtype=np.float32)
    w2v[0, :3], w2v[1, :3], w2v[2, :3] = r, u, -f
    w2v[:3, 3] = -w2v[:3, :3] @ eye
    fov = math.radians(cam.vfov_deg)
    fy = 1.0 / math.tan(fov * 0.5)
    fx = fy * cam.height / cam.width
    znear, zfar = 0.01, 10000.0
    v2c = np.zeros((4, 4), np.float32)
    v2c[0, 0], v2c[1, 1] = fx, fy
    v2c[2, 2] = -(zfar + znear) / (zfar - znear)
    v2c[2, 3] = -2 * zfar * znear / (zfar - znear)
    v2c[3, 2] = -1.0
    return _tensor(w2v, device), _tensor(v2c, device)


def camera_type_of(cam):
    """The static camera-type tag of a camera (the reference's
    pathtracer.py:627-635): "thinlens", "equirect" or "pinhole"."""
    if isinstance(cam, ThinLensCamera):
        return "thinlens"
    if isinstance(cam, EquirectCamera):
        return "equirect"
    return "pinhole"
