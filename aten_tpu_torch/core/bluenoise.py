"""Blue-noise masks and sampler.

Counterpart of aten_tpu/core/bluenoise.py (the reference renderer's
blue-noise sampler, bluenoiseSampler.cuh, with 256x256xN mask textures
shipped as assets).  The masks are generated once with the
void-and-cluster algorithm (Ulichney 1993: toroidal Gaussian energy,
incremental updates), bit for bit the reference's, and cached as an
.npz in the port's own build directory (or where
ATEN_TPU_TORCH_BLUENOISE_CACHE points), so the port never reads a file
the reference wrote.  Sampling decorrelates frames and dimensions with a
toroidal shift along the R2 sequence and a Cranley-Patterson rotation,
in float32 as the reference computes them.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from aten_tpu_torch import native

_CACHE = os.environ.get(
    "ATEN_TPU_TORCH_BLUENOISE_CACHE",
    os.path.join(native.BUILD_DIR, "bluenoise_{size}x{layers}.npz"))


def _toroidal_gaussian(size, sigma=1.9):
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)
    dx2 = d[None, :] ** 2
    dy2 = d[:, None] ** 2
    return np.exp(-(dx2 + dy2) / (2.0 * sigma * sigma))


def _energy_at(kernel, y, x):
    return np.roll(np.roll(kernel, y, axis=0), x, axis=1)


def make_blue_noise(size=64, seed=0):
    """Void-and-cluster rank matrix [size, size] of the values 0..size^2-1."""
    rng = np.random.default_rng(seed)
    n = size * size
    n1 = n // 10
    kernel = _toroidal_gaussian(size)

    # an initial random binary pattern of n1 ones
    binary = np.zeros((size, size), bool)
    idx = rng.choice(n, n1, replace=False)
    binary.ravel()[idx] = True
    energy = np.zeros((size, size))
    for y, x in zip(*np.nonzero(binary)):
        energy += _energy_at(kernel, y, x)

    # phase 0: relax the prototype (swap the tightest cluster with the largest void)
    for _ in range(n):
        e1 = np.where(binary, energy, -np.inf)
        cy, cx = np.unravel_index(np.argmax(e1), e1.shape)
        binary[cy, cx] = False
        energy -= _energy_at(kernel, cy, cx)
        e0 = np.where(binary, np.inf, energy)
        vy, vx = np.unravel_index(np.argmin(e0), e0.shape)
        binary[vy, vx] = True
        energy += _energy_at(kernel, vy, vx)
        if (vy, vx) == (cy, cx):
            break

    rank = np.full((size, size), -1, np.int64)
    # phase 1: remove the tightest clusters, ranks n1-1 .. 0
    b = binary.copy()
    e = energy.copy()
    for r in range(n1 - 1, -1, -1):
        e1 = np.where(b, e, -np.inf)
        cy, cx = np.unravel_index(np.argmax(e1), e1.shape)
        b[cy, cx] = False
        e -= _energy_at(kernel, cy, cx)
        rank[cy, cx] = r
    # phase 2: fill the largest voids, ranks n1 .. n-1
    b = binary.copy()
    e = energy.copy()
    for r in range(n1, n):
        e0 = np.where(b, np.inf, e)
        vy, vx = np.unravel_index(np.argmin(e0), e0.shape)
        b[vy, vx] = True
        e += _energy_at(kernel, vy, vx)
        rank[vy, vx] = r
    assert (rank >= 0).all()
    return rank


def get_masks(size=64, layers=4, cache=None):
    """[L, S, S] float32 masks in [0,1), generated once and cached (the
    file is written whole, then renamed into place)."""
    path = (cache or _CACHE).format(size=size, layers=layers)
    if os.path.exists(path):
        with np.load(path) as z:
            return z["masks"]
    masks = np.stack(
        [make_blue_noise(size, seed=s) for s in range(layers)]
    ).astype(np.float32)
    masks = (masks + 0.5) / (size * size)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, masks=masks)
        os.replace(tmp, path)
    except OSError:
        pass
    return masks


# R2 low-discrepancy sequence constants (plastic number)
_R2A = 0.7548776662466927
_R2B = 0.5698402909980532


class BlueNoiseSampler:
    """Per-pixel blue-noise sample streams.

    sample(px, py, frame, dim) returns [N] floats in [0,1): the mask value
    at the pixel, toroidally shifted per (frame, dim) along the R2
    sequence and Cranley-Patterson rotated, as the reference's mask-stack
    lookup by (x, y, frame/dim).  The masks live on `device`, the card
    unless the caller names the CPU."""

    def __init__(self, size=64, layers=4, device="cuda"):
        self.size = size
        self.layers = layers
        self.masks = torch.as_tensor(get_masks(size, layers), device=device)

    def sample(self, px, py, frame, dim):
        """px, py [N] pixel coordinates (any numeric dtype), frame and dim
        non-negative integers or int64 tensors holding uint32 values."""
        layer = dim % self.layers
        # the toroidal shift per (frame, dim): points of the R2 sequence
        k = frame * 17 + dim
        kf = torch.as_tensor(k, device=self.masks.device).to(torch.float32)
        sx = torch.floor(torch.remainder(kf * _R2A, 1.0) * self.size).to(torch.int64)
        sy = torch.floor(torch.remainder(kf * _R2B, 1.0) * self.size).to(torch.int64)
        x = torch.remainder(px.to(torch.int64) + sx, self.size)
        y = torch.remainder(py.to(torch.int64) + sy, self.size)
        v = self.masks[layer, y, x]
        # the Cranley-Patterson rotation keeps the spatial spectrum and
        # decorrelates successive frames
        rot = torch.remainder(kf * 0.6180339887498949, 1.0)
        return torch.remainder(v + rot, 1.0)

    def sample2d(self, px, py, frame, dim):
        return self.sample(px, py, frame, dim), self.sample(px, py, frame, dim + 1)
