"""Render-state checkpoint and resume.

Counterpart of aten_tpu/utils/checkpoint.py, its portable `.npz` path:
the progressive render's state (the film's buffer and sample count, the
frame counter and, for inverse rendering, the scene's arrays) is a
nested dict flattened to `/`-joined keys (`film/buf`, `film/count`,
`frame`, `scene_arrays/materials/base_color`, ...), the reference's
layout, so either package reads the other's files.  The reference's
other path writes an orbax directory, a JAX library's format; here a
path that does not end in `.npz` raises.  Resuming continues the same
sample sequence bit for bit, since a sample is a pure function of
(pixel, frame, sample) (core/sampler.py).
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.device import resolve_device


def _check_path(path):
    if not str(path).endswith(".npz"):
        raise ValueError(f"{path}: checkpoints are .npz files (the orbax directory format "
                         "of the JAX package is not read or written here)")


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif torch.is_tensor(tree):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unflatten(flat, device):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return tree


def save_checkpoint(path, state: dict):
    """Write a nested dict of tensors, arrays and scalars to the .npz `path`."""
    _check_path(path)
    flat = {}
    _flatten(state, "", flat)
    np.savez_compressed(path, **flat)


def load_checkpoint(path, device="cuda"):
    """The nested dict `save_checkpoint` wrote (or the JAX package's .npz
    path wrote), its arrays as tensors on `device`."""
    _check_path(path)
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files}, resolve_device(device))


def render_state(film, frame, scene=None, extra=None):
    """The progressive render's checkpoint dict: {"film", "frame"[,
    "scene_arrays"][, "extra"]}."""
    st = {"film": film.state(), "frame": torch.tensor(int(frame), dtype=torch.int32)}
    if scene is not None:
        st["scene_arrays"] = dict(scene.arrays)
    if extra:
        st["extra"] = dict(extra)
    return st


def restore_render_state(st, film, scene=None):
    """Apply a loaded checkpoint to `film` (and `scene`, through
    Scene.replace); returns (frame, scene)."""
    film.load_state(st["film"])
    frame = int(st["frame"])
    if scene is not None and "scene_arrays" in st:
        scene = scene.replace(**st["scene_arrays"])
    return frame, scene
