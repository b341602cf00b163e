"""Wrapper of the hand-written CUDA Plücker treelet kernel (K3).

`plk_traverse` runs the walk of kernels/plk_traverse.cu (closest-hit and
any-hit instantiations) over a scene's Plücker layout
(ops/plk_layout.py): the packed cut-tree records `plk_nodes`, the slot
records `plk_consts` and `plk_slot2prim`.  It replaces the TPU kernel
`_make_plk_treelet_kernel` (aten_tpu/ops/traverse_pallas.py:1058,
launched by `_traverse_plk_tiles` :1276).  On a voxel-LOD scene it runs
the `lod` variant, the `has_lod=True` branch (:1214-1224, the wrapper's
id translation :2113-2117), over the layout of the baked tree, and
raises when the scene's `lod_depth` differs from its `lod_bake_depth`.
With stats=True it runs the kStats instantiation, the `stats=True`
variant (:1087-1090, :1264-1266, :1289-1294), counted per ray, and also
returns each ray's node steps, fat leaves entered and slot tests; only
the traversal-stats tool and the on-card check call it.  It runs at the
layout's drain window `plk_window` (8, 16, 32, 64 or 128: one
instantiation each) and raises on any other.  Its arguments are checked
on every device; for tensors on the CPU it then runs the kernel's plain
version, accel/traverse.py::_traverse_plk_plain, and on a CUDA tensor it
launches the kernel or raises, never falling back.  The kernel lives in
the library of ops/traverse_cuda.py.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.ops.bvh_layout import NODE_WORDS
from aten_tpu_torch.ops.lod_layout import lod_of
from aten_tpu_torch.ops.plk_layout import RECORD, k3_window
from aten_tpu_torch.ops.traverse_cuda import (
    _checked, _packed, count_tensors, load_library, next_ray_counter)
from aten_tpu_torch.utils import spans

# the drain windows of the instantiations; a name without a window
# suffix is the default window's, 64
WINDOWS = (8, 16, 32, 64, 128)


def kernel_names(variant="", window=64):
    """(closest, any) names of the instantiation `variant` ("", "lod_",
    "stats_" or "lod_stats_") at drain window `window`."""
    suffix = "" if window == 64 else f"_w{window}"
    return tuple(f"plk_traverse_{variant}{kind}{suffix}" for kind in ("closest", "any"))


KERNELS = kernel_names()
LOD_KERNELS = kernel_names("lod_")
STATS_KERNELS = kernel_names("stats_")
LOD_STATS_KERNELS = kernel_names("lod_stats_")
VARIANTS = ("", "lod_", "stats_", "lod_stats_")
# the per-ray counts of the kStats instantiations
COUNTS = ("node_steps", "leaves", "slot_tests")

# Every instantiation's name.  A launch adds 1 to the counter
# "launch.<name>" (utils/spans.py) on the line after it succeeds.
INSTANTIATIONS = tuple(k for w in WINDOWS for v in VARIANTS for k in kernel_names(v, w))


# (name, dtype, trailing shape) of each scene array the kernel reads
_SCENE_FIELDS = (
    ("plk_nodes", torch.float32, (NODE_WORDS,)), ("plk_consts", torch.float32, (RECORD,)),
    ("plk_slot2prim", torch.int32, ()),
)


def plk_traverse(scene, ro, rd, t0, any_hit=False, t_min=1e-4, stats=False):
    """Closest (or any) hit of rays ro, rd [N,3] with t_max t0 [N] against
    the scene's Plücker layout.  Returns (t, prim), each [N]: t the
    winner's t with its log2(plk_window) low mantissa bits cleared (t0 on
    a miss), prim its global id (-1 on a miss); with stats=True also
    {"node_steps", "leaves", "slot_tests"}, each ray's int32 counts."""
    dev = ro.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"plk_traverse: unsupported device {dev}")
    lod = lod_of(scene)
    n = ro.shape[0]
    ptrs = _packed(scene, _SCENE_FIELDS, dev)
    window = k3_window(scene["plk_window"])
    ro_p = _checked("ro", ro, torch.float32, (3,), dev)
    rd_p = _checked("rd", rd, torch.float32, (3,), dev)
    t0_p = _checked("t0", t0, torch.float32, (), dev)
    if rd.shape[0] != n or t0.shape[0] != n:
        raise ValueError(f"ray counts differ: {n}, {rd.shape[0]}, {t0.shape[0]}")
    if dev.type == "cpu":
        from aten_tpu_torch.accel.traverse import _traverse_plk_plain

        if stats:
            h = _traverse_plk_plain(scene, ro, rd, t0, any_hit, t_min, stats=True)[0]
            return h["t"], h["prim"], h["counts"]
        h = _traverse_plk_plain(scene, ro, rd, t0, any_hit, t_min)
        return h["t"], h["prim"]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    counts = count_tensors(COUNTS, n, dev) if stats else None
    out = (t, prim) + ((counts,) if stats else ())
    if n == 0:
        return out
    lib = load_library()
    counter = next_ray_counter(dev)
    count_p = [counts[k].data_ptr() for k in COUNTS] if stats else [None] * 3
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aten_plk_traverse(
            *ptrs, scene["plk_slot2prim"].shape[0], ro_p, rd_p, t0_p, t.data_ptr(),
            prim.data_ptr(), n, float(t_min), int(any_hit), int(lod), window, *count_p,
            counter.data_ptr(), stream)
    if rc != 0:
        what = ("bad arguments" if rc < 0
                else lib.aten_cuda_error_string(rc).decode())
        raise RuntimeError(f"plk_traverse launch failed ({rc}): {what}")
    variant = ("lod_" if lod else "") + ("stats_" if stats else "")
    spans.count("launch." + kernel_names(variant, window)[int(any_hit)])
    return out
