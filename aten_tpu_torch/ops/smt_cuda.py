"""Wrapper of the hand-written CUDA multi-chain treelet kernel (K4).

`smt_traverse` runs the walk of kernels/smt_traverse.cu (closest-hit and
any-hit instantiations, 1, 2, 4 or 8 rays per lane) over a scene's
treelet layout (ops/trl_layout.py), in persistent warps that take their
rays from a counter the wrapper zeroes.  It replaces the TPU kernel
`_make_smt_kernel` (aten_tpu/ops/traverse_pallas.py:1335, launched by
`_traverse_smt_tiles` :1542).  On a voxel-LOD scene it runs the `lod`
variant at every chain count, the `has_lod=True` branch (:1489-1497),
over the layout of the baked tree, and raises when the scene's
`lod_depth` differs from its `lod_bake_depth`.  It drains at the
layout's window `trl_window` (any multiple of 8 up to 128), in one of
three instantiations by slots per lane (1 up to a window of 32, 2 up to
64, 4 up to 128), and raises on a window it does not take.  Its
arguments are checked on every device; for tensors on the CPU it then
runs the kernel's plain version, accel/traverse.py::_traverse_trl_plain,
and on a CUDA tensor it launches the kernel or raises, never falling
back.  The kernel lives in the
library of ops/traverse_cuda.py.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.ops.bvh_layout import TREELET_MAX_START
from aten_tpu_torch.ops.lod_layout import lod_of
from aten_tpu_torch.ops.traverse_cuda import _checked, load_library, next_ray_counter
from aten_tpu_torch.ops.plk_layout import k4_window
from aten_tpu_torch.ops.trl_layout import ORDERINGS, RECORD, TRL_NODE
from aten_tpu_torch.utils import spans

CHAIN_COUNTS = (1, 2, 4, 8)
# The rays per lane that the card ran fastest (PERF.md §6: every count
# timed in turns on the same rays); the reference's default is 4
# (traverse_pallas.py:337), which on the H100 cost more.
DEFAULT_CHAINS = 1
# the widest window of each instantiation (slots per lane 1, 2, 4); a
# name without a window suffix is the 64-slot one
DRAINS = (32, 64, 128)
KERNELS = tuple(f"smt_traverse_{kind}_c{c}" for kind in ("closest", "any")
                for c in CHAIN_COUNTS)
LOD_KERNELS = tuple(f"smt_traverse_lod_{kind}_c{c}" for kind in ("closest", "any")
                    for c in CHAIN_COUNTS)


def drain_of(window):
    """The widest window of the instantiation that drains `window`."""
    return next(d for d in DRAINS if k4_window(window) <= d)


# Every instantiation's name.  A launch adds 1 to the counter
# "launch.<name>" (utils/spans.py) on the line after it succeeds.
INSTANTIATIONS = tuple(f"{k}{'' if d == 64 else f'_w{d}'}"
                       for d in DRAINS for k in KERNELS + LOD_KERNELS)


def kernel_name(any_hit, chains, lod=False, window=64):
    """The name of the instantiation that runs at drain window `window`."""
    d = drain_of(window)
    return (f"smt_traverse_{'lod_' if lod else ''}{'any' if any_hit else 'closest'}_c{chains}"
            f"{'' if d == 64 else f'_w{d}'}")


# (name, dtype, trailing shape) of each scene array the kernel reads
_SCENE_FIELDS = (
    ("trl_nodes", torch.float32, (TRL_NODE,)),
    ("trl_links", torch.int32, (2 * ORDERINGS,)),
    ("trl_recs", torch.float32, (RECORD,)),
)


def smt_traverse(scene, ro, rd, t0, any_hit=False, t_min=1e-4, chains=DEFAULT_CHAINS):
    """Closest (or any) hit of rays ro, rd [N,3] with t_max t0 [N] against
    the scene's treelet layout, `chains` rays per lane.  Returns (t, prim),
    each [N]: the winner's t (t0 on a miss) and its global id (-1 on a
    miss).  On a card t_min must be >= 0: the kernel orders a hit's t by
    its bits."""
    dev = ro.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"smt_traverse: unsupported device {dev}")
    if chains not in CHAIN_COUNTS:
        raise ValueError(f"smt_traverse: chains={chains!r}; the kernel is built "
                         f"for {CHAIN_COUNTS} rays per lane")
    lod = lod_of(scene)
    n = ro.shape[0]
    ptrs = [_checked(k, scene[k], dt, tail, dev) for k, dt, tail in _SCENE_FIELDS]
    window = k4_window(scene["trl_window"])
    ro_p = _checked("ro", ro, torch.float32, (3,), dev)
    rd_p = _checked("rd", rd, torch.float32, (3,), dev)
    t0_p = _checked("t0", t0, torch.float32, (), dev)
    if rd.shape[0] != n or t0.shape[0] != n:
        raise ValueError(f"ray counts differ: {n}, {rd.shape[0]}, {t0.shape[0]}")
    if dev.type == "cpu":
        from aten_tpu_torch.accel.traverse import _traverse_trl_plain

        h = _traverse_trl_plain(scene, ro, rd, t0, any_hit, t_min)
        return h["t"], h["prim"]
    if ptrs[0] % 16 or ptrs[1] % 8 or ptrs[2] % 16:
        raise ValueError("trl_nodes and trl_recs must be 16-byte aligned, "
                         "trl_links 8-byte aligned")
    if not t_min >= 0.0:
        raise ValueError(f"smt_traverse: t_min={t_min!r}; the kernel takes t_min >= 0")
    if scene["trl_recs"].shape[0] > TREELET_MAX_START:
        raise ValueError(f"smt_traverse: {scene['trl_recs'].shape[0]} slots; the kernel "
                         f"takes at most {TREELET_MAX_START}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim
    lib = load_library()
    counter = next_ray_counter(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aten_smt_traverse(
            *ptrs, ro_p, rd_p, t0_p, t.data_ptr(), prim.data_ptr(),
            n, float(t_min), int(any_hit), int(chains), int(lod), window, counter.data_ptr(),
            stream)
    if rc != 0:
        what = ("bad arguments" if rc < 0
                else lib.aten_cuda_error_string(rc).decode())
        raise RuntimeError(f"smt_traverse launch failed ({rc}): {what}")
    spans.count("launch." + kernel_name(any_hit, chains, lod, window))
    return t, prim
