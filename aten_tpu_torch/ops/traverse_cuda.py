"""Wrapper of the hand-written CUDA traversal kernel.

`bvh_traverse` runs the threaded-BVH walk of kernels/bvh_traverse.cu
(closest-hit and any-hit instantiations, each also in a voxel-LOD
variant) on CUDA tensors, over the scene's packed node and prim records
(ops/bvh_layout.py, `bvh_nodes` and `bvh_prims`), in persistent warps that take their rays from a
counter the wrapper zeroes.  It replaces
the TPU treelet kernel `_make_treelet_kernel`
(aten_tpu/ops/traverse_pallas.py:785, with `_recompute_uv` :1573) and
serves the uncut-tree case of `_make_kernel` (:102) with the same code.
On a voxel-LOD scene (accel/voxel.py) it runs the `lod` variant, the
`has_lod=True` branch of `_make_treelet_kernel` (:922-923, :950-963),
over the records of the tree baked at the scene's `lod_bake_depth`, and
raises when the scene's `lod_depth` differs from it.
With stats=True it runs the kStats instantiation, the `stats=True`
variant of `_make_treelet_kernel` (:813-816, :911-913, :1000-1002,
:1026-1032), counted per ray, and also returns each ray's node steps and
prim tests; only the traversal-stats tool and the on-card check call it.
For tensors on the CPU it runs the kernel's plain version,
accel/traverse.py::_traverse_plain (over the baked records, baked=True,
on a voxel-LOD scene); on a CUDA tensor it launches the kernel or
raises, never falling back.

The library, which also holds the two-level kernel K5 of ops/tlas_cuda.py,
the Plücker treelet kernel of ops/plk_cuda.py and the multi-chain
treelet kernel of ops/smt_cuda.py, is built at first
use from the repository's sources with torch.utils.cpp_extension.load
into build/aten_tpu_torch/, for sm_90a, with --fmad=false, under a file
lock; ninja compiles the sources in parallel, and nvcc each source's
kernels on every core (--split-compile=0, CUDA 12.1 and later).  Its
interface is plain C (kernels/bindings.cpp), loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import os

import torch

from aten_tpu_torch import native
from aten_tpu_torch.ops.bvh_layout import NODE_WORDS, PRIM_WORDS
from aten_tpu_torch.ops.lod_layout import lod_of
from aten_tpu_torch.utils import spans

KERNEL_DIR = os.path.join(native.REPO_ROOT, "aten_tpu_torch", "kernels")
SOURCES = (os.path.join(KERNEL_DIR, "bvh_traverse.cu"),
           os.path.join(KERNEL_DIR, "tlas_traverse.cu"),
           os.path.join(KERNEL_DIR, "plk_traverse.cu"),
           os.path.join(KERNEL_DIR, "smt_traverse.cu"),
           os.path.join(KERNEL_DIR, "bindings.cpp"))
# --split-compile=0: nvcc optimizes a source's kernels on every core
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "--split-compile=0", "-Xptxas=-v")
KERNELS = ("bvh_traverse_closest", "bvh_traverse_any")
LOD_KERNELS = ("bvh_traverse_lod_closest", "bvh_traverse_lod_any")
STATS_KERNELS = ("bvh_traverse_stats_closest", "bvh_traverse_stats_any")
LOD_STATS_KERNELS = ("bvh_traverse_lod_stats_closest", "bvh_traverse_lod_stats_any")
# the per-ray counts of the kStats instantiations
COUNTS = ("node_steps", "prim_tests")

# Every instantiation's name.  A launch adds 1 to the counter
# "launch.<name>" (utils/spans.py) on the line after it succeeds.
INSTANTIATIONS = KERNELS + LOD_KERNELS + STATS_KERNELS + LOD_STATS_KERNELS

_lib = None


def load_library(verbose=False):
    """Build (if its sources changed) and load the kernel library of
    the traversal kernels."""
    global _lib
    if _lib is not None:
        return _lib
    from torch.utils.cpp_extension import load

    build_dir = os.path.join(native.BUILD_DIR, "bvh_traverse")
    os.makedirs(build_dir, exist_ok=True)
    with native.build_lock("bvh_traverse"):
        path = load(
            name="aten_tpu_torch_bvh",
            sources=list(SOURCES),
            build_directory=build_dir,
            extra_cflags=["-O3"],
            extra_cuda_cflags=list(CUDA_FLAGS),
            extra_include_paths=[KERNEL_DIR],
            is_python_module=False,
            verbose=verbose,
        )
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.aten_bvh_traverse.restype = ctypes.c_int
    lib.aten_bvh_traverse.argtypes = (
        [vp] * 2 + [ctypes.c_int32] + [vp] * 7
        + [ctypes.c_int64, ctypes.c_float, ctypes.c_int32, ctypes.c_int32] + [vp] * 4)
    lib.aten_tlas_traverse.restype = ctypes.c_int
    lib.aten_tlas_traverse.argtypes = (
        [vp] * 3 + [ctypes.c_int32] * 2 + [vp] * 8
        + [ctypes.c_int64, ctypes.c_float, ctypes.c_int32, vp, vp])
    lib.aten_plk_traverse.restype = ctypes.c_int
    lib.aten_plk_traverse.argtypes = (
        [vp] * 3 + [ctypes.c_int32] + [vp] * 5
        + [ctypes.c_int64, ctypes.c_float] + [ctypes.c_int32] * 3 + [vp] * 5)
    lib.aten_smt_traverse.restype = ctypes.c_int
    lib.aten_smt_traverse.argtypes = (
        [vp] * 8 + [ctypes.c_int64, ctypes.c_float] + [ctypes.c_int32] * 4 + [vp, vp])
    lib.aten_cuda_error_string.restype = ctypes.c_char_p
    lib.aten_cuda_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


# (name, dtype, trailing shape) of each scene array the kernel reads
_SCENE_FIELDS = (
    ("bvh_nodes", torch.float32, (NODE_WORDS,)), ("bvh_prims", torch.float32, (PRIM_WORDS,)),
)


_K1_HINT = ("(ops/bvh_layout.py); its build did not choose this kernel "
            "(scene.scene.with_bvh_layout attaches K1's)")


def _packed(scene, fields, device, hint=_K1_HINT):
    """Data pointers of the scene's packed records `fields`, checked as
    `_checked` does and for the 16-byte alignment of float4 reads; `hint`
    says where such records come from."""
    missing = [k for k, _, _ in fields if k not in scene]
    if missing:
        raise ValueError(f"the scene lacks the packed records {missing} {hint}")
    ptrs = [_checked(k, scene[k], dt, tail, device) for k, dt, tail in fields]
    if any(p % 16 for p in ptrs):
        raise ValueError("packed records must be 16-byte aligned (read as float4)")
    return ptrs


def next_ray_counter(device):
    """The zeroed ray counter of a persistent launch."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _checked(name, x, dtype, tail, device):
    """x's data pointer, after checking its device, dtype, trailing
    shape `tail` (x is [n, *tail]) and contiguity."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, rays are on {device}")
    if x.dtype != dtype or x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail:
        raise ValueError(f"{name}: expected {dtype} [n, {tail}], "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def count_tensors(names, n, device):
    """{name: int32 [n]} outputs of a kStats launch."""
    return {k: torch.empty(n, dtype=torch.int32, device=device) for k in names}


def bvh_traverse(scene, ro, rd, t0, any_hit=False, t_min=1e-4, stats=False):
    """Closest (or any) hit of rays ro, rd [N,3] with t_max t0 [N] against
    the scene's threaded BVH (of a voxel-LOD scene: its baked tree).
    Returns (t, prim, u, v), each [N], and with stats=True also
    {"node_steps", "prim_tests"}, each ray's int32 counts."""
    lod = lod_of(scene)
    if ro.device.type == "cpu":
        from aten_tpu_torch.accel.traverse import _traverse_plain

        h = _traverse_plain(scene, ro, rd, t0, any_hit, t_min, stats=stats, baked=lod)
        if stats:
            h = h[0]
            return h["t"], h["prim"], h["u"], h["v"], h["counts"]
        return h["t"], h["prim"], h["u"], h["v"]
    if ro.device.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {ro.device}")
    dev = ro.device
    n = ro.shape[0]
    ptrs = _packed(scene, _SCENE_FIELDS, dev)
    ro_p = _checked("ro", ro, torch.float32, (3,), dev)
    rd_p = _checked("rd", rd, torch.float32, (3,), dev)
    t0_p = _checked("t0", t0, torch.float32, (), dev)
    if rd.shape[0] != n or t0.shape[0] != n:
        raise ValueError(f"ray counts differ: {n}, {rd.shape[0]}, {t0.shape[0]}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    counts = count_tensors(COUNTS, n, dev) if stats else None
    out = (t, prim, u, v) + ((counts,) if stats else ())
    if n == 0:
        return out
    lib = load_library()
    counter = next_ray_counter(dev)
    count_p = [counts[k].data_ptr() for k in COUNTS] if stats else [None, None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aten_bvh_traverse(
            *ptrs, int(scene["num_tris"]), ro_p, rd_p, t0_p,
            t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            n, float(t_min), int(any_hit), int(lod), *count_p, counter.data_ptr(), stream)
    if rc != 0:
        what = ("bad arguments" if rc < 0
                else lib.aten_cuda_error_string(rc).decode())
        raise RuntimeError(f"bvh_traverse launch failed ({rc}): {what}")
    names = ((LOD_STATS_KERNELS if lod else STATS_KERNELS) if stats
             else (LOD_KERNELS if lod else KERNELS))
    spans.count("launch." + names[int(any_hit)])
    return out
