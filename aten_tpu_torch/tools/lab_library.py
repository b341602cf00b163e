"""The labs' kernel library (kernels/chase_lab.cu, kernels/launch_lab.cu,
kernels/kernel_lab.cu).

Built at first use from the repository's sources with
torch.utils.cpp_extension.load into build/aten_tpu_torch/labs/, for
sm_90a, with --fmad=false, under the file lock of native.py, apart from
the traversal library so that neither build waits on the other.  Its
interface is plain C, loaded with ctypes: `aten_chase_lab` (L3,
tools/chase_lab.py), `aten_launch_lab` (L2, tools/launch_lab.py) and
`aten_kernel_lab` (L1, tools/kernel_lab.py).
"""
from __future__ import annotations

import ctypes
import os

from aten_tpu_torch import native
from aten_tpu_torch.ops.traverse_cuda import CUDA_FLAGS, KERNEL_DIR

SOURCES = (os.path.join(KERNEL_DIR, "chase_lab.cu"),
           os.path.join(KERNEL_DIR, "launch_lab.cu"),
           os.path.join(KERNEL_DIR, "kernel_lab.cu"))

_lib = None


def load_library(verbose=False):
    """Build (if its sources changed) and load the labs' library."""
    global _lib
    if _lib is not None:
        return _lib
    from torch.utils.cpp_extension import load

    build_dir = os.path.join(native.BUILD_DIR, "labs")
    os.makedirs(build_dir, exist_ok=True)
    with native.build_lock("labs"):
        path = load(
            name="aten_tpu_torch_labs",
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
    lib.aten_chase_lab.restype = ctypes.c_int
    lib.aten_chase_lab.argtypes = [vp, vp, vp, ctypes.c_int32, ctypes.c_int32, vp]
    lib.aten_launch_lab.restype = ctypes.c_int
    lib.aten_launch_lab.argtypes = [vp, vp, ctypes.c_int32, ctypes.c_int32, vp]
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.aten_kernel_lab.restype = ctypes.c_int
    lib.aten_kernel_lab.argtypes = [i32] * 4 + [vp] * 6 + [i64] + [vp] * 5 + [i64, vp]
    lib.aten_lab_error_string.restype = ctypes.c_char_p
    lib.aten_lab_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def check(lib, rc, what):
    """Raise if a launch returned non-zero."""
    if rc != 0:
        why = "bad arguments" if rc < 0 else lib.aten_lab_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed ({rc}): {why}")
