"""Wrapper of the hand-written CUDA two-level traversal kernel (K5).

`tlas_traverse` runs the instanced walk of kernels/tlas_traverse.cu
(closest-hit and any-hit instantiations) on CUDA tensors, over the
scene's packed records of its two-level pool (ops/tlas_layout.py,
`tl_nodes`, `tl_insts` and `tl_prims`), in persistent warps that take
their rays from a counter the wrapper zeroes.  It replaces the TPU
instanced-treelet kernel `_make_tlas_treelet_kernel`
(aten_tpu/ops/traverse_pallas.py:1750, entry `traverse_pallas_tlas`).
Its arguments are checked on every device, the packed records included;
for tensors on the CPU it then runs the kernel's plain version,
accel/tlas.py::_traverse_two_level_plain, over the pool's own `tl_*`
arrays, and on a CUDA tensor it launches the kernel or raises, never
falling back.  The kernel lives in the library of ops/traverse_cuda.py.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.ops.bvh_layout import NODE_WORDS, PRIM_WORDS
from aten_tpu_torch.ops.tlas_layout import INST_WORDS
from aten_tpu_torch.ops.traverse_cuda import _checked, _packed, load_library, next_ray_counter
from aten_tpu_torch.utils import spans

# Every instantiation's name.  A launch adds 1 to the counter
# "launch.<name>" (utils/spans.py) on the line after it succeeds.
KERNELS = ("tlas_traverse_closest", "tlas_traverse_any")


# (name, dtype, trailing shape) of each scene array the kernel reads
_SCENE_FIELDS = (
    ("tl_nodes", torch.float32, (NODE_WORDS,)), ("tl_insts", torch.float32, (INST_WORDS,)),
    ("tl_prims", torch.float32, (PRIM_WORDS,)),
)
# and of each the plain version reads: the pool's own arrays
_PLAIN_FIELDS = (
    ("tl_bmin", torch.float32, (3,)), ("tl_bmax", torch.float32, (3,)),
    ("tl_hit", torch.int32, ()), ("tl_miss", torch.int32, ()),
    ("tl_ps", torch.int32, ()), ("tl_pc", torch.int32, ()),
    ("tl_inst", torch.int32, ()), ("tl_prim_order", torch.int32, ()),
    ("inst_w2l", torch.float32, (3, 4)), ("tri_v0", torch.float32, (3,)),
    ("tri_e1", torch.float32, (3,)), ("tri_e2", torch.float32, (3,)),
    ("sph_center", torch.float32, (3,)), ("sph_radius", torch.float32, ()),
)
_HINT = ("(ops/tlas_layout.py), which the scene build and bridge.from_numpy "
         "attach to every instanced scene")


def tlas_traverse(scene, ro, rd, t0, any_hit=False, t_min=1e-4):
    """Closest (or any) hit of rays ro, rd [N,3] with t_max t0 [N]
    against the scene's two-level pool.  Returns (t, prim, inst, u, v),
    each [N]."""
    dev = ro.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tlas_traverse: unsupported device {dev}")
    n = ro.shape[0]
    ptrs = _packed(scene, _SCENE_FIELDS, dev, _HINT)
    for k, dt, tail in _PLAIN_FIELDS:
        _checked(k, scene[k], dt, tail, dev)
    ro_p = _checked("ro", ro, torch.float32, (3,), dev)
    rd_p = _checked("rd", rd, torch.float32, (3,), dev)
    t0_p = _checked("t0", t0, torch.float32, (), dev)
    if rd.shape[0] != n or t0.shape[0] != n:
        raise ValueError(f"ray counts differ: {n}, {rd.shape[0]}, {t0.shape[0]}")
    n_inst = int(scene["num_instances"])
    if n_inst <= 0 or scene["inst_w2l"].shape[0] != n_inst + 1:
        raise ValueError(f"inst_w2l holds {scene['inst_w2l'].shape[0]} rows "
                         f"for {n_inst} instances (expected instances + 1)")
    if scene["tl_insts"].shape[0] != n_inst:
        raise ValueError(f"tl_insts holds {scene['tl_insts'].shape[0]} records "
                         f"for {n_inst} instances")
    if dev.type == "cpu":
        from aten_tpu_torch.accel.tlas import _traverse_two_level_plain

        h = _traverse_two_level_plain(scene, ro, rd, t0, any_hit, t_min)
        return h["t"], h["prim"], h["inst"], h["u"], h["v"]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, inst, u, v
    lib = load_library()
    counter = next_ray_counter(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aten_tlas_traverse(
            *ptrs, int(scene["num_tris"]), n_inst, ro_p, rd_p, t0_p,
            t.data_ptr(), prim.data_ptr(), inst.data_ptr(), u.data_ptr(),
            v.data_ptr(), n, float(t_min), int(any_hit), counter.data_ptr(), stream)
    if rc != 0:
        what = ("bad arguments" if rc < 0
                else lib.aten_cuda_error_string(rc).decode())
        raise RuntimeError(f"tlas_traverse launch failed ({rc}): {what}")
    spans.count("launch." + KERNELS[int(any_hit)])
    return t, prim, inst, u, v
