"""K1 and K3 against their first design, in turns on one card.

    python3 -m aten_tpu_torch.tools.first_design_ab DIR

Run from the root of a checkout on a machine with one CUDA card.  DIR
holds a checkout whose kernels are the first design of K1
(kernels/bvh_traverse.cu) and K3 (kernels/plk_traverse.cu): one thread
per ray over the BVH's and the cut tree's own arrays, with that design's
C interface (`aten_bvh_traverse` taking the twelve `nodes_*`,
`prim_order`, `tri_*` and `sph_*` arrays, `aten_plk_traverse` the eight
`plk_*` arrays; for example the commit before the packed records
arrived, unpacked with `git archive` into a directory that .gitignore
lists).  The tool builds DIR's kernels into build/, beside this
checkout's, and on rays made as chip_smoke.py's phases 2 and 7 make them
(4,194,304 each: jittered camera rays and surface or first-hit rays)
holds the two designs' outputs bitwise equal and times them in turns
(old, new, new, old), closest-hit and any-hit: K1 on the 102,404-prim
and the 2,004-prim mesh scenes, K3 on the 512,004-prim scene.  The last
line is one JSON object of the times.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import time

import torch

from aten_tpu_torch import native

# The first design's sources, and the scene arrays its two entry points
# read, in the order of their C arguments.
SOURCES = ("bvh_traverse.cu", "tlas_traverse.cu", "plk_traverse.cu", "smt_traverse.cu",
           "bindings.cpp")
BVH_ARRAYS = ("nodes_bmin", "nodes_bmax", "nodes_hit", "nodes_miss", "nodes_prim_start",
              "nodes_prim_count", "prim_order", "tri_v0", "tri_e1", "tri_e2", "sph_center",
              "sph_radius")
PLK_ARRAYS = ("plk_bmin", "plk_bmax", "plk_hit", "plk_miss", "plk_slot_start", "plk_count",
              "plk_consts", "plk_slot2prim")
SEED = 20261016
N_RAYS = 512 * 512 * 16


def load_first_design(path):
    """Build the kernels of the checkout at `path` and return the ctypes
    library, its two entry points typed as the first design has them."""
    from torch.utils.cpp_extension import load

    from aten_tpu_torch.ops.traverse_cuda import CUDA_FLAGS

    kdir = os.path.join(os.path.abspath(path), "aten_tpu_torch", "kernels")
    build_dir = os.path.join(native.BUILD_DIR, "first_design")
    os.makedirs(build_dir, exist_ok=True)
    so = load(name="aten_tpu_torch_bvh_first_design",
              sources=[os.path.join(kdir, f) for f in SOURCES],
              build_directory=build_dir, extra_cflags=["-O3"],
              extra_cuda_cflags=list(CUDA_FLAGS), extra_include_paths=[kdir],
              is_python_module=False, verbose=False)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.aten_bvh_traverse.restype = ctypes.c_int
    lib.aten_bvh_traverse.argtypes = (
        [vp] * len(BVH_ARRAYS) + [ctypes.c_int32] + [vp] * 7
        + [ctypes.c_int64, ctypes.c_float, ctypes.c_int32, vp])
    lib.aten_plk_traverse.restype = ctypes.c_int
    lib.aten_plk_traverse.argtypes = (
        [vp] * (len(PLK_ARRAYS) + 5) + [ctypes.c_int64, ctypes.c_float, ctypes.c_int32, vp])
    return lib


def first_design_run(lib, kernel, scene, ro, rd, t0, any_hit, t_min):
    """One launch of the first design's K1 ("k1": (t, prim, u, v)) or K3
    ("k3": (t, prim)) on the scene's own arrays."""
    n = ro.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=ro.device)
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    uv = [torch.empty(n, dtype=torch.float32, device=ro.device) for _ in range(2)]
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    if kernel == "k1":
        rc = lib.aten_bvh_traverse(
            *(scene[k].data_ptr() for k in BVH_ARRAYS), int(scene["num_tris"]),
            ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t.data_ptr(), prim.data_ptr(),
            uv[0].data_ptr(), uv[1].data_ptr(), n, float(t_min), int(any_hit), stream)
        out = (t, prim, *uv)
    else:
        rc = lib.aten_plk_traverse(
            *(scene[k].data_ptr() for k in PLK_ARRAYS), ro.data_ptr(), rd.data_ptr(),
            t0.data_ptr(), t.data_ptr(), prim.data_ptr(), n, float(t_min), int(any_hit),
            stream)
        out = (t, prim)
    if rc != 0:
        raise RuntimeError(f"the first design's {kernel} launch failed ({rc})")
    return out


def ab_times(name, card, old_fn, new_fn, cuda_ms, reps=10):
    """Device ms of old_fn and new_fn in turns (old, new, new, old) on the
    same inputs, after checking that their outputs are bitwise equal:
    (old ms, new ms), each the mean of its two turns."""
    a, b = old_fn(), new_fn()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    turns = [cuda_ms(f, reps) for f in (old_fn, new_fn, new_fn, old_fn)]
    old, new = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"{name} in turns (old, new, new, old): {turns[0]:.3f}, {turns[1]:.3f}, "
          f"{turns[2]:.3f}, {turns[3]:.3f} ms; old {old:.3f} ms, new {new:.3f} ms "
          f"({old / new:.2f}x); outputs bitwise equal {same} [{card}]", flush=True)
    if not same:
        raise AssertionError(f"{name}: the two designs' outputs differ")
    return old, new


def main(argv):
    if len(argv) != 2 or not os.path.isdir(os.path.join(argv[1], "aten_tpu_torch", "kernels")):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("first_design_ab: no CUDA card is available")
    sys.path.insert(0, native.REPO_ROOT)
    import numpy as np

    # the ray makers and the timer of chip_smoke.py, at the checkout's root
    import chip_smoke as smoke
    from aten_tpu_torch.accel.traverse import _t0_of
    from aten_tpu_torch.ops import plk_cuda, traverse_cuda
    from aten_tpu_torch.scene.scenedefs import large_mesh_scene, procedural_mesh_scene

    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t = time.time()
    traverse_cuda.load_library()
    lib = load_first_design(argv[1])
    print(f"built both designs in {time.time() - t:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    mid, _ = procedural_mesh_scene(512, 512, n_u=40, n_v=25, device=dev)
    large, lcam = large_mesh_scene(512, 512, device=dev)
    results = {}
    for name, scene, kernel in (("K1 102,404 prims", big, "k1"), ("K1 2,004 prims", mid, "k1"),
                                ("K3 512,004 prims", large, "k3")):
        c = lcam if kernel == "k3" else cam
        cro, crd = smoke.camera_rays(c, dev, jitter_rng=rng, subsamples=8)
        if kernel == "k3":
            sro, srd = smoke.first_hit_rays(scene, cro, crd, N_RAYS - cro.shape[0], rng,
                                            impl="plk")
        else:
            sro, srd = smoke.surface_rays(scene, N_RAYS - cro.shape[0], rng, dev)
        ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
        dist = torch.tensor(rng.uniform(0.0, 20.0, N_RAYS), dtype=torch.float32, device=dev)
        walk = traverse_cuda.bvh_traverse if kernel == "k1" else plk_cuda.plk_traverse
        for kind, t0k, any_hit, t_min in (("closest", _t0_of(None, N_RAYS, dev), False, 1e-4),
                                          ("any", dist, True, 1e-3)):
            old, cur = ab_times(
                f"{name} {kind}-hit, {N_RAYS} rays", card,
                lambda: first_design_run(lib, kernel, scene, ro, rd, t0k, any_hit, t_min),
                lambda: walk(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min), smoke.cuda_ms)
            results[f"{name} {kind}"] = {"first_design_ms": old, "ms": cur}
        del ro, rd, cro, crd, sro, srd, dist
    print(json.dumps({"card": card, "rays": N_RAYS, "ab": results}), flush=True)


if __name__ == "__main__":
    main(sys.argv)
