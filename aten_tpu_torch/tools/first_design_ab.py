"""Traversal kernels against their first design, in turns on one card.

    python3 -m aten_tpu_torch.tools.first_design_ab DIR [k1k3|k5k4|l1]

Run from the root of a checkout on a machine with one CUDA card.  DIR
holds a checkout whose kernels are the first design of the group named
(default k1k3), with that design's C interface; for example the commit
before the group's redesign, unpacked with `git archive` into a
directory that .gitignore lists.  The tool builds DIR's kernels into
build/, beside this checkout's, holds the two designs' outputs bitwise
equal and times them in turns (old, new, new, old), closest-hit and
any-hit, on 4,194,304 rays made as chip_smoke.py makes them:

* k1k3: K1 (kernels/bvh_traverse.cu) and K3 (kernels/plk_traverse.cu),
  whose first design is one thread per ray over the BVH's and the cut
  tree's own arrays (`aten_bvh_traverse` taking the twelve `nodes_*`,
  `prim_order`, `tri_*` and `sph_*` arrays, `aten_plk_traverse` the
  eight `plk_*` arrays).  K1 on the 102,404-prim and the 2,004-prim mesh
  scenes (phase 2's rays), K3 on the 512,004-prim scene (phase 7's).
* k5k4: K5 (kernels/tlas_traverse.cu) and K4 (kernels/smt_traverse.cu),
  whose first design is one thread per ray over the pool's own `tl_*`
  arrays (`aten_tlas_traverse` taking the fourteen arrays of
  ops/tlas_cuda.py's _PLAIN_FIELDS) and C rays per thread on a plain grid
  (`aten_smt_traverse` without a ray counter).  K5 on the 19-instance
  fixture (phase 5's rays), K4 at C = 1, 2, 4 and 8 on the 102,404-prim
  and the 512,004-prim scenes (phase 9's rays: phases 2 and 7).
* l1: the treelet-walk lab L1 (kernels/kernel_lab.cu), whose first
  design walks every tile, plk's too, with one 1024-thread block: each
  variant that phase 11 of chip_smoke.py runs, on its 1,048,576 primary
  rays of the 102,404-prim scene (tools/kernel_lab.py's `lab_rays`), in
  L1_ROUNDS rounds of turns.  Only plk was redesigned (four rays a
  thread, its blocks double-buffered); the other variants kept their
  first design, and their ratios show the spread of the timing.

The last line is one JSON object of the times.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import time

import torch

from aten_tpu_torch import native

# The first design's sources, and the scene arrays its entry points read,
# in the order of their C arguments.
SOURCES = ("bvh_traverse.cu", "tlas_traverse.cu", "plk_traverse.cu", "smt_traverse.cu",
           "bindings.cpp")
BVH_ARRAYS = ("nodes_bmin", "nodes_bmax", "nodes_hit", "nodes_miss", "nodes_prim_start",
              "nodes_prim_count", "prim_order", "tri_v0", "tri_e1", "tri_e2", "sph_center",
              "sph_radius")
PLK_ARRAYS = ("plk_bmin", "plk_bmax", "plk_hit", "plk_miss", "plk_slot_start", "plk_count",
              "plk_consts", "plk_slot2prim")
TLAS_ARRAYS = ("tl_bmin", "tl_bmax", "tl_hit", "tl_miss", "tl_ps", "tl_pc", "tl_inst",
               "tl_prim_order", "inst_w2l", "tri_v0", "tri_e1", "tri_e2", "sph_center",
               "sph_radius")
TRL_ARRAYS = ("trl_nodes", "trl_links", "trl_recs")
# the first design of L1 (kernel_lab.cu; launch_lab.cu holds the labs'
# error strings), and the variants phase 11 runs
LAB_SOURCES = ("kernel_lab.cu", "launch_lab.cu")
LAB_VARIANTS = ("nodes", "nodir", "leafu", "wide8", "wide16", "wide8_nc", "wide16_nc",
                "spec8", "spec16", "plk")
GROUPS = ("k1k3", "k5k4", "l1")
L1_ROUNDS = 5
SEED = 20261016
N_RAYS = 512 * 512 * 16


def load_first_design(path, group):
    """Build the kernels of the checkout at `path` and return the ctypes
    library, the entry points of `group` typed as the first design has
    them."""
    from torch.utils.cpp_extension import load

    from aten_tpu_torch.ops.traverse_cuda import CUDA_FLAGS

    kdir = os.path.join(os.path.abspath(path), "aten_tpu_torch", "kernels")
    build_dir = os.path.join(native.BUILD_DIR, f"first_design_{group}")
    os.makedirs(build_dir, exist_ok=True)
    so = load(name=f"aten_tpu_torch_first_design_{group}",
              sources=[os.path.join(kdir, f) for f in (LAB_SOURCES if group == "l1" else SOURCES)],
              build_directory=build_dir, extra_cflags=["-O3"],
              extra_cuda_cflags=list(CUDA_FLAGS), extra_include_paths=[kdir],
              is_python_module=False, verbose=False)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    tail = [ctypes.c_int64, ctypes.c_float, i32]
    if group == "l1":
        lib.aten_kernel_lab.restype = ctypes.c_int
        lib.aten_kernel_lab.argtypes = [i32] * 4 + [vp] * 6 + [ctypes.c_int64] + [vp] * 5 + [
            ctypes.c_int64, vp]
    elif group == "k1k3":
        lib.aten_bvh_traverse.restype = ctypes.c_int
        lib.aten_bvh_traverse.argtypes = [vp] * len(BVH_ARRAYS) + [i32] + [vp] * 7 + tail + [vp]
        lib.aten_plk_traverse.restype = ctypes.c_int
        lib.aten_plk_traverse.argtypes = [vp] * (len(PLK_ARRAYS) + 5) + tail + [vp]
    else:
        lib.aten_tlas_traverse.restype = ctypes.c_int
        lib.aten_tlas_traverse.argtypes = [vp] * len(TLAS_ARRAYS) + [i32] * 2 + [vp] * 8 + tail + [vp]
        lib.aten_smt_traverse.restype = ctypes.c_int
        lib.aten_smt_traverse.argtypes = [vp] * (len(TRL_ARRAYS) + 5) + tail + [i32, vp]
    return lib


def first_design_run(lib, kernel, scene, ro, rd, t0, any_hit, t_min, chains=None):
    """One launch of the first design's K1 ("k1": (t, prim, u, v)), K3
    ("k3": (t, prim)), K5 ("k5": (t, prim, inst, u, v)) or K4 at `chains`
    rays per thread ("k4": (t, prim)) on the scene's own arrays."""
    n = ro.shape[0]
    dev = ro.device

    def f32():
        return torch.empty(n, dtype=torch.float32, device=dev)

    def i32():
        return torch.empty(n, dtype=torch.int32, device=dev)

    stream = torch.cuda.current_stream(dev).cuda_stream
    rays = (ro.data_ptr(), rd.data_ptr(), t0.data_ptr())
    if kernel == "k1":
        out = (f32(), i32(), f32(), f32())
        rc = lib.aten_bvh_traverse(
            *(scene[k].data_ptr() for k in BVH_ARRAYS), int(scene["num_tris"]), *rays,
            *(x.data_ptr() for x in out), n, float(t_min), int(any_hit), stream)
    elif kernel == "k3":
        out = (f32(), i32())
        rc = lib.aten_plk_traverse(
            *(scene[k].data_ptr() for k in PLK_ARRAYS), *rays, *(x.data_ptr() for x in out),
            n, float(t_min), int(any_hit), stream)
    elif kernel == "k5":
        out = (f32(), i32(), i32(), f32(), f32())
        rc = lib.aten_tlas_traverse(
            *(scene[k].data_ptr() for k in TLAS_ARRAYS), int(scene["num_tris"]),
            int(scene["num_instances"]), *rays, *(x.data_ptr() for x in out), n,
            float(t_min), int(any_hit), stream)
    else:
        out = (f32(), i32())
        rc = lib.aten_smt_traverse(
            *(scene[k].data_ptr() for k in TRL_ARRAYS), *rays, *(x.data_ptr() for x in out),
            n, float(t_min), int(any_hit), int(chains), stream)
    if rc != 0:
        raise RuntimeError(f"the first design's {kernel} launch failed ({rc})")
    return out


def ab_times(name, card, old_fn, new_fn, cuda_ms, reps=10, rounds=1):
    """Device ms of old_fn and new_fn in turns (old, new, new, old) on the
    same inputs, `rounds` times, after checking that their outputs are
    bitwise equal: (old ms, new ms, [old / new of each round]), each time
    the mean of its turns."""
    a, b = old_fn(), new_fn()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    olds, news = [], []
    for _ in range(rounds):
        turns = [cuda_ms(f, reps) for f in (old_fn, new_fn, new_fn, old_fn)]
        olds.append((turns[0] + turns[3]) / 2)
        news.append((turns[1] + turns[2]) / 2)
        print(f"{name} in turns (old, new, new, old): {turns[0]:.3f}, {turns[1]:.3f}, "
              f"{turns[2]:.3f}, {turns[3]:.3f} ms; old {olds[-1]:.3f} ms, new {news[-1]:.3f} "
              f"ms ({olds[-1] / news[-1]:.3f}x); outputs bitwise equal {same} [{card}]",
              flush=True)
    if not same:
        raise AssertionError(f"{name}: the two designs' outputs differ")
    return sum(olds) / rounds, sum(news) / rounds, [o / n for o, n in zip(olds, news)]


def _ray_sets(smoke, rng, dev, cases):
    """Per (name, scene, cam, kind) of `cases`, the N_RAYS rays chip_smoke.py
    makes for it: jittered camera rays, then surface rays ("surface") or
    rays from first hits of the camera rays ("first_hit", "first_hit_plk"),
    and t_max distances for any-hit."""
    import numpy as np

    for name, scene, cam, kind in cases:
        cro, crd = smoke.camera_rays(cam, dev, jitter_rng=rng, subsamples=8)
        if kind == "surface":
            sro, srd = smoke.surface_rays(scene, N_RAYS - cro.shape[0], rng, dev)
        else:
            sro, srd = smoke.first_hit_rays(scene, cro, crd, N_RAYS - cro.shape[0], rng,
                                            impl="plk" if kind == "first_hit_plk" else "cuda")
        dist = torch.tensor(rng.uniform(0.0, 20.0, N_RAYS), dtype=torch.float32, device=dev)
        yield name, scene, torch.cat([cro, sro]), torch.cat([crd, srd]), dist


def _ab_k1k3(lib, smoke, card, rng, dev):
    from aten_tpu_torch.ops import plk_cuda, traverse_cuda
    from aten_tpu_torch.scene.scenedefs import large_mesh_scene, procedural_mesh_scene

    big, cam = procedural_mesh_scene(512, 512, device=dev)
    mid, _ = procedural_mesh_scene(512, 512, n_u=40, n_v=25, device=dev)
    large, lcam = large_mesh_scene(512, 512, device=dev)
    cases = (("K1 102,404 prims", big, cam, "surface"), ("K1 2,004 prims", mid, cam, "surface"),
             ("K3 512,004 prims", large, lcam, "first_hit_plk"))
    results = {}
    for name, scene, ro, rd, dist in _ray_sets(smoke, rng, dev, cases):
        kernel = "k3" if name.startswith("K3") else "k1"
        walk = traverse_cuda.bvh_traverse if kernel == "k1" else plk_cuda.plk_traverse
        for kind, t0k, any_hit, t_min in _kinds(dist):
            old, cur, _ = ab_times(
                f"{name} {kind}-hit, {N_RAYS} rays", card,
                lambda: first_design_run(lib, kernel, scene, ro, rd, t0k, any_hit, t_min),
                lambda: walk(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min), smoke.cuda_ms)
            results[f"{name} {kind}"] = {"first_design_ms": old, "ms": cur}
    return results


def _ab_k5k4(lib, smoke, card, rng, dev):
    from aten_tpu_torch.ops import smt_cuda, tlas_cuda
    from aten_tpu_torch.scene.scene import with_trl_layout
    from aten_tpu_torch.scene.scenedefs import (instanced_mesh_scene, large_mesh_scene,
                                                procedural_mesh_scene)

    inst, icam = instanced_mesh_scene(512, 512, device=dev)
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    large, lcam = large_mesh_scene(512, 512, device=dev)
    cases = (("K5 19 instances", inst, icam, "first_hit"),
             ("K4 102,404 prims", big, cam, "surface"),
             ("K4 512,004 prims", large, lcam, "first_hit_plk"))
    results = {}
    for name, scene, ro, rd, dist in _ray_sets(smoke, rng, dev, cases):
        if name.startswith("K5"):
            for kind, t0k, any_hit, t_min in _kinds(dist):
                old, cur, _ = ab_times(
                    f"{name} {kind}-hit, {N_RAYS} rays", card,
                    lambda: first_design_run(lib, "k5", scene, ro, rd, t0k, any_hit, t_min),
                    lambda: tlas_cuda.tlas_traverse(scene, ro, rd, t0k, any_hit=any_hit,
                                                    t_min=t_min), smoke.cuda_ms)
                results[f"{name} {kind}"] = {"first_design_ms": old, "ms": cur}
            continue
        trl = with_trl_layout(scene)  # as phase 9 attaches it
        for kind, t0k, any_hit, t_min in _kinds(dist):
            for c in smt_cuda.CHAIN_COUNTS:
                old, cur, _ = ab_times(
                    f"{name} {kind}-hit C={c}, {N_RAYS} rays", card,
                    lambda: first_design_run(lib, "k4", trl, ro, rd, t0k, any_hit, t_min, c),
                    lambda: smt_cuda.smt_traverse(trl, ro, rd, t0k, any_hit=any_hit,
                                                  t_min=t_min, chains=c), smoke.cuda_ms)
                results[f"{name} {kind} C={c}"] = {"first_design_ms": old, "ms": cur}
        del trl
    return results


def first_design_lab(lib, tab, ro, rd, t0, v):
    """One launch of the first design's L1 variant `v` (a Variant of
    tools/kernel_lab.py) over the lab's tables: (t, prim)."""
    from aten_tpu_torch.tools import kernel_lab as kl

    n = ro.shape[0]
    t = torch.empty_like(t0)
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    rc = lib.aten_kernel_lab(
        kl.KINDS.index(v.kind), v.tile_rows, int(v.leaf_cond), kl.drain_of(tab, v),
        *(tab[k].data_ptr() for k, _, _ in kl._TABLES), tab["recs"].shape[0],
        ro.data_ptr(), rd.data_ptr(), t0.data_ptr(), t.data_ptr(), prim.data_ptr(), n,
        torch.cuda.current_stream(ro.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the first design's kernel_lab {v.kernel} launch failed ({rc})")
    return t, prim


def _ab_l1(lib, smoke, card, rng, dev):
    from aten_tpu_torch.scene.scene import with_trl_layout
    from aten_tpu_torch.scene.scenedefs import procedural_mesh_scene
    from aten_tpu_torch.tools import kernel_lab as kl

    scene, cam = procedural_mesh_scene(1024, 1024, device=dev)
    tab = kl.tables(with_trl_layout(scene))
    ro, rd, t0 = kl.lab_rays(cam, 1024, dev)
    results = {}
    for name in LAB_VARIANTS:
        v = kl.parse(name)
        old, cur, ratios = ab_times(
            f"L1 {name}, {ro.shape[0]} lab rays", card,
            lambda: first_design_lab(lib, tab, ro, rd, t0, v),
            lambda: kl.run(tab, ro, rd, t0, v), smoke.cuda_ms, rounds=L1_ROUNDS)
        results[f"L1 {name}"] = {"first_design_ms": old, "ms": cur, "round_ratios": ratios}
    return results


def _kinds(dist):
    """(kind, t0, any_hit, t_min): closest-hit to infinity, any-hit to `dist`."""
    from aten_tpu_torch.accel.traverse import _t0_of

    return (("closest", _t0_of(None, N_RAYS, dist.device), False, 1e-4),
            ("any", dist, True, 1e-3))


def main(argv):
    group = argv[2] if len(argv) == 3 else "k1k3"
    if (len(argv) not in (2, 3) or group not in GROUPS
            or not os.path.isdir(os.path.join(argv[1], "aten_tpu_torch", "kernels"))):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("first_design_ab: no CUDA card is available")
    sys.path.insert(0, native.REPO_ROOT)
    import numpy as np

    # the ray makers and the timer of chip_smoke.py, at the checkout's root
    import chip_smoke as smoke
    from aten_tpu_torch.ops import traverse_cuda

    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t = time.time()
    traverse_cuda.load_library()
    if group == "l1":
        from aten_tpu_torch.tools import lab_library

        lab_library.load_library()
    lib = load_first_design(argv[1], group)
    print(f"built both designs in {time.time() - t:.1f} s", flush=True)
    run = {"k1k3": _ab_k1k3, "k5k4": _ab_k5k4, "l1": _ab_l1}[group]
    results = run(lib, smoke, card, np.random.default_rng(SEED), dev)
    print(json.dumps({"card": card, "rays": N_RAYS, "group": group, "ab": results}), flush=True)


if __name__ == "__main__":
    main(sys.argv)
