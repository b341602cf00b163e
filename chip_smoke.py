#!/usr/bin/env python3
"""On-card check of the aten_tpu_torch port (NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
builds the traversal kernels from the checkout's sources, holds the
threaded-BVH kernel against its plain torch version on two mesh scenes,
renders the Cornell box against the pinned golden image, renders the
102,404-prim mesh scene through that kernel at 512x512, 16 spp, then
holds the two-level (instanced) kernel against its plain version on the
19-instance fixture and renders that fixture through it at 512x512,
16 spp, with a profile of the render.  It prints the measured times and
each kernel's bound (the least time the card could take for the work).
Every phase raises on failure, so any failure exits non-zero.  The last
two lines are one JSON object describing the kernels, then
{"ok": true, "device": {...}}.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
KERNEL_SOURCE = "aten_tpu_torch/kernels/bvh_traverse.cu"
REPLACES = "aten_tpu/ops/traverse_pallas.py:785"
TLAS_SOURCE = "aten_tpu_torch/kernels/tlas_traverse.cu"
TLAS_REPLACES = "aten_tpu/ops/traverse_pallas.py:1750"
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32 FLOP/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# fp32 operations of one step of the kernels' arithmetic (adds, products,
# divisions, square roots, min/max and compares, counted from the
# sources): a slab test, a Moller-Trumbore test (the sphere test is
# cheaper and counted the same), an instance entry (the 3x4 transform of
# origin and direction, three safe inverses, and the three of the pop
# back to the world ray), and per ray the three safe inverses.
OPS_NODE = 25
OPS_PRIM = 53
OPS_ENTER = 45
OPS_RAY = 6
# _check_parity bounds (tests/test_pallas_tpu.py:29-42) and the
# full-image radiance bounds (tests/test_pallas_tpu.py:157-166)
PRIM_AGREE = 0.999
T_TOL = 1e-4
UV_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def image_bounds(img, ref):
    """(fraction of pixels with rel > 2e-2, mean rel) as in the reference's
    full-image radiance parity gate."""
    import numpy as np

    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    return float((rel > 2e-2).mean()), float(rel.mean())


def check_image_bounds(name, img, ref):
    frac, mean_rel = image_bounds(img, ref)
    log(f"{name}: frac(rel>2e-2)={frac:.3e} (<5e-3) mean_rel={mean_rel:.3e} (<3e-3)")
    assert frac < 5e-3 and mean_rel < 3e-3, name


def surface_rays(scene, n, rng, device):
    """n rays from uniform points on random triangles in uniform random
    directions (numpy seeded)."""
    import numpy as np
    import torch

    T = scene["num_tris"]
    tid = rng.integers(0, T, n)
    b = rng.random((n, 2))
    flip = b.sum(1) > 1.0
    b[flip] = 1.0 - b[flip]
    v0, e1, e2 = (scene[k].cpu().numpy()[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
    ro = (v0 + b[:, :1] * e1 + b[:, 1:] * e2).astype(np.float32)
    d = rng.standard_normal((n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


def camera_rays(cam, device, jitter_rng=None, subsamples=1):
    """Camera rays through pixel centres, or through `subsamples`
    jittered points per pixel."""
    import numpy as np
    import torch

    from aten_tpu_torch.core.camera import generate_ray

    w, h = cam.width, cam.height
    pix = np.tile(np.arange(w * h), subsamples)
    off = (np.full((pix.size, 2), 0.5) if jitter_rng is None
           else jitter_rng.random((pix.size, 2)))
    s = ((pix % w) + off[:, 0]) / w
    t = ((pix // w) + off[:, 1]) / h
    ro, rd = generate_ray(cam.arrays(device),
                          torch.tensor(s, dtype=torch.float32, device=device),
                          torch.tensor(t, dtype=torch.float32, device=device))
    return ro, rd


def plain_walk(scene, ro, rd, t_max=None, any_hit=False, t_min=1e-4):
    """The kernel's plain version with the work these rays need: (hits,
    {"node_steps", "prim_tests"[, "inst_entries"]})."""
    from aten_tpu_torch.accel.tlas import _traverse_two_level_plain
    from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plain

    t0 = _t0_of(t_max, ro.shape[0], ro.device)
    walk = _traverse_two_level_plain if "tl_bmin" in scene else _traverse_plain
    return walk(scene, ro, rd, t0, any_hit, t_min, stats=True)


def compare_traversal(name, scene, ro, rd, t_max):
    """Kernel vs plain walk on the same rays, closest-hit and then any-hit
    with distances t_max; raises outside the bounds.  Returns the max abs
    error of (t, u, v) where prims agree, whether the any-hit verdicts
    were equal, and the plain walks' work counts per kind."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse

    hk = traverse(scene, ro, rd, impl="cuda")
    hp, st_closest = plain_walk(scene, ro, rd)
    keys = ("t", "prim", "u", "v") + (("inst",) if "inst" in hp else ())
    pk, pp = hk["prim"].cpu().numpy(), hp["prim"].cpu().numpy()
    agree = float((pk == pp).mean())
    m = (pp >= 0) & (pk == pp)
    errs = {k: float(np.abs(hk[k].cpu().numpy()[m] - hp[k].cpu().numpy()[m]).max(initial=0.0))
            for k in ("t", "u", "v")}
    exact = bool(all(torch.equal(hk[k], hp[k]) for k in keys))
    log(f"{name}: {ro.shape[0]} rays, hit {float((pp >= 0).mean()):.4f}, "
        f"prim agreement {agree:.6f}, bitwise equal {exact}, "
        f"max |dt| {errs['t']:.3e} |du| {errs['u']:.3e} |dv| {errs['v']:.3e}")
    assert agree >= PRIM_AGREE, (name, agree)
    tk, tp = hk["t"].cpu().numpy()[m], hp["t"].cpu().numpy()[m]
    np.testing.assert_allclose(tk, tp, rtol=T_TOL, atol=T_TOL)
    assert errs["u"] <= UV_TOL and errs["v"] <= UV_TOL, (name, errs)
    if "inst" in hp:
        assert torch.equal(hk["hit"], hp["hit"]), name
        ik, ip = hk["inst"].cpu().numpy(), hp["inst"].cpu().numpy()
        assert (ik[m] == ip[m]).all(), name
        log(f"{name}: instances equal where prims agree; hits per instance "
            f"{np.bincount(ip[ip >= 0]).tolist()}")

    ak = traverse(scene, ro, rd, t_max=t_max, any_hit=True, t_min=1e-3, impl="cuda")
    ap, st_any = plain_walk(scene, ro, rd, t_max=t_max, any_hit=True, t_min=1e-3)
    same = bool(torch.equal(ak["hit"], ap["hit"]))
    exact_any = bool(all(torch.equal(ak[k], ap[k]) for k in keys))
    log(f"{name} any-hit: occluded {float(ap['hit'].float().mean()):.4f}, "
        f"verdicts equal {same}, bitwise equal {exact_any}")
    log(f"{name} work: closest {st_closest}, any {st_any}")
    assert same, name
    return max(errs.values()), same, {"closest": st_closest, "any": st_any}


def first_hit_rays(scene, ro, rd, n, rng):
    """n rays leaving first-hit points of the rays (ro, rd), picked at
    random, in uniform random directions (numpy seeded)."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse

    h = traverse(scene, ro, rd, impl="cuda")
    idx = torch.nonzero(h["hit"]).squeeze(1).cpu().numpy()
    pick = torch.from_numpy(rng.choice(idx, n)).to(ro.device)
    p = ro[pick] + h["t"][pick, None] * rd[pick]
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return p.contiguous(), torch.from_numpy(d).to(ro.device)


def bound(n_rays, out_bytes, pool_bytes, work):
    """Least time (ms) the card could take for a traversal launch, and
    what bounds it: the larger of the bytes it must move (each ray's
    28 B in and `out_bytes` out once, the pool once) over HBM bandwidth
    and the fp32 operations these rays need over the fp32 peak."""
    nbytes = n_rays * (28 + out_bytes) + pool_bytes
    ops = (n_rays * OPS_RAY + work["node_steps"] * OPS_NODE
           + work["prim_tests"] * OPS_PRIM + work.get("inst_entries", 0) * OPS_ENTER)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def pool_bytes(scene, fields):
    return sum(scene[k].numel() * scene[k].element_size() for k, _, _ in fields)


def reset_counts():
    from aten_tpu_torch.ops import tlas_cuda, traverse_cuda

    traverse_cuda.reset_launch_counts()
    tlas_cuda.reset_launch_counts()


def read_counts():
    from aten_tpu_torch.ops import tlas_cuda, traverse_cuda

    return {**traverse_cuda.launch_counts, **tlas_cuda.launch_counts}


def profile_render(fn):
    """One profiled call of fn(): (wall ms, device busy ms, traversal
    kernels' ms), busy being the summed time of the events on the card
    (kernels, copies, fills; one stream, so they do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    busy = trav = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host ops: their device time repeats their kernels'
        us = e.self_device_time_total
        busy += us
        if "traverse_kernel" in e.key:
            trav += us
    return wall, busy / 1e3, trav / 1e3


def log_profile(phase, card, prof):
    wall, busy, trav = prof
    log(f"{phase} profiled render: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1.0 - busy / wall:.3f}), traversal kernels {trav:.2f} ms "
        f"({trav / busy if busy else 0.0:.4f} of busy) [{card}]")


def main():
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "aten_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(aten_tpu_torch/ not found beside this script)")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    import numpy as np

    from aten_tpu_torch.accel.traverse import traverse
    from aten_tpu_torch.integrator.pathtracer import render_image
    from aten_tpu_torch.ops import tlas_cuda, traverse_cuda
    from aten_tpu_torch.scene.scenedefs import (
        cornell_box, instanced_mesh_scene, procedural_mesh_scene)

    # -- phase 0: the card
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- phase 1: build both kernels (one library) from the checkout's sources
    t = time.time()
    traverse_cuda.load_library(verbose=True)
    log(f"phase 1: built {KERNEL_SOURCE} and {TLAS_SOURCE} in {time.time() - t:.1f} s")

    # -- phase 2: kernel vs plain walk on the card
    rng = np.random.default_rng(SEED)
    t = time.time()
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    mid, _ = procedural_mesh_scene(512, 512, n_u=40, n_v=25, device=dev)
    log(f"scenes built in {time.time() - t:.1f} s: "
        f"{big['num_tris'] + big['num_spheres']} and "
        f"{mid['num_tris'] + mid['num_spheres']} prims")
    assert big["num_tris"] + big["num_spheres"] == 102404
    max_err = {"closest": 0.0, "any": 0.0}
    for name, scene in (("mesh102k", big), ("mesh2k", mid)):
        cro, crd = camera_rays(cam, dev)
        sro, srd = surface_rays(scene, cro.shape[0], rng, dev)
        dist = torch.tensor(rng.uniform(0.0, 20.0, 2 * cro.shape[0]),
                            dtype=torch.float32, device=dev)
        e, same, _ = compare_traversal(name, scene, torch.cat([cro, sro]),
                                       torch.cat([crd, srd]), dist)
        max_err["closest"] = max(max_err["closest"], e)
        max_err["any"] = max(max_err["any"], 0.0 if same else 1.0)
    # the main path's shape: 512x512 pixels x 16 samples = 4,194,304 rays
    n_main = 512 * 512 * 16
    cro, crd = camera_rays(cam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = surface_rays(big, n_main - cro.shape[0], rng, dev)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    e, same, work = compare_traversal("mesh102k main-path shape", big, ro, rd, dist)
    max_err["closest"] = max(max_err["closest"], e)
    max_err["any"] = max(max_err["any"], 0.0 if same else 1.0)
    times, bounds = {}, {}
    pool = pool_bytes(big, traverse_cuda._SCENE_FIELDS)
    for kind, kw in (("closest", {}), ("any", {"t_max": dist, "any_hit": True, "t_min": 1e-3})):
        times[kind] = (
            cuda_ms(lambda: traverse(big, ro, rd, impl="cuda", **kw), reps=10),
            cuda_ms(lambda: traverse(big, ro, rd, impl="plain", **kw), reps=1),
        )
        bounds[kind] = bound(n_main, 16, pool, work[kind])
        log(f"phase 2 timing {kind}-hit, {n_main} rays, 102,404 prims: kernel "
            f"{times[kind][0]:.3f} ms, plain torch walk {times[kind][1]:.3f} ms, "
            f"bound {bounds[kind][0]:.4f} ms by {bounds[kind][1]} "
            f"({bounds[kind][2]} B, {bounds[kind][3]} fp32 ops) [{card}]")

    # -- phase 3: Cornell box (dense path, no kernel) against the golden
    scene, ccam = cornell_box(64, 64, device=dev)
    img = render_image(scene, ccam, spp=16, max_depth=5).cpu().numpy()
    with np.load(os.path.join(ROOT, "tests", "golden", "cornell.npz")) as z:
        gold = z["img"]
    err = np.abs(img - gold)
    log(f"phase 3 cornell 64x64 16spp vs golden: max abs {err.max():.3e} "
        f"mean abs {err.mean():.3e} (golden-test bounds 5e-3 / 5e-4)")
    assert np.isfinite(img).all()
    check_image_bounds("phase 3 cornell", img, gold)

    # -- phase 4: the mesh path, 512x512 x 16 spp, depth 5, RR depth 3
    render_image(big, cam, spp=16, max_depth=5, rr_depth=3)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    img = render_image(big, cam, spp=16, max_depth=5, rr_depth=3)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()
    img = img.cpu().numpy()
    log(f"phase 4 main path launches: {launches}")
    assert all(launches[k] > 0 for k in traverse_cuda.KERNELS), launches
    assert all(launches[k] == 0 for k in tlas_cuda.KERNELS), launches
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    mpaths = 512 * 512 * 16 / wall / 1e6
    log(f"phase 4 render 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f} "
        f"wall {wall * 1e3:.1f} ms, {mpaths:.3f} Mpaths/s [{card}]")
    log_profile("phase 4", card, profile_render(
        lambda: render_image(big, cam, spp=16, max_depth=5, rr_depth=3)))
    small = dataclasses.replace(cam, width=128, height=128)
    ik = render_image(big, small, spp=2, max_depth=3, impl="auto").cpu().numpy()
    ip = render_image(big, small, spp=2, max_depth=3, impl="plain").cpu().numpy()
    check_image_bounds("phase 4 128x128 2spp kernel vs plain", ik, ip)
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches[name],
         "max_abs_err": max_err[kind], "ms": times[kind][0],
         "plain_ms": times[kind][1], "bound_ms": bounds[kind][0],
         "bound_by": bounds[kind][1], "library_ms": None}
        for name, kind in zip(traverse_cuda.KERNELS, ("closest", "any"))
    ]
    del big, mid, ro, rd, cro, crd, sro, srd, dist

    # -- phase 5: the two-level kernel vs its plain walk on the card
    t = time.time()
    inst, icam = instanced_mesh_scene(512, 512, device=dev)
    n_prims = inst["num_tris"] + inst["num_spheres"]
    log(f"phase 5: instanced fixture built in {time.time() - t:.1f} s: "
        f"{inst['num_instances']} instances, {n_prims} prims, "
        f"{inst['tl_bmin'].shape[0]} pool nodes")
    assert inst["num_instances"] == 19 and n_prims == 102405
    cro, crd = camera_rays(icam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = first_hit_rays(inst, cro, crd, n_main - cro.shape[0], rng)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    e, same, work = compare_traversal("instanced main-path shape", inst, ro, rd, dist)
    max_err5 = {"closest": e, "any": 0.0 if same else 1.0}
    times5, bounds5 = {}, {}
    pool = pool_bytes(inst, tlas_cuda._SCENE_FIELDS)
    for kind, kw in (("closest", {}), ("any", {"t_max": dist, "any_hit": True, "t_min": 1e-3})):
        times5[kind] = (
            cuda_ms(lambda: traverse(inst, ro, rd, impl="cuda", **kw), reps=10),
            cuda_ms(lambda: traverse(inst, ro, rd, impl="plain", **kw), reps=1),
        )
        bounds5[kind] = bound(n_main, 20, pool, work[kind])
        log(f"phase 5 timing {kind}-hit, {n_main} rays, 19 instances over "
            f"102,405 prims: kernel {times5[kind][0]:.3f} ms, plain torch walk "
            f"{times5[kind][1]:.3f} ms, bound {bounds5[kind][0]:.4f} ms by "
            f"{bounds5[kind][1]} ({bounds5[kind][2]} B, {bounds5[kind][3]} fp32 ops) "
            f"[{card}]")
    del ro, rd, cro, crd, sro, srd, dist

    # -- phase 6: the instanced path, 512x512 x 16 spp, depth 5, RR depth 3
    render_image(inst, icam, spp=16, max_depth=5, rr_depth=3)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    img = render_image(inst, icam, spp=16, max_depth=5, rr_depth=3)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches6 = read_counts()
    img = img.cpu().numpy()
    log(f"phase 6 main path launches: {launches6}")
    assert all(launches6[k] > 0 for k in tlas_cuda.KERNELS), launches6
    assert all(launches6[k] == 0 for k in traverse_cuda.KERNELS), launches6
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    mpaths = 512 * 512 * 16 / wall / 1e6
    log(f"phase 6 render 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f} "
        f"wall {wall * 1e3:.1f} ms, {mpaths:.3f} Mpaths/s [{card}]")
    log_profile("phase 6", card, profile_render(
        lambda: render_image(inst, icam, spp=16, max_depth=5, rr_depth=3)))
    small = dataclasses.replace(icam, width=128, height=128)
    ik = render_image(inst, small, spp=2, max_depth=3, impl="auto").cpu().numpy()
    ip = render_image(inst, small, spp=2, max_depth=3, impl="plain").cpu().numpy()
    check_image_bounds("phase 6 128x128 2spp kernel vs plain", ik, ip)
    kernels += [
        {"name": name, "route": "cuda", "source": TLAS_SOURCE,
         "replaces": TLAS_REPLACES, "launches": launches6[name],
         "max_abs_err": max_err5[kind], "ms": times5[kind][0],
         "plain_ms": times5[kind][1], "bound_ms": bounds5[kind][0],
         "bound_by": bounds5[kind][1], "library_ms": None}
        for name, kind in zip(tlas_cuda.KERNELS, ("closest", "any"))
    ]

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
