#!/usr/bin/env python3
"""On-card check of the aten_tpu_torch port (NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
builds the traversal kernel from the checkout's sources, holds it against
its plain torch version on two mesh scenes, renders the Cornell box
against the pinned golden image, renders the 102,404-prim mesh scene
through the kernel at 512x512, 16 spp, and prints the measured times.
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


def compare_traversal(name, scene, ro, rd, rng):
    """Kernel vs plain walk on the same rays; raises outside the bounds.
    Returns the max abs error of (t, u, v) where prims agree and whether
    the any-hit verdicts were equal."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse

    hk = traverse(scene, ro, rd, impl="cuda")
    hp = traverse(scene, ro, rd, impl="plain")
    pk, pp = hk["prim"].cpu().numpy(), hp["prim"].cpu().numpy()
    agree = float((pk == pp).mean())
    m = (pp >= 0) & (pk == pp)
    errs = {k: float(np.abs(hk[k].cpu().numpy()[m] - hp[k].cpu().numpy()[m]).max(initial=0.0))
            for k in ("t", "u", "v")}
    exact = bool(all(torch.equal(hk[k], hp[k]) for k in ("t", "prim", "u", "v")))
    log(f"{name}: {ro.shape[0]} rays, hit {float((pp >= 0).mean()):.4f}, "
        f"prim agreement {agree:.6f}, bitwise equal {exact}, "
        f"max |dt| {errs['t']:.3e} |du| {errs['u']:.3e} |dv| {errs['v']:.3e}")
    assert agree >= PRIM_AGREE, (name, agree)
    tk, tp = hk["t"].cpu().numpy()[m], hp["t"].cpu().numpy()[m]
    np.testing.assert_allclose(tk, tp, rtol=T_TOL, atol=T_TOL)
    assert errs["u"] <= UV_TOL and errs["v"] <= UV_TOL, (name, errs)

    t_max = torch.tensor(rng.uniform(0.0, 20.0, ro.shape[0]), dtype=torch.float32,
                         device=ro.device)
    ak = traverse(scene, ro, rd, t_max=t_max, any_hit=True, t_min=1e-3, impl="cuda")
    ap = traverse(scene, ro, rd, t_max=t_max, any_hit=True, t_min=1e-3, impl="plain")
    same = bool(torch.equal(ak["hit"], ap["hit"]))
    log(f"{name} any-hit: occluded {float(ap['hit'].float().mean()):.4f}, verdicts equal {same}")
    assert same, name
    return max(errs.values()), same


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
    from aten_tpu_torch.ops import traverse_cuda
    from aten_tpu_torch.scene.scenedefs import cornell_box, procedural_mesh_scene

    # -- phase 0: the card
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- phase 1: build the kernel from the checkout's sources
    t = time.time()
    traverse_cuda.load_library(verbose=True)
    log(f"phase 1: built {KERNEL_SOURCE} in {time.time() - t:.1f} s")

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
        e, same = compare_traversal(name, scene, torch.cat([cro, sro]),
                                    torch.cat([crd, srd]), rng)
        max_err["closest"] = max(max_err["closest"], e)
        max_err["any"] = max(max_err["any"], 0.0 if same else 1.0)
    # the main path's shape: 512x512 pixels x 16 samples = 4,194,304 rays
    n_main = 512 * 512 * 16
    cro, crd = camera_rays(cam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = surface_rays(big, n_main - cro.shape[0], rng, dev)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    e, same = compare_traversal("mesh102k main-path shape", big, ro, rd, rng)
    max_err["closest"] = max(max_err["closest"], e)
    max_err["any"] = max(max_err["any"], 0.0 if same else 1.0)
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    times = {}
    for kind, kw in (("closest", {}), ("any", {"t_max": dist, "any_hit": True, "t_min": 1e-3})):
        times[kind] = (
            cuda_ms(lambda: traverse(big, ro, rd, impl="cuda", **kw), reps=10),
            cuda_ms(lambda: traverse(big, ro, rd, impl="plain", **kw), reps=1),
        )
        log(f"phase 2 timing {kind}-hit, {n_main} rays, 102,404 prims: kernel "
            f"{times[kind][0]:.3f} ms, plain torch walk {times[kind][1]:.3f} ms "
            f"[{card}]")

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

    # -- phase 4: the slice, 512x512 x 16 spp, depth 5, RR depth 3, via the kernel
    render_image(big, cam, spp=16, max_depth=5, rr_depth=3)  # warm-up
    torch.cuda.synchronize()
    traverse_cuda.reset_launch_counts()
    t = time.time()
    img = render_image(big, cam, spp=16, max_depth=5, rr_depth=3)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(traverse_cuda.launch_counts)
    img = img.cpu().numpy()
    log(f"phase 4 main path launches: {launches}")
    assert all(launches[k] > 0 for k in traverse_cuda.KERNELS), launches
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    mpaths = 512 * 512 * 16 / wall / 1e6
    log(f"phase 4 render 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f} "
        f"wall {wall * 1e3:.1f} ms, {mpaths:.3f} Mpaths/s [{card}]")
    small = dataclasses.replace(cam, width=128, height=128)
    ik = render_image(big, small, spp=2, max_depth=3, impl="auto").cpu().numpy()
    ip = render_image(big, small, spp=2, max_depth=3, impl="plain").cpu().numpy()
    check_image_bounds("phase 4 128x128 2spp kernel vs plain", ik, ip)

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches[name],
         "max_abs_err": max_err[kind], "ms": times[kind][0],
         "plain_ms": times[kind][1]}
        for name, kind in zip(traverse_cuda.KERNELS, ("closest", "any"))
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
