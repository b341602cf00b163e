#!/usr/bin/env python3
"""On-card check of the aten_tpu_torch port (NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
builds the traversal kernels from the checkout's sources, holds the
threaded-BVH kernel K1 against its plain torch version on two mesh
scenes and times it at the main path's ray count on both (bound over the
BVH's own arrays, with the bound over its packed records beside it),
renders the Cornell box against the pinned golden image, renders the
102,404-prim and the 2,004-prim mesh scenes through that kernel at
512x512, 16 spp, then holds the two-level (instanced) kernel against its
plain version on the 19-instance fixture and renders that fixture
through it (bitwise: t, prim, inst, u and v), and finally holds the
Plücker treelet kernel K3 against its plain version and the oracle walk
on the 512,004-prim mesh scene, times it, and renders that scene
through it. Phase 9 holds the multi-chain treelet kernel K4 at 1, 2, 4
and 8 rays per lane bitwise against its plain
version and the oracle walk on the rays of both mesh scenes, times it
beside the kernels those scenes run by default, renders the 102,404-prim
scene through it, and renders the 512,004-prim scene in a child process
started with ATEN_TPU_KERNEL=smt; phase 10 runs the latency labs
(pointer chase, launch overhead) against their plain versions; phase 11
runs the treelet-walk lab L1 (python -m aten_tpu_torch.tools.kernel_lab)
on 1,048,576 primary rays of the 102,404-prim scene, each variant
bitwise against its plain version, timed beside K1 and held, where it
computes a closest hit, against the oracle walk.  Phase 12 runs the
material zoo, which needs no kernel (13-15 prims take the dense test):
the zoo against tests/golden/mtrl_zoo.npz, the reference bench's
zoo+IBL config (512x512, 32 spp, depth 5, under the procedural sky)
timed with its peak memory, and the zoo+IBL and texture fixtures on the
card against the port on this machine's CPU.  Phase 13 runs the toon
families and the train step of aten_tpu_torch/parallel/mesh.py: the toon
fixture, plain and stylized, on the card against the CPU and timed at
512x512 x 16 spp; the reference bench's cornell_fwd_bwd config (256x256,
spp 4, depth 3) timed per step with its peak memory and a profiled step;
the gradients of texels, light radiance and light position on the card
against the CPU and 20 descent steps; the step on the 102,404-prim mesh
scene, which walks K1 (3 + 3 launches), bitwise equal to the same loss
and gradients through the plain walk; and render_tiled and a step
through a one-rank NCCL group, bitwise equal to no group.  Phase 14
runs voxel LOD (aten_tpu_torch/accel/voxel.py): the lod variants of the
threaded-BVH, Plücker and multi-chain kernels (the last at every ray
count per lane) bitwise against their plain versions and against the
LOD oracle walk on 4,194,304 camera and bounce rays each, timed in turns
beside their non-LOD instantiations, and the three LOD scenes (the
102,404-prim mesh at lod_depth 9 and 15, the 512,004-prim mesh at 18)
rendered at 512x512 x 16 spp through them, each against the oracle
walk's render at 256x256, depth 1.  Phase 15 holds the kStats instantiations of K1 and K3
(per-ray work counts) bitwise against their plain instantiations' hits
and their plain versions' counts on 4,194,304 camera and bounce rays,
timed in turns with them, runs the traversal-stats tool
(python -m aten_tpu_torch.tools.trav_stats) on its scenes, and renders
the alpha and stencil fixtures, the mesh scene through thin-lens and
equirect cameras, and with the blue-noise sampler, through K1, each
against the plain walk (the blue-noise render against the CPU).  Phase
16 runs K3 and K4 at drain windows 16, 32, 64 and 128 (ATEN_TRL_WINDOW's
layouts, `with_plk_layout(window=)`, `with_trl_layout(window=)`), each
bitwise its plain version and against the oracle walk (their lod
variants in phase 14), timed in turns against window 64, and the
512,004-prim mesh rendered through K3 at the fastest other window
against the window-64 render; the lab's wide8_t32 on a window-32 layout; and the first-hit
AOV G-buffer (render_sample_with_aovs) at 512x512 x 1 spp through K1,
its radiance bitwise render_sample's, its AOVs bitwise the plain
walk's at 128x128.  Phase 17 runs the real-time path: SVGF with TAA and
gt_tonemap on render_sample_with_aovs at bench.py's sponza_svgf shape
(512x512 x 1 spp, depth 5, RR 3) on the 102,404-prim mesh through K1,
8 frames of an orbiting camera and 3 static ones, each frame's render
and denoiser timed apart, the history's acceptance gated, a frame on the
card against the port on this machine's CPU, the denoised frame against
a 64 spp render; object motion through K5 on the instanced fixture
rebuilt each frame with one knot moving; AO through K1's any-hit walk
against the oracle walk; ReSTIR direct and GI at bench.py's
restir_126lights shape (the dense test) and against the ReSTIR goldens;
and ReSTIR GI on the mesh through K1 against the oracle walk.  Phase
18 runs participating media and NPR: bench.py's hetero_volume_ms call
(render_volpt_sample, 256x256, a sample of 4, depth 8) on the smoke
ball and the same on the homogeneous fog box, each timed by CUDA events
with its host syncs and profiled, and at 32x32 against the port on this
machine's CPU (the smoke ball also against tests/golden/volume.npz),
within statistical bounds; the 102,404-prim knot in a homogeneous fog
box and in a smoke_plume grid through K1 at 256x256 x 2 spp, each
bitwise the render through K1's plain version at 64x64; render_npr and
the sample-ray feature lines on the knot at 512x512 through K1, and at
64x64 against the oracle walk.  Phase 19 runs scene files and
skinned animation: the 102,404-prim knot skinned to a chain of 8 joints,
8 frames of its clip, each the pose step (palette, skinning, the LBVH and
K1's preorder records built on the card, with 0 host syncs) and a
512x512 x 1 spp render through K1; one frame's LBVH bitwise the port's
build on this machine's CPU, K1 on its 4,194,304 camera and bounce rays
bitwise the oracle walk over the LBVH's arrays, its 64x64 render bitwise
the plain walk's, the frame at 512x512 x 16 spp, and K1 on the bind
pose's LBVH against its SAH tree; the knot scene as OBJ + MTL, a sky as
.hdr and 4 knot instances as .glb, each loaded and built on the card and
on this machine's CPU, the OBJ scene rendered through K1 and the .glb
through K5 (bitwise its plain version at 64x64); and the 512,004-prim
scene built with and without a BVH cache.  Phase 20 runs the last
modules: aten_tpu_torch.cli.render on the knot written as OBJ at
512x512 x 16 spp with --stats and a checkpoint, then resumed, the
resumed film bitwise the same 32 render_sample calls (K1 5 + 0 a
sample), and at 64x64 against the same call on this machine's CPU;
cli.bvh_builder --spatial-splits on the knot and on 65,536 slivers,
each SBVH put on its scene with Scene.replace and walked by K1 on
4,194,304 camera rays against the SAH tree (and bitwise K1's plain
version), timed in turns with it; visible_prims on the knot, the card's
masks the CPU's and a superset of K1's hit prims; compact and
scatter_back on 4,194,304 lanes bitwise the CPU's; the zoo+IBL render
at 512x512 x 8 spp with the partitioned dispatch off, and on in a child
process under ATEN_TPU_PARTITION=1; and entry()'s step on the card
against the CPU.  Each
main-path render and step is profiled, with its ten costliest device
ops and each traversal kernel's summed device time. It prints the
measured times and each kernel's bound (the least time the card could
take for the work).

Every phase raises on failure, so any failure exits non-zero.  The last
two lines are one JSON object describing the kernels, then
{"ok": true, "device": {...}}.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
KERNEL_SOURCE = "aten_tpu_torch/kernels/bvh_traverse.cu"
REPLACES = "aten_tpu/ops/traverse_pallas.py:785"
TLAS_SOURCE = "aten_tpu_torch/kernels/tlas_traverse.cu"
TLAS_REPLACES = "aten_tpu/ops/traverse_pallas.py:1750"
PLK_SOURCE = "aten_tpu_torch/kernels/plk_traverse.cu"
PLK_REPLACES = "aten_tpu/ops/traverse_pallas.py:1058"
SMT_SOURCE = "aten_tpu_torch/kernels/smt_traverse.cu"
SMT_REPLACES = "aten_tpu/ops/traverse_pallas.py:1335"
CHASE_SOURCE = "aten_tpu_torch/kernels/chase_lab.cu"
CHASE_REPLACES = "tools/chase_lab.py:41"
LAUNCH_SOURCE = "aten_tpu_torch/kernels/launch_lab.cu"
LAUNCH_REPLACES = "tools/launch_lab.py:18"
LAB_SOURCE = "aten_tpu_torch/kernels/kernel_lab.cu"
LAB_REPLACES = {"nodes": "tools/kernel_lab.py:36", "nodir": "tools/kernel_lab.py:36",
                "leafu": "tools/kernel_lab.py:96", "wide": "tools/kernel_lab.py:343",
                "spec": "tools/kernel_lab.py:468", "plk": "tools/kernel_lab.py:661"}
# the L1 variants phase 11 runs (tools/kernel_lab.py's names)
LAB_VARIANTS = ("nodes", "nodir", "leafu", "wide8", "wide16", "wide8_nc", "wide16_nc",
                "spec8", "spec16", "plk")
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
# A voxel test of the LOD variants past its slab test (counted in
# OPS_NODE): the id from the word, four compares (entry t against t_min,
# below and equal to t, the id against the winner's) and a select.
OPS_VOXEL = 6
# The Plücker kernel (plk_traverse.cu), floating-point and integer
# operations alike: per slot the two edge sides (11 each), den (5), the
# numerator (6), s2 (2), the sign test (6), the reciprocal and t (2),
# the two compares (2) and the winner code (3); per fat leaf entered the
# merge; per ray the three safe inverses and ro x rd.
OPS_SLOT = 48
OPS_LEAF = 6
OPS_RAY_PLK = 15
# The labs (kernels/chase_lab.cu, launch_lab.cu): integer and float
# operations per thread and step (a load's address, a compare, a vote,
# an add; the LCG's multiply, add and mask), 1024 threads per block.
OPS_LAB_STEP = 4
LAB_THREADS = 1024
# _check_parity bounds (tests/test_pallas_tpu.py:29-42) and the
# full-image radiance bounds (tests/test_pallas_tpu.py:157-166)
PRIM_AGREE = 0.999
T_TOL = 1e-4
UV_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def phase_clock(phase, since):
    """Log phase `phase`'s seconds since `since`; the next phase's start."""
    now = time.time()
    log(f"phase {phase} took {now - since:.1f} s")
    return now


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


def compare_traversal(name, scene, ro, rd, t_max, exact=False):
    """Kernel vs plain walk on the same rays, closest-hit and then any-hit
    with distances t_max; raises outside the bounds, and with `exact`
    unless every output of both kinds is bitwise equal.  Returns the max
    abs error of (t, u, v) where prims agree, whether the any-hit verdicts
    were equal, and per kind the plain walks' work counts, device ms (one
    run each: the plain walk is host-bound, no yardstick) and hits."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse

    hk = traverse(scene, ro, rd, impl="cuda")
    (hp, st_closest), ms_closest = timed_ms(lambda: plain_walk(scene, ro, rd))
    keys = ("t", "prim", "u", "v") + (("inst",) if "inst" in hp else ())
    pk, pp = hk["prim"].cpu().numpy(), hp["prim"].cpu().numpy()
    agree = float((pk == pp).mean())
    m = (pp >= 0) & (pk == pp)
    errs = {k: float(np.abs(hk[k].cpu().numpy()[m] - hp[k].cpu().numpy()[m]).max(initial=0.0))
            for k in ("t", "u", "v")}
    exact_closest = bool(all(torch.equal(hk[k], hp[k]) for k in keys))
    log(f"{name}: {ro.shape[0]} rays, hit {float((pp >= 0).mean()):.4f}, "
        f"prim agreement {agree:.6f}, bitwise equal {exact_closest}, "
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
    (ap, st_any), ms_any = timed_ms(
        lambda: plain_walk(scene, ro, rd, t_max=t_max, any_hit=True, t_min=1e-3))
    same = bool(torch.equal(ak["hit"], ap["hit"]))
    exact_any = bool(all(torch.equal(ak[k], ap[k]) for k in keys))
    log(f"{name} any-hit: occluded {float(ap['hit'].float().mean()):.4f}, "
        f"verdicts equal {same}, bitwise equal {exact_any}")
    log(f"{name} work: closest {st_closest}, any {st_any}")
    assert same, name
    assert not exact or (exact_closest and exact_any), (name, exact_closest, exact_any)
    return (max(errs.values()), same, {"closest": st_closest, "any": st_any},
            {"closest": ms_closest, "any": ms_any}, {"closest": hp, "any": ap})


def first_hit_rays(scene, ro, rd, n, rng, impl="cuda"):
    """n rays leaving first-hit points of the rays (ro, rd), picked at
    random, in uniform random directions (numpy seeded)."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse

    h = traverse(scene, ro, rd, impl=impl)
    idx = torch.nonzero(h["hit"]).squeeze(1).cpu().numpy()
    pick = torch.from_numpy(rng.choice(idx, n)).to(ro.device)
    p = ro[pick] + h["t"][pick, None] * rd[pick]
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return p.contiguous(), torch.from_numpy(d).to(ro.device)


def bound(n_rays, out_bytes, pool_bytes, work, ops_ray=OPS_RAY):
    """Least time (ms) the card could take for a traversal launch, and
    what bounds it: the larger of the bytes it must move (each ray's
    28 B in and `out_bytes` out once, the pool once) over HBM bandwidth
    and the fp32 operations these rays need (the plain walk's work
    counts, OPS_* each) over the fp32 peak."""
    nbytes = n_rays * (28 + out_bytes) + pool_bytes
    ops = (n_rays * ops_ray + work["node_steps"] * OPS_NODE
           + work.get("prim_tests", 0) * OPS_PRIM + work.get("inst_entries", 0) * OPS_ENTER
           + work.get("slot_tests", 0) * OPS_SLOT + work.get("leaves", 0) * OPS_LEAF
           + work.get("voxel_tests", 0) * OPS_VOXEL)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def array_bytes(scene, names):
    return sum(scene[k].numel() * scene[k].element_size() for k in names)


def pool_bytes(scene, fields):
    """Bytes of the scene arrays a wrapper's (name, dtype, shape) fields name."""
    return array_bytes(scene, [k for k, _, _ in fields])


# The threaded BVH's own arrays, which the plain walks read: the pool of
# every traversal bound taken over the query's least work (the oracle
# walk's node steps and prim tests).
BVH_ARRAYS = ("nodes_bmin", "nodes_bmax", "nodes_hit", "nodes_miss", "nodes_prim_start",
              "nodes_prim_count", "prim_order", "tri_v0", "tri_e1", "tri_e2", "sph_center",
              "sph_radius")


# Launches and host syncs are host counters of the port's registry
# (aten_tpu_torch/utils/spans.py), which always count.
def reset_counts():
    from aten_tpu_torch.utils import spans

    spans.reset()


def read_counts():
    """{instantiation: launches} of every traversal kernel since
    reset_counts()."""
    from aten_tpu_torch.ops import plk_cuda, smt_cuda, tlas_cuda, traverse_cuda

    return counts_of(traverse_cuda.INSTANTIATIONS + tlas_cuda.KERNELS
                     + plk_cuda.INSTANTIATIONS + smt_cuda.INSTANTIATIONS)


def counts_of(names):
    """{name: launches} of the kernel instantiations `names` since
    reset_counts()."""
    from aten_tpu_torch.utils import spans

    c = spans.counters()
    return {k: c.get("launch." + k, 0) for k in names}


def nonzero(counts):
    """The launch counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


def plk_plain(scene, ro, rd, t_max=None, any_hit=False, t_min=1e-4):
    """The Plücker kernel's plain version, with the u/v step of
    traverse(impl="plk_plain") and the work these rays need: (hits,
    {"node_steps", "leaves", "slot_tests"})."""
    import torch

    from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plk_plain, recompute_uv

    t0 = _t0_of(t_max, ro.shape[0], ro.device)
    h, st = _traverse_plk_plain(scene, ro, rd, t0, any_hit, t_min, stats=True)
    if any_hit:
        u = v = torch.zeros_like(h["t"])
    else:
        u, v = recompute_uv(scene, ro, rd, h["prim"])
    return {**h, "u": u, "v": v, "hit": h["prim"] >= 0}, st


def compare_plk(name, scene, ro, rd, t_max, oracle=None):
    """The Plücker kernel against its plain version, which it must equal
    bit for bit (t, prim, u, v; any-hit t and prim), and against the
    oracle walk at the parity bounds, with t and verdicts held to the
    prim-agreement bound: at least PRIM_AGREE of the rays agree on the
    prim and, where they hit, on t within T_TOL; u/v within UV_TOL where
    prims agree; any-hit verdicts agree on at least PRIM_AGREE of the
    rays.  The Plücker plane t, (n.v0 - n.ro) / n.rd, cancels at grazing
    incidence where Möller-Trumbore, which works from ro - v0, does not
    (the reference's own probe of its kernel measured |dt| 2.4e-4,
    VERDICT.md:194-200); the two tests may decide a ray through a shared
    edge differently; and the kernel's truncated t may fall under t_max
    where the exact t does not.  Returns the largest difference to the
    plain version, its work counts and the oracle walk's (the least work
    of the query), the plain version's device ms (one run) and the
    oracle walk's (hits, work), per kind.  `oracle`: those of an earlier
    call on the same rays, which this call then takes."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse

    work, oracle_work, plain_ms, err = {}, {}, {}, 0.0
    oracle = {} if oracle is None else oracle
    for kind, kw in (("closest", {}),
                     ("any", {"t_max": t_max, "any_hit": True, "t_min": 1e-3})):
        hk = traverse(scene, ro, rd, impl="plk", **kw)
        (hp, work[kind]), plain_ms[kind] = timed_ms(lambda: plk_plain(scene, ro, rd, **kw))
        if kind not in oracle:
            oracle[kind] = plain_walk(scene, ro, rd, **kw)
        ho, oracle_work[kind] = oracle[kind]
        exact = all(torch.equal(hk[k], hp[k]) for k in ("t", "prim", "u", "v", "hit"))
        err = max(err, *(float((hk[k] - hp[k]).abs().max()) for k in ("t", "u", "v")))
        pk, po = hk["prim"].cpu().numpy(), ho["prim"].cpu().numpy()
        if kind == "closest":
            m = (po >= 0) & (pk == po)
            tk, to = hk["t"].cpu().numpy()[m], ho["t"].cpu().numpy()[m]
            t_off = ~np.isclose(tk, to, rtol=T_TOL, atol=T_TOL)
            agree = float((pk == po).mean())
            agree_t = agree - float(t_off.sum()) / pk.shape[0]
            duv = max(float(np.abs(hk[k].cpu().numpy()[m] - ho[k].cpu().numpy()[m]).max())
                      for k in ("u", "v"))
            log(f"{name}: {ro.shape[0]} rays, hit {float((pk >= 0).mean()):.4f}, "
                f"bitwise equal to the plain version {exact}; against the oracle "
                f"walk: prim agreement {agree:.6f}, {int(t_off.sum())} hits off t by "
                f"more than {T_TOL} (max |dt| {float(np.abs(tk - to).max()):.3e}), "
                f"prim and t agreement {agree_t:.6f}, max |du|,|dv| {duv:.3e}")
            assert agree_t >= PRIM_AGREE, (name, agree_t)
            assert duv <= UV_TOL, (name, duv)
        else:
            agree = float((hk["hit"] == ho["hit"]).float().mean())
            log(f"{name} any-hit: occluded {float(hk['hit'].float().mean()):.4f}, "
                f"bitwise equal to the plain version {exact}; verdicts equal to the "
                f"oracle walk's on {agree:.7f} of rays "
                f"({int((hk['hit'] != ho['hit']).sum())} differ)")
            assert agree >= PRIM_AGREE, (name, agree)
        assert exact, (name, kind)
    log(f"{name} work: closest {work['closest']}, any {work['any']}; the oracle walk's "
        f"on the same rays: closest {oracle_work['closest']}, any {oracle_work['any']}")
    return err, work, oracle_work, plain_ms, oracle


def profile_render(fn):
    """One profiled call of fn(): (wall ms, device busy ms, traversal
    kernels' ms, the ten device ops with the most time as (name, ms),
    {traversal kernel: ms}, device ops), busy being the summed time of the events on
    the card (kernels, copies, fills; one stream, so they do not
    overlap).  Only the card's activity is recorded: recording the host's
    ops too slowed the host-bound renders it profiles and took seconds to
    summarise.  The sums are taken over the profiler's raw events: its
    per-name averages (`key_averages`) take about 0.2 ms an event to
    build, half a minute for a volume frame's 160,000 device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    per_name, n_ops = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue  # host ops: their device time repeats their kernels'
        per_name[e.name()] = per_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
        n_ops += 1
    trav, per_kernel = 0.0, {}
    for name, ms in per_name.items():
        if "traverse_kernel" in name:
            trav += ms
            m = re.search(r"\w+_traverse_kernel(<[^>]*>)?", name)
            short = m.group(0) if m else name
            per_kernel[short] = per_kernel.get(short, 0.0) + ms
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return wall, sum(per_name.values()), trav, top, per_kernel, n_ops


def log_profile(phase, card, prof, what="render"):
    wall, busy, trav, top, per_kernel, n_ops = prof
    log(f"{phase} profiled {what}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1.0 - busy / wall:.3f}), {n_ops} device ops, traversal kernels {trav:.2f} ms "
        f"({trav / busy if busy else 0.0:.4f} of busy) [{card}]")
    for name, ms in top:
        short = name.replace("void ", "").replace("at::native::", "")
        log(f"{phase}   top device op {ms:9.3f} ms ({ms / busy if busy else 0.0:.4f} of busy) "
            f"{short[:120]}")
    for name, ms in sorted(per_kernel.items()):
        log(f"{phase}   traversal kernel in the {what}: {name[:90]} {ms:.3f} ms "
            f"({ms / busy if busy else 0.0:.4f} of busy) [{card}]")


def render_rays(scene, cam, **kw):
    """The rays one render_image(scene, cam, **kw) hands to traversal:
    [(ro, rd, t0, any_hit, t_min)] per call, camera and bounce rays
    closest-hit, NEE shadow rays any-hit."""
    from aten_tpu_torch.accel import traverse as trav_mod
    from aten_tpu_torch.integrator import pathtracer

    calls = []
    real = trav_mod.traverse_sorted

    def record(sc, ro, rd, t_max=None, any_hit=False, t_min=1e-4, impl="auto"):
        t0 = trav_mod._t0_of(t_max, ro.shape[0], ro.device)
        calls.append((ro.detach().clone(), rd.detach().clone(), t0.clone(), any_hit, t_min))
        return real(sc, ro, rd, t_max=t_max, any_hit=any_hit, t_min=t_min, impl=impl)

    pathtracer.traverse_sorted = trav_mod.traverse_sorted = record
    try:
        pathtracer.render_image(scene, cam, **kw)
    finally:
        pathtracer.traverse_sorted = trav_mod.traverse_sorted = real
    return calls


def log_render_work(phase, scene, cam, walks, phase_work, n_phase):
    """Work per ray of one 128x128, 2 spp, depth-3 render's rays under the
    plain walks `walks` ({name: fn(scene, ro, rd, t0, any_hit, t_min,
    stats=True)}), per kind (closest, any), beside `phase_work` ({name:
    {kind: counts}}) of the phase's own n_phase rays."""
    small = dataclasses.replace(cam, width=128, height=128)
    calls = render_rays(scene, small, spp=2, max_depth=3, rr_depth=2)
    for name, walk in walks.items():
        for kind in ("closest", "any"):
            tot, live = {}, 0
            for ro, rd, t0, any_hit, t_min in calls:
                if any_hit != (kind == "any"):
                    continue
                live += int((t0 > t_min).sum())
                _, st = walk(scene, ro, rd, t0, any_hit, t_min, stats=True)
                for k, v in st.items():
                    tot[k] = tot.get(k, 0) + v
            per = ", ".join(f"{k} {v / max(live, 1):.2f}" for k, v in tot.items())
            ref = phase_work[name][kind]
            per_ph = ", ".join(f"{k} {v / n_phase:.2f}" for k, v in ref.items())
            log(f"{phase} render rays ({kind}-hit, {live} live rays of 128x128 2spp depth 3), "
                f"{name} walk per ray: {per}; on the phase's own rays: {per_ph}")


def timed_render(fn):
    """One timed fn() (a render on the card, after its warm-up): (its
    result, wall s, the launches it made, peak allocated bytes, bytes
    held before it), the launch counts and the peak reset just before."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t, read_counts(), torch.cuda.max_memory_allocated(), held


def timed_ms(fn):
    """(fn(), device ms of that one call), measured with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def smt_hits(scene, ro, rd, t0, any_hit, t_min, chains):
    """K4 at `chains` rays per lane, with the u/v step of
    traverse(impl="smt")."""
    import torch

    from aten_tpu_torch.accel.traverse import recompute_uv
    from aten_tpu_torch.ops.smt_cuda import smt_traverse

    t, prim = smt_traverse(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min, chains=chains)
    if any_hit:
        u = v = torch.zeros_like(t)
    else:
        u, v = recompute_uv(scene, ro, rd, prim)
    return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0}


def compare_smt(name, scene, ro, rd, t_max, oracle):
    """K4 at every chain count against one run of its plain version,
    which it must equal bit for bit (t, prim, u, v; any-hit t and prim:
    the walk drains whole leaves, so even any-hit prims are the plain
    version's), and against the oracle walk: prim agreement (any-hit:
    verdict agreement) >= PRIM_AGREE, t within T_TOL and u/v within UV_TOL
    where prims agree.  Returns the largest difference to the plain
    version, the plain version's work counts, the oracle walk's work
    counts (the least work of the query) and the plain version's device
    ms, per kind.  `oracle`: the oracle walk's (hits, work) on these rays
    per kind, from the phase that made them."""
    import numpy as np

    from aten_tpu_torch.accel.traverse import _t0_of, _traverse_trl_plain, recompute_uv
    from aten_tpu_torch.ops.smt_cuda import CHAIN_COUNTS

    err, work, oracle_work, plain_ms = 0.0, {}, {}, {}
    for kind, t0, any_hit, t_min in (("closest", None, False, 1e-4),
                                     ("any", t_max, True, 1e-3)):
        t0 = _t0_of(t0, ro.shape[0], ro.device)
        (hp, work[kind]), plain_ms[kind] = timed_ms(
            lambda: _traverse_trl_plain(scene, ro, rd, t0, any_hit, t_min, stats=True))
        if not any_hit:
            hp["u"], hp["v"] = recompute_uv(scene, ro, rd, hp["prim"])
        ho, oracle_work[kind] = oracle[kind]
        keys = ("t", "prim") + (() if any_hit else ("u", "v"))
        for c in CHAIN_COUNTS:
            hk = smt_hits(scene, ro, rd, t0, any_hit, t_min, c)
            exact = all(bool((hk[k] == hp[k]).all()) for k in keys)
            err = max(err, *(float((hk[k] - hp[k]).abs().max()) for k in keys if k != "prim"))
            log(f"{name} {kind}-hit K4 C={c}: bitwise equal to the plain version {exact}")
            assert exact, (name, kind, c)
        pk, po = hp["prim"].cpu().numpy(), ho["prim"].cpu().numpy()
        if kind == "closest":
            agree = float((pk == po).mean())
            m = (po >= 0) & (pk == po)
            tk, to = hp["t"].cpu().numpy()[m], ho["t"].cpu().numpy()[m]
            duv = max(float(np.abs(hp[k].cpu().numpy()[m] - ho[k].cpu().numpy()[m]).max())
                      for k in ("u", "v"))
            log(f"{name}: {ro.shape[0]} rays, hit {float((pk >= 0).mean()):.4f}; K4 against "
                f"the oracle walk: prim agreement {agree:.6f}, max |dt| "
                f"{float(np.abs(tk - to).max()):.3e}, max |du|,|dv| {duv:.3e}")
            assert agree >= PRIM_AGREE, (name, agree)
            np.testing.assert_allclose(tk, to, rtol=T_TOL, atol=T_TOL)
            assert duv <= UV_TOL, (name, duv)
        else:
            agree = float(((pk >= 0) == (po >= 0)).mean())
            log(f"{name} any-hit: occluded {float((pk >= 0).mean()):.4f}; verdicts equal to "
                f"the oracle walk's on {agree:.7f} of rays "
                f"({int(((pk >= 0) != (po >= 0)).sum())} differ)")
            assert agree >= PRIM_AGREE, (name, agree)
    log(f"{name} K4 work: closest {work['closest']}, any {work['any']}; the oracle "
        f"walk's on the same rays: closest {oracle_work['closest']}, any {oracle_work['any']}")
    return err, work, oracle_work, plain_ms


# phase 1's second process: the labs' library, built beside the traversal one
LAB_BUILD = """
import sys
sys.path.insert(0, {root!r})
from aten_tpu_torch.tools import lab_library
lab_library.load_library(verbose=True)
"""

CHILD_SMT = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from aten_tpu_torch.accel import traverse
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.ops import plk_cuda, smt_cuda, tlas_cuda, traverse_cuda
from aten_tpu_torch.scene.scenedefs import large_mesh_scene
from aten_tpu_torch.utils import spans
scene, cam = large_mesh_scene(64, 64, device="cuda")
spans.reset()
img = render_image(scene, cam, spp=4, max_depth=5, rr_depth=3)
torch.cuda.synchronize()
c = spans.counters()
counts = {{k: c.get("launch." + k, 0) for k in traverse_cuda.INSTANTIATIONS
          + tlas_cuda.KERNELS + plk_cuda.INSTANTIATIONS + smt_cuda.INSTANTIATIONS}}
print(json.dumps({{"kernel": traverse.KERNEL, "chains": traverse.CHAINS,
                  "traversal": scene.get("traversal"), "plk": "plk_consts" in scene,
                  "finite": bool(torch.isfinite(img).all()), "mean": float(img.mean()),
                  "counts": counts}}))
"""


def lab_bound(nbytes, ops):
    """(bound ms, what bounds it) of a lab launch from its bytes and
    operations."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lab_phase(card, scene, cam, dev):
    """Phase 11: the treelet-walk lab L1 (tools/kernel_lab.py) on the
    reference's 1024x1024 primary rays of `scene` (the 102,404-prim mesh
    scene with the K4 layout).  Its main path is the lab's CLI: each
    variant's first run, then `measure` (24 runs).  Each variant is then
    held bitwise against one run of its plain version on all rays, and
    the closest-hit ones (but plk) against the oracle walk.  Returns the
    kernels' JSON entries."""
    import numpy as np
    import torch

    from aten_tpu_torch.tools import kernel_lab as kl

    t11 = time.time()
    tab = kl.tables(scene)
    # `noext` is no variant; `wide16_t32` would skip slots of the layout's
    # 64-slot leaves (phase 16b runs it on a window-32 layout)
    for bad in ("noext", "wide16_t32"):
        try:
            kl.drain_of(tab, kl.parse(bad))
        except ValueError as e:
            log(f"phase 11 {bad!r} refused: {e}")
        else:
            raise AssertionError(f"kernel_lab accepted {bad!r}")
    ro, rd, t0 = kl.lab_rays(dataclasses.replace(cam, width=1024, height=1024), 1024, dev)
    n = ro.shape[0]
    assert n == 1 << 20
    # the lab's main path: each variant's first run, then its timing
    reset_counts()
    outs, times = {}, {}
    for v in LAB_VARIANTS:
        outs[v] = kl.run(tab, ro, rd, t0, v)
        times[v] = kl.measure(tab, ro, rd, t0, v)
    torch.cuda.synchronize()
    launches = counts_of(kl.KERNELS)
    log(f"phase 11 lab launches: {launches}")
    assert all(launches[kl.parse(v).kernel] > 0 for v in LAB_VARIANTS), launches
    v3 = kl.run(tab, ro, rd, t0, "v3")
    v3_ms = kl.measure(tab, ro, rd, t0, "v3")
    oracle, owork = plain_walk(scene, ro, rd, t_max=t0)
    pool_bvh = array_bytes(scene, BVH_ARRAYS)
    pool_nodes = sum(tab[k].numel() * tab[k].element_size() for k in ("nodes", "links"))
    pool_trl = pool_nodes + tab["recs"].numel() * 4
    n_prims = scene["num_tris"] + scene["num_spheres"]
    log(f"phase 11: {n} primary rays of the {n_prims}-prim scene in 32x32-pixel tiles, "
        f"{tab['nodes'].shape[0]} cut-tree nodes, {tab['pids'].shape[0]} fat leaves; v3 (K1) "
        f"{v3_ms:.3f} ms, {n / v3_ms / 1e3:.1f} Mrays/s; the oracle walk's work {owork} [{card}]")
    po = oracle["prim"]
    entries, plain_total = [], 0.0
    for v in LAB_VARIANTS:
        spec = kl.parse(v)
        t, prim = outs[v]
        (tp, pp, work), plain_ms = timed_ms(lambda: kl.run_plain(tab, ro, rd, t0, v, stats=True))
        plain_total += plain_ms
        exact = bool(torch.equal(t, tp) and torch.equal(prim, pp))
        err = float((t - tp).abs().max())
        hit = float((prim >= 0).float().mean())
        agree = float((prim == po).float().mean())
        if v in ("nodes", "nodir"):
            steps = kl.ray_walk_steps(tab, ro, rd, t0, directional=v == "nodes")
            b = bound(n, 8, pool_nodes, {"node_steps": steps})
            least = f"the per-ray walk's {steps} node steps"
            note = f"hit a fat leaf's box {hit:.4f}"
        else:
            b = bound(n, 8, pool_bvh, owork)
            least = "the oracle walk's"
            m = (po >= 0) & (prim == po)
            dt = float((t[m] - oracle["t"][m]).abs().max())
            note = (f"hit {hit:.4f}, prim agreement with the oracle walk {agree:.6f}, max |dt| "
                    f"{dt:.3e} where prims agree")
            if v == "plk":
                note += (" (information only: the lab's den carries -(n.v0) m_x, "
                         "ROADMAP.md queue 3)")
            else:
                assert agree >= PRIM_AGREE, (v, agree)
                np.testing.assert_allclose(t[m].cpu().numpy(), oracle["t"][m].cpu().numpy(),
                                           rtol=T_TOL, atol=T_TOL, err_msg=v)
        own = bound(n, 8, pool_trl, {"node_steps": work["ray_steps"],
                                     "prim_tests": work["slot_tests"]})
        ms = times[v]
        log(f"phase 11 {v}: {ms:.3f} ms, {n / ms / 1e3:.1f} Mrays/s ({ms / v3_ms:.2f}x v3); "
            f"bitwise equal to the plain version on all {n} rays {exact} (plain "
            f"{plain_ms:.1f} ms); {note}; bound ({least}) {b[0]:.4f} ms by {b[1]} ({b[2]} B, "
            f"{b[3]} ops), {ms / b[0]:.0f}x; the tile walk's own work {work} would take "
            f"{own[0]:.4f} ms by {own[1]} [{card}]")
        assert exact, v
        entries.append(
            {"name": spec.kernel, "route": "cuda", "source": LAB_SOURCE,
             "replaces": LAB_REPLACES[spec.kind], "launches": launches[spec.kernel],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": None})
    same = float((v3[1] == po).float().mean())
    log(f"phase 11 v3 against the oracle walk: prim agreement {same:.6f}; plain versions "
        f"{plain_total / 1e3:.1f} s in all; phase 11 took {time.time() - t11:.1f} s")
    assert same >= PRIM_AGREE, same
    return entries


def bounce_rays(scene, ro, rd, n, rng, impl):
    """n rays leaving first hits of the rays (ro, rd) (traversal `impl`),
    picked at random, as the path tracer's bounces leave them: 1e-3 off
    the surface on the side the ray came from (a voxel's entry face
    included), in uniform directions over that hemisphere (numpy
    seeded)."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import traverse
    from aten_tpu_torch.integrator.pathtracer import eval_hit

    h = traverse(scene, ro, rd, impl=impl)
    idx = torch.nonzero(h["hit"]).squeeze(1).cpu().numpy()
    pick = torch.from_numpy(rng.choice(idx, n)).to(ro.device)
    sub = {k: v[pick] for k, v in h.items()}
    e = eval_hit(scene, ro[pick], rd[pick], sub)
    ns = e["ns"]
    n_or = torch.where(((ns * rd[pick]).sum(1, keepdim=True) < 0), ns, -ns)
    d = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(ro.device)
    d = torch.where((d * n_or).sum(1, keepdim=True) < 0, -d, d)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return (e["p"] + n_or * 1e-3).contiguous(), d.contiguous()


# Phase 14's kernels: the traverse() impl of each LOD kernel
LOD_IMPL = {"K1-lod": "cuda", "K3-lod": "plk", "K4-lod": "smt"}
# the depth of phase 14's renders against the LOD oracle walk and of
# phase 15's against the plain walk (host-bound walks: each bounce is
# seconds of host time)
LOD_PLAIN_DEPTH = 1
PLAIN_DEPTH = 1


def lod_plain(label, scene, ro, rd, t0, any_hit, t_min):
    """The plain version of LOD kernel `label` with the u/v step of its
    traverse() impl, and the work these rays need."""
    import torch

    from aten_tpu_torch.accel import traverse as trav

    if label == "K1-lod":
        return trav._traverse_plain(scene, ro, rd, t0, any_hit, t_min, stats=True, baked=True)
    walk = trav._traverse_plk_plain if label == "K3-lod" else trav._traverse_trl_plain
    h, work = walk(scene, ro, rd, t0, any_hit, t_min, stats=True)
    if any_hit:
        u = v = torch.zeros_like(h["t"])
    else:
        u, v = trav.recompute_uv(scene, ro, rd, h["prim"])
    return {**h, "u": u, "v": v, "hit": h["prim"] >= 0}, work


def lod_kernel(label, scene, ro, rd, t0, any_hit, t_min, chains=None):
    """LOD kernel `label` (K4 at `chains` rays per lane) with the u/v step
    of its traverse() impl."""
    import torch

    from aten_tpu_torch.accel.traverse import recompute_uv
    from aten_tpu_torch.ops import plk_cuda, traverse_cuda

    if label == "K4-lod":
        return smt_hits(scene, ro, rd, t0, any_hit, t_min, chains)
    if label == "K1-lod":
        t, prim, u, v = traverse_cuda.bvh_traverse(scene, ro, rd, t0, any_hit=any_hit,
                                                   t_min=t_min)
        return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0}
    t, prim = plk_cuda.plk_traverse(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min)
    if any_hit:
        u = v = torch.zeros_like(t)
    else:
        u, v = recompute_uv(scene, ro, rd, prim)
    return {"t": t, "prim": prim, "u": u, "v": v, "hit": prim >= 0}


def compare_lod(name, label, scene, ro, rd, dist, oracle=None):
    """LOD kernel `label` (K4 at every chain count) against one run of its
    plain version, which it must equal bit for bit (closest-hit: t, prim,
    u, v; any-hit: K1's verdicts, as the plain walk keeps testing a leaf
    after its first hit, K3's and K4's t and prim), and against the LOD
    oracle walk (_traverse_plain on the scene's own tree at its
    lod_depth; `oracle` caches its (hits, work) per kind across calls on
    the same scene and rays): prim agreement >= PRIM_AGREE, and of those with t off by
    more than T_TOL counted against it (K3's truncated t); any-hit
    verdicts >= PRIM_AGREE.  Returns the largest difference to the plain
    version, the plain version's and the oracle's work and the plain
    version's device ms, per kind."""
    import numpy as np

    from aten_tpu_torch.accel.traverse import _t0_of
    from aten_tpu_torch.ops.smt_cuda import CHAIN_COUNTS

    vb = scene["num_tris"] + scene["num_spheres"]
    err, work, oracle_work, plain_ms = 0.0, {}, {}, {}
    for kind, tmax, any_hit, t_min in (("closest", None, False, 1e-4),
                                       ("any", dist, True, 1e-3)):
        t0 = _t0_of(tmax, ro.shape[0], ro.device)
        (hp, work[kind]), plain_ms[kind] = timed_ms(
            lambda: lod_plain(label, scene, ro, rd, t0, any_hit, t_min))
        if oracle is None or kind not in oracle:
            walked = plain_walk(scene, ro, rd, t_max=tmax, any_hit=any_hit, t_min=t_min)
            if oracle is not None:
                oracle[kind] = walked
        ho, oracle_work[kind] = walked if oracle is None else oracle[kind]
        keys = (("hit",) if label == "K1-lod" else ("t", "prim")) if any_hit else \
            ("t", "prim", "u", "v")
        for c in (CHAIN_COUNTS if label == "K4-lod" else (None,)):
            hk = lod_kernel(label, scene, ro, rd, t0, any_hit, t_min, c)
            exact = all(bool((hk[k] == hp[k]).all()) for k in keys)
            err = max([err] + [float((hk[k] - hp[k]).abs().max()) for k in ("t", "u", "v")
                               if k in keys])
            log(f"{name} {kind}-hit {label}{'' if c is None else f' C={c}'}: bitwise equal "
                f"to its plain version ({', '.join(keys)}) {exact}")
            assert exact, (name, label, kind, c)
        pk, po = hp["prim"].cpu().numpy(), ho["prim"].cpu().numpy()
        if kind == "closest":
            m = (po >= 0) & (pk == po)
            tk, to = hp["t"].cpu().numpy()[m], ho["t"].cpu().numpy()[m]
            t_off = ~np.isclose(tk, to, rtol=T_TOL, atol=T_TOL)
            agree = float((pk == po).mean())
            agree_t = agree - float(t_off.sum()) / pk.shape[0]
            # two voxels entered at one t: the walks' visit orders differ
            # (K4's direction-ordered links), and an ancestor box that
            # ties the best t is pruned (accel/traverse.py:270-282)
            tied = int(((pk != po) & (pk >= vb) & (po >= vb)
                        & (hp["t"].cpu().numpy() == ho["t"].cpu().numpy())).sum())
            log(f"{name} {label}: {ro.shape[0]} rays, hit {float((pk >= 0).mean()):.4f}, "
                f"voxel winners {float((pk >= vb).mean()):.4f} of rays "
                f"({float((pk >= vb).sum() / max((pk >= 0).sum(), 1)):.4f} of hits; the "
                f"oracle's {float((po >= vb).mean()):.4f}); against the LOD oracle walk: prim "
                f"agreement {agree:.6f} ({int((pk != po).sum())} differ, {tied} of them two "
                f"voxels at one t), {int(t_off.sum())} off t by more than {T_TOL} (max "
                f"|dt| {float(np.abs(tk - to).max(initial=0.0)):.3e}), prim and t agreement "
                f"{agree_t:.6f}")
            assert agree_t >= PRIM_AGREE, (name, label, agree_t)
            assert (pk >= vb).sum() > 0 and (po >= vb).sum() > 0, (name, label)
        else:
            agree = float(((pk >= 0) == (po >= 0)).mean())
            log(f"{name} {label} any-hit: occluded {float((pk >= 0).mean()):.4f}; verdicts "
                f"equal to the LOD oracle walk's on {agree:.7f} of rays "
                f"({int(((pk >= 0) != (po >= 0)).sum())} differ)")
            assert agree >= PRIM_AGREE, (name, label, agree)
    log(f"{name} {label} work: closest {work['closest']}, any {work['any']}; the LOD oracle "
        f"walk's: closest {oracle_work['closest']}, any {oracle_work['any']}")
    return err, work, oracle_work, plain_ms


def lod_phase(card, dev):
    """Phase 14: voxel LOD through the lod variants of K1, K3 and K4.  The
    LOD scenes: the 102,404-prim mesh at lod_depth 9 (the reference's
    test_voxel_lod_kernel_parity) and 15 (voxels and knot triangles both
    among the primary hits), the 512,004-prim mesh at 18 (its baked pools
    pass the 32 MB line, so the build takes K3).  Each kernel against its
    plain version and the LOD oracle walk on 4,194,304 rays (2,097,152
    jittered camera rays, the rest bounce rays off their first hits),
    timed beside its non-LOD instantiation on the same rays and beside
    its bound, and on the 102k at 15 K3-lod and K4-lod (every C) at drain
    windows 16, 32 and 128 the same way, untimed; then the three 512x512
    x 16 spp renders, depth 5, RR 3:
    the 102k at 9 through K1-lod (the main path), the 512k at 18 through
    K3-lod, the 102k at 15 through K4-lod (the K4 layout attached and
    traverse's impl="smt", the kernel and layout of a build under
    ATEN_TPU_KERNEL=smt), each profiled and held to the oracle walk's
    render at 256x256, depth 1.  Returns the kernels' JSON entries."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel import traverse as trav_mod
    from aten_tpu_torch.accel.voxel import enable_voxel_lod
    from aten_tpu_torch.integrator.pathtracer import render_image
    from aten_tpu_torch.ops import plk_cuda, plk_layout, smt_cuda, traverse_cuda
    from aten_tpu_torch.scene.scene import with_plk_layout, with_trl_layout
    from aten_tpu_torch.scene.scenedefs import large_mesh_scene, procedural_mesh_scene

    t14 = time.time()
    rng = np.random.default_rng(SEED + 14)
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    large, lcam = large_mesh_scene(512, 512, device=dev)
    n_main = cam.width * cam.height * 16
    lods = {}
    for name, base, depth in (("mesh102k@9", big, 9), ("mesh102k@15", big, 15),
                              ("mesh512k@18", large, 18)):
        t = time.time()
        lods[name] = enable_voxel_lod(base, lod_depth=depth, log=lambda m, n=name: log(
            f"phase 14 {n}: {m}"))
        torch.cuda.synchronize()
        log(f"phase 14 {name}: LOD scene in {time.time() - t:.2f} s (host work and upload)")
    lods["mesh102k@15"] = with_trl_layout(lods["mesh102k@15"])
    assert "traversal" not in lods["mesh102k@9"] and "traversal" not in lods["mesh102k@15"]
    assert lods["mesh512k@18"]["traversal"] == "plk", lods["mesh512k@18"].static
    s512 = lods["mesh512k@18"]
    log(f"phase 14 mesh512k@18: reference pools {plk_layout.pool_mb(s512['plk_hit'].shape[0], s512['plk_slot2prim'].shape[0] // plk_layout.PACK):.2f} MB "
        f"(the 32 MB line: the build takes K3)")
    # (label, scene, the non-LOD scene on the same kernel, camera, fields)
    base_k4 = with_trl_layout(big)
    runs = (("K1-lod", "mesh102k@9", big, cam, traverse_cuda._SCENE_FIELDS),
            ("K3-lod", "mesh512k@18", large, lcam, plk_cuda._SCENE_FIELDS),
            ("K4-lod", "mesh102k@15", base_k4, cam, smt_cuda._SCENE_FIELDS))
    entries = []
    for label, name, base, c, fields in runs:
        scene = lods[name]
        impl = LOD_IMPL[label]
        pool = pool_bytes(scene, fields)
        log(f"phase 14 {name}: {label}'s baked pool {pool / 1e6:.2f} MB "
            f"({', '.join(f'{k} {tuple(scene[k].shape)}' for k, _, _ in fields)}); "
            f"non-LOD {pool_bytes(base, fields) / 1e6:.2f} MB")
        cro, crd = camera_rays(c, dev, jitter_rng=rng, subsamples=8)
        bro, brd = bounce_rays(scene, cro, crd, n_main - cro.shape[0], rng, impl)
        ro, rd = torch.cat([cro, bro]), torch.cat([crd, brd])
        dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
        del cro, crd, bro, brd
        oracle = {}
        err, work, owork, plain_ms = compare_lod(f"phase 14 {name}", label, scene, ro, rd, dist,
                                                 oracle)
        if label == "K4-lod":
            # the lod variants of K3 and K4 at the other drain windows, on
            # the same rays and the same LOD oracle walk (phase 16 times the
            # windows)
            t = time.time()
            for w in (16, 32, 128):
                for wl, attach in (("K3-lod", with_plk_layout), ("K4-lod", with_trl_layout)):
                    compare_lod(f"phase 14 {name} W={w}", wl, attach(scene, window=w), ro, rd,
                                dist, oracle)
            log(f"phase 14 {name}: the lod variants at windows 16, 32, 128 in "
                f"{time.time() - t:.1f} s")
        times, bounds = {}, {}
        chains = trav_mod.CHAINS if label == "K4-lod" else None
        for kind, t0k, any_hit, t_min in (
                ("closest", torch.full((n_main,), 3.4e38, device=dev), False, 1e-4),
                ("any", dist, True, 1e-3)):
            # in turns, LOD, non-LOD, non-LOD, LOD, each the mean of 10 launches
            turns = [cuda_ms(lambda sc=sc: lod_kernel(label, sc, ro, rd, t0k, any_hit, t_min,
                                                      chains), reps=10)
                     for sc in (scene, base, base, scene)]
            lod_ms, base_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            b = bounds[kind] = bound(n_main, 8 if label != "K1-lod" else 16, pool, owork[kind])
            times[kind] = lod_ms
            log(f"phase 14 timing {kind}-hit, {n_main} rays, {name}: {label} {lod_ms:.3f} ms "
                f"({turns[0]:.3f}, {turns[3]:.3f}); its non-LOD instantiation {base_ms:.3f} ms "
                f"({turns[1]:.3f}, {turns[2]:.3f}) on the same rays, in turns "
                f"({lod_ms / base_ms:.2f}x); plain version {plain_ms[kind]:.1f} ms; bound (the "
                f"LOD oracle walk's work {owork[kind]} over the baked pool) {b[0]:.4f} ms by "
                f"{b[1]} ({b[2]} B, {b[3]} ops), {lod_ms / b[0]:.1f}x the bound [{card}]")
        del ro, rd, dist
        torch.cuda.empty_cache()
        # the render, 512x512 x 16 spp, depth 5, RR depth 3
        kw = {"spp": 16, "max_depth": 5, "rr_depth": 3,
              "impl": "smt" if label == "K4-lod" else "auto"}
        render_image(scene, c, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        img = render_image(scene, c, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = read_counts()
        names = ((traverse_cuda.LOD_KERNELS if label == "K1-lod" else plk_cuda.LOD_KERNELS)
                 if chains is None else
                 tuple(smt_cuda.kernel_name(a, chains, lod=True) for a in (False, True)))
        log(f"phase 14 {name} render launches: {launches}")
        assert all(launches[k] > 0 for k in names), launches
        assert all(v == 0 for k, v in launches.items() if k not in names), launches
        img = img.cpu().numpy()
        assert np.isfinite(img).all() and (img >= 0).all()
        assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
        log(f"phase 14 {name} render {c.width}x{c.height} 16spp depth 5 through {label}: mean "
            f"{img.mean():.5f} std {img.std():.5f} wall {wall * 1e3:.1f} ms, "
            f"{n_main / wall / 1e6:.3f} Mpaths/s [{card}]")
        log_profile(f"phase 14 {name}", card, profile_render(lambda: render_image(scene, c, **kw)))
        # against the oracle walk at 256x256, depth 1: its host-bound walk
        # takes a time set by its steps, not its rays (16-24 s a scene at
        # 512x512, depth 5)
        t = time.time()
        half = dataclasses.replace(c, width=c.width // 2, height=c.height // 2)
        kw2 = {**kw, "max_depth": LOD_PLAIN_DEPTH}
        ik = render_image(scene, half, **kw2).cpu().numpy()
        plain = render_image(scene, half, **{**kw2, "impl": "plain"}).cpu().numpy()
        log(f"phase 14 {name}: the kernels' and the LOD oracle walk's {half.width}x"
            f"{half.height} depth-{LOD_PLAIN_DEPTH} renders took {time.time() - t:.1f} s")
        check_image_bounds(f"phase 14 {name} {half.width}x{half.height} 16spp depth "
                           f"{LOD_PLAIN_DEPTH} {label} vs the LOD oracle walk", ik, plain)
        entries += [
            {"name": k, "route": "cuda", "source": {"K1-lod": KERNEL_SOURCE,
                                                   "K3-lod": PLK_SOURCE,
                                                   "K4-lod": SMT_SOURCE}[label],
             "replaces": {"K1-lod": REPLACES, "K3-lod": PLK_REPLACES,
                          "K4-lod": SMT_REPLACES}[label],
             "launches": launches[k], "max_abs_err": err, "ms": times[kind],
             "plain_ms": plain_ms[kind], "bound_ms": bounds[kind][0],
             "bound_by": bounds[kind][1], "library_ms": None}
            for k, kind in zip(names, ("closest", "any"))]
        del img, plain
        torch.cuda.empty_cache()
    log(f"phase 14 took {time.time() - t14:.1f} s")
    return entries


# Phase 15's kStats runs: (scene, kernel, lod_depth); the bytes of the
# per-ray counts each kStats instantiation writes beside its hits
STATS_RUNS = (("mesh102k", "K1", None), ("mesh102k@9", "K1", 9),
              ("mesh512k", "K3", None), ("mesh512k@18", "K3", 18))
COUNT_BYTES = {"K1": 8, "K3": 12}
# the traversal-stats tool's runs in phase 15b: (scene, kernel override)
TOOL_RUNS = (("mesh", None), ("large", None), ("mesh@9", None), ("large@18", None),
             ("mesh@15", None), ("mesh@15", "k1"))
TOOL_RES = 1024


def stats_counts(kernel, scene, ro, rd, t0, any_hit, t_min, stats):
    """K1 or K3 through its wrapper, the kStats instantiation with stats:
    (hits, counts or None), hits (t, prim[, u, v])."""
    from aten_tpu_torch.ops import plk_cuda, traverse_cuda

    fn = traverse_cuda.bvh_traverse if kernel == "K1" else plk_cuda.plk_traverse
    out = fn(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min, stats=stats)
    return (out[:-1], out[-1]) if stats else (out, None)


def stats_plain(kernel, scene, ro, rd, t0, any_hit, t_min):
    """The plain version's per-ray counts and totals."""
    from aten_tpu_torch.accel.traverse import _traverse_plain, _traverse_plk_plain

    if kernel == "K1":
        h, work = _traverse_plain(scene, ro, rd, t0, any_hit, t_min, stats=True,
                                  baked=bool(scene.get("has_voxel_lod")))
    else:
        h, work = _traverse_plk_plain(scene, ro, rd, t0, any_hit, t_min, stats=True)
    return h["counts"], work


def kernel_render(phase, card, scene, cam, names, **kw):
    """A 512x512-class render through the kernels `names` on the card: a
    warm-up, then one timed render (wall, Mpaths/s, peak memory, the
    launches, each of `names` launched and no other kernel), then a
    profiled one.  Returns the image (numpy)."""
    import numpy as np

    from aten_tpu_torch.integrator.pathtracer import render_image

    render_image(scene, cam, **kw)  # warm-up
    img, wall, launches, peak, held = timed_render(lambda: render_image(scene, cam, **kw))
    img = img.cpu().numpy()
    log(f"{phase} launches: {launches}")
    assert all(launches[k] > 0 for k in names), (phase, launches)
    assert all(v == 0 for k, v in launches.items() if k not in names), (phase, launches)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (phase, img.mean(), img.std())
    n = cam.width * cam.height * kw["spp"]
    log(f"{phase} {cam.width}x{cam.height} {kw['spp']}spp depth {kw['max_depth']} RR "
        f"{kw['rr_depth']}: mean {img.mean():.5f} std {img.std():.5f} wall {wall * 1e3:.1f} ms, "
        f"{n / wall / 1e6:.3f} Mpaths/s, {peak_text(peak, held)} [{card}]")
    log_profile(phase, card, profile_render(lambda: render_image(scene, cam, **kw)))
    return img


def against_plain(phase, scene, cam, spp=2):
    """The scene through the kernels against the plain walk's render 128
    pixels wide (the camera's aspect), spp samples, depth PLAIN_DEPTH
    (the plain walk is host-bound, its time set by its walks: depth 1,
    the primary walk and its shadow rays, keeps the script in its
    budget), within the full-image bounds."""
    from aten_tpu_torch.integrator.pathtracer import render_image

    small = dataclasses.replace(cam, width=128, height=128 * cam.height // cam.width)
    kw = {"spp": spp, "max_depth": PLAIN_DEPTH, "rr_depth": 1}
    t = time.time()
    ik = render_image(scene, small, **kw).cpu().numpy()
    ip = render_image(scene, small, impl="plain", **kw).cpu().numpy()
    size = f"{small.width}x{small.height} {spp}spp"
    log(f"{phase}: the kernels' and the plain walk's {size} renders took "
        f"{time.time() - t:.1f} s")
    check_image_bounds(f"{phase} {size} depth {PLAIN_DEPTH}, kernels vs the plain walk", ik, ip)


def stats_phase(card, dev):
    """Phase 15: the kStats instantiations of K1 and K3, the traversal-stats
    tool, and alpha, stencil, the cameras and blue noise through K1.  15a: on
    4,194,304 camera and bounce rays of the 102,404-prim mesh (K1), its
    voxel-LOD scene at lod_depth 9 (K1-lod), the 512,004-prim mesh (K3)
    and its LOD scene at 18 (K3-lod), each kStats instantiation's hits
    bitwise those of its plain instantiation and its per-ray counts
    bitwise those of its plain version, timed in turns with the plain
    instantiation; 15b: aten_tpu_torch/tools/trav_stats.py on its five
    scenes and on mesh@15 through K1-lod, the one run that launches the
    kStats instantiations (their launch counts), and K1-lod and K4-lod
    timed in turns on mesh@15's baked tree; 15c: alpha_mesh_scene
    and 15d: stencil_mesh_scene at 512x512 x 16 spp, depth 5, RR 3,
    through K1, timed with peak memory and profiled, each against the
    plain walk's render at 128x128 x 2 spp, depth 1; 15e: the mesh scene
    through a thin-lens camera focused on the knot (512x512 x 16 spp) and
    an equirect one (1024x512 x 8 spp), each against the plain walk at
    128 pixels wide x 2 spp, depth 1, and render_sample(sampler="bluenoise",
    spp_chunk=16) at 512x512, with a 64x64 render on the card against
    the port on this machine's CPU.  Returns the kStats instantiations'
    JSON entries."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel import traverse as trav_mod
    from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plain
    from aten_tpu_torch.accel.voxel import enable_voxel_lod
    from aten_tpu_torch.core.camera import EquirectCamera, ThinLensCamera
    from aten_tpu_torch.integrator.pathtracer import render_sample
    from aten_tpu_torch.ops import plk_cuda, smt_cuda, traverse_cuda
    from aten_tpu_torch.scene.scenedefs import (
        alpha_mesh_scene, large_mesh_scene, procedural_mesh_scene, stencil_mesh_scene)
    from aten_tpu_torch.tools import trav_stats

    t15 = time.time()
    rng = np.random.default_rng(SEED + 15)
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    large, lcam = large_mesh_scene(512, 512, device=dev)
    scenes = {"mesh102k": (big, cam), "mesh102k@9": (enable_voxel_lod(big, lod_depth=9), cam),
              "mesh512k": (large, lcam),
              "mesh512k@18": (enable_voxel_lod(large, lod_depth=18), lcam)}
    n_main = cam.width * cam.height * 16
    log(f"phase 15a: scenes built in {time.time() - t15:.1f} s")

    # 15a: each kStats instantiation against its plain instantiation and
    # its plain version
    results = {}
    for name, kernel, depth in STATS_RUNS:
        scene, c = scenes[name]
        lod = depth is not None
        impl = "cuda" if kernel == "K1" else "plk"
        cro, crd = camera_rays(c, dev, jitter_rng=rng, subsamples=8)
        bro, brd = bounce_rays(scene, cro, crd, n_main - cro.shape[0], rng, impl)
        ro, rd = torch.cat([cro, bro]), torch.cat([crd, brd])
        dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
        del cro, crd, bro, brd
        fields = traverse_cuda._SCENE_FIELDS if kernel == "K1" else plk_cuda._SCENE_FIELDS
        pool = pool_bytes(scene, fields) if lod else array_bytes(scene, BVH_ARRAYS)
        for kind, tmax, any_hit, t_min in (("closest", None, False, 1e-4),
                                           ("any", dist, True, 1e-3)):
            t0 = _t0_of(tmax, n_main, dev)
            hs, cs = stats_counts(kernel, scene, ro, rd, t0, any_hit, t_min, True)
            hn, _ = stats_counts(kernel, scene, ro, rd, t0, any_hit, t_min, False)
            same_hits = all(torch.equal(a, b) for a, b in zip(hs, hn))
            (cp, work), plain_ms = timed_ms(
                lambda: stats_plain(kernel, scene, ro, rd, t0, any_hit, t_min))
            same_counts = {k: bool(torch.equal(cs[k], cp[k])) for k in cs}
            # the bound: the query's least work, the oracle walk's (K1's
            # plain version on an uncut tree)
            owork = work if kernel == "K1" and not lod else _traverse_plain(
                scene, ro, rd, t0, any_hit, t_min, stats=True)[1]
            out_bytes = (16 if kernel == "K1" else 8) + COUNT_BYTES[kernel]
            b = bound(n_main, out_bytes, pool, owork)
            turns = [cuda_ms(lambda st=st: stats_counts(kernel, scene, ro, rd, t0, any_hit,
                                                        t_min, st), reps=10)
                     for st in (True, False, False, True)]
            ms, base_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            per_ray = ", ".join(f"{k} {float(v.double().mean()):.3f}" for k, v in cs.items())
            log(f"phase 15a {name} {kind}-hit {kernel}{'-lod' if lod else ''} kStats: hits "
                f"bitwise equal to the plain instantiation's {same_hits}; per-ray counts "
                f"bitwise equal to the plain version's {same_counts}; per ray {per_ray}")
            log(f"phase 15a timing {kind}-hit, {n_main} rays, {name}: kStats {ms:.3f} ms "
                f"({turns[0]:.3f}, {turns[3]:.3f}), plain instantiation {base_ms:.3f} ms "
                f"({turns[1]:.3f}, {turns[2]:.3f}), in turns ({ms / base_ms:.3f}x); plain "
                f"version with counts {plain_ms:.1f} ms; bound (the oracle walk's work {owork} "
                f"over {pool} B, {out_bytes} B out per ray) {b[0]:.4f} ms by {b[1]} ({b[2]} B, "
                f"{b[3]} ops), {ms / b[0]:.1f}x the bound [{card}]")
            assert same_hits and all(same_counts.values()), (name, kind)
            names = {"K1": (traverse_cuda.LOD_STATS_KERNELS if lod
                            else traverse_cuda.STATS_KERNELS),
                     "K3": (plk_cuda.LOD_STATS_KERNELS if lod
                            else plk_cuda.STATS_KERNELS)}[kernel]
            results[names[int(any_hit)]] = {"ms": ms, "plain_ms": plain_ms, "bound": b,
                                             "kernel": kernel}
        del ro, rd, dist
        torch.cuda.empty_cache()
    del scenes, big, large
    torch.cuda.empty_cache()
    log(f"phase 15a took {time.time() - t15:.1f} s")

    # 15b: the traversal-stats tool, the one entry point of the kStats
    # instantiations
    t = time.time()
    reset_counts()
    for name, kernel in TOOL_RUNS:
        trav_stats.run(name, dev, TOOL_RES, kernel=kernel, log=lambda m: log(f"phase 15b {m}"))
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"phase 15b trav_stats launches: {launches}; took {time.time() - t:.1f} s [{card}]")
    assert all(launches[k] > 0 for k in results), launches
    # the two LOD walks the counts compare, on one baked tree (mesh@15)
    # and the tool's primary rays, timed in turns
    scene, c, _ = trav_stats.build_scene("mesh@15", TOOL_RES, dev, kernel="k4")
    assert "bvh_nodes" in scene  # the build's K1 records, beside the K4 layout
    ro, rd = trav_stats.primary_rays(c, TOOL_RES, dev)
    t0 = _t0_of(None, ro.shape[0], dev)
    walks = {"K1": lambda: traverse_cuda.bvh_traverse(scene, ro, rd, t0),
             "K4": lambda: smt_cuda.smt_traverse(scene, ro, rd, t0, chains=trav_mod.CHAINS)}
    turns = [cuda_ms(walks[k], reps=10) for k in ("K1", "K4", "K4", "K1")]
    log(f"phase 15b mesh@15 closest-hit on the tool's {ro.shape[0]} primary rays, in turns: "
        f"K1-lod {(turns[0] + turns[3]) / 2:.3f} ms ({turns[0]:.3f}, {turns[3]:.3f}), K4-lod "
        f"C={trav_mod.CHAINS} {(turns[1] + turns[2]) / 2:.3f} ms ({turns[1]:.3f}, "
        f"{turns[2]:.3f}) [{card}]")
    del scene, ro, rd, t0
    entries = [
        {"name": k, "route": "cuda",
         "source": KERNEL_SOURCE if r["kernel"] == "K1" else PLK_SOURCE,
         "replaces": REPLACES if r["kernel"] == "K1" else PLK_REPLACES,
         "launches": launches[k], "max_abs_err": 0.0, "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": None}
        for k, r in results.items()]

    kw = {"spp": 16, "max_depth": 5, "rr_depth": 3}
    k1 = traverse_cuda.KERNELS
    # 15c: alpha punch-through; its shadow rays walk closest hits
    t = time.time()
    scene, c = alpha_mesh_scene(512, 512, device=dev)
    assert scene["has_alpha"] and "traversal" not in scene, scene.static
    log(f"phase 15c alpha_mesh_scene: {scene['num_tris'] + scene['num_spheres']} prims, "
        f"built in {time.time() - t:.1f} s")
    kernel_render("phase 15c alpha_mesh_scene", card, scene, c, k1[:1], **kw)
    against_plain("phase 15c alpha_mesh_scene", scene, c)
    # 15d: stencil punch-through
    t = time.time()
    scene, c = stencil_mesh_scene(512, 512, device=dev)
    assert scene["has_stencil"] and not scene["has_alpha"], scene.static
    log(f"phase 15d stencil_mesh_scene: {scene['num_tris'] + scene['num_spheres']} prims, "
        f"built in {time.time() - t:.1f} s")
    kernel_render("phase 15d stencil_mesh_scene", card, scene, c, k1, **kw)
    against_plain("phase 15d stencil_mesh_scene", scene, c)
    del scene
    torch.cuda.empty_cache()

    # 15e: thin-lens and equirect cameras, blue noise
    scene, c = procedural_mesh_scene(512, 512, device=dev)
    focus = float(np.linalg.norm(np.subtract(c.lookat, c.origin)))
    tl = ThinLensCamera(origin=c.origin, lookat=c.lookat, vfov_deg=c.vfov_deg, width=c.width,
                        height=c.height, lens_radius=0.3, focus_dist=focus)
    kernel_render("phase 15e thin-lens", card, scene, tl, k1, **kw)
    against_plain("phase 15e thin-lens", scene, tl)
    eq = EquirectCamera(origin=(0.0, 2.0, 7.0), lookat=(0.0, 1.5, 0.0), width=2 * c.width,
                        height=c.height)
    kernel_render("phase 15e equirect", card, scene, eq, k1, **{**kw, "spp": 8})
    against_plain("phase 15e equirect", scene, eq)
    ca = c.arrays(dev)

    def bn(sc, a, w, spp):
        return render_sample(sc, a, w, w, 0, 0, spp, 5, 3, spp_chunk=spp, sampler="bluenoise")

    bn(scene, ca, c.width, 16)  # warm-up, and the masks
    img, wall, launches, peak, held = timed_render(lambda: bn(scene, ca, c.width, 16))
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and img.std() > 0 and all(launches[k] > 0 for k in k1)
    log(f"phase 15e bluenoise render_sample {c.width}x{c.height} spp_chunk 16 depth 5: mean "
        f"{img.mean():.5f} std {img.std():.5f} wall {wall * 1e3:.1f} ms, "
        f"{n_main / wall / 1e6:.3f} Mpaths/s, {peak_text(peak, held)}, launches "
        f"{ {k: launches[k] for k in k1} } [{card}]")
    t = time.time()
    small = dataclasses.replace(c, width=64, height=64)
    imgs = [bn(scene, small.arrays(dev), 64, 4).cpu().numpy()]
    cpu_scene, _ = procedural_mesh_scene(64, 64, device="cpu")
    imgs.append(bn(cpu_scene, small.arrays("cpu"), 64, 4).numpy())
    log(f"phase 15e bluenoise 64x64 on the CPU took {time.time() - t:.1f} s")
    check_image_bounds("phase 15e bluenoise render_sample 64x64 4spp depth 5, card vs CPU",
                       *imgs)
    log(f"phase 15 took {time.time() - t15:.1f} s (budget 150 s)")
    return entries


# Phase 16a's drain windows; 64, the default, is the yardstick
WINDOWS16 = (16, 32, 64, 128)


def window_phase(card, dev):
    """Phase 16: drain windows other than 64 (ATEN_TRL_WINDOW), and the
    first-hit AOV G-buffer.  16a: K3 at windows 16, 32, 64 and 128
    (`with_plk_layout(window=)`) on 4,194,304 camera and bounce rays of
    the 512,004-prim mesh, made as phase 15a makes them, and K4 at every
    C on 2,097,152 camera and surface rays of the 102,404-prim mesh at the
    same windows (`with_trl_layout(window=)`): each window but 64 (whose
    instantiations phases 7, 9 and 14 hold) bitwise its plain version,
    both kinds, and against the oracle walk
    (prim agreement >= PRIM_AGREE, t within T_TOL); K3's kStats counts per
    window; each timed in turns against window 64 on the same rays (the
    lod variants at these windows: phase 14); then the large
    mesh rendered at 512x512 x 16 spp through K3 at the fastest other
    window, against the window-64 render within the full-image bounds.
    16b: the L1 lab's wide8_t32 on a window-32 layout, bitwise its plain
    version on 64 of its tiles.  16c: render_sample_with_aovs at
    bench.py's shape (512x512, 1 spp, depth 5, RR 3) on the 102k mesh
    through K1, its radiance bitwise render_sample's, its AOVs bitwise
    the plain walk's at 128x128 (depth 1); wall, idle share and peak memory beside
    render_sample's.  In the kernels line, a window instantiation's
    `launches` is the best window's render's own count, and for the
    windows no path runs, that of one pass of the rays with the counts
    reset just before it.  Returns the kernels' JSON entries."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import _t0_of
    from aten_tpu_torch.integrator.pathtracer import (
        render_image, render_sample, render_sample_with_aovs)
    from aten_tpu_torch.ops import plk_cuda, smt_cuda, traverse_cuda
    from aten_tpu_torch.scene.scene import with_plk_layout, with_trl_layout
    from aten_tpu_torch.scene.scenedefs import large_mesh_scene, procedural_mesh_scene
    from aten_tpu_torch.tools import kernel_lab as kl

    t16 = time.time()
    rng = np.random.default_rng(SEED + 16)
    large, lcam = large_mesh_scene(512, 512, device=dev)
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    n_main = lcam.width * lcam.height * 16
    log(f"phase 16a: scenes built in {time.time() - t16:.1f} s")
    entries, results = [], {}
    # launches of one pass of the rays per (kernel, window, kind), the
    # counts reset just before it (the best K3 window's: its render's)
    one_pass = {}

    def layout(fn, scene, w):
        t = time.time()
        out = scene if w == 64 else fn(scene, window=w)
        torch.cuda.synchronize()
        return out, time.time() - t

    def turns_vs_64(fn64, fn):
        """(window-64 ms, this window's ms), in turns 64, W, W, 64."""
        tt = [cuda_ms(f, reps=10) for f in (fn64, fn, fn, fn64)]
        return (tt[0] + tt[3]) / 2, (tt[1] + tt[2]) / 2

    def kinds(dist):
        return (("closest", _t0_of(None, dist.shape[0], dev), False, 1e-4),
                ("any", dist, True, 1e-3))

    # K3 on the 512k mesh
    cro, crd = camera_rays(lcam, dev, jitter_rng=rng, subsamples=8)
    bro, brd = bounce_rays(large, cro, crd, n_main - cro.shape[0], rng, "plk")
    ro, rd = torch.cat([cro, bro]), torch.cat([crd, brd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    del cro, crd, bro, brd
    oracle, pool = {}, array_bytes(large, BVH_ARRAYS)
    k3 = {}
    for w in WINDOWS16:
        scene, secs = k3[w] = layout(with_plk_layout, large, w)
        if w != 64:  # 64's instantiation: phases 7, 14 and 15a
            err, work, owork, plain_ms, oracle = compare_plk(
                f"phase 16a mesh512k K3 W={w}", scene, ro, rd, dist, oracle)
        per = {}
        for kind, t0k, any_hit, t_min in kinds(dist):
            reset_counts()
            hn = plk_cuda.plk_traverse(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min)
            one_pass["K3", w, kind] = read_counts()[plk_cuda.kernel_names("", w)[int(any_hit)]]
            out = plk_cuda.plk_traverse(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min,
                                        stats=True)
            assert all(torch.equal(a, b) for a, b in zip(out[:2], hn)), (w, kind)
            per[kind] = ", ".join(f"{k} {float(v.double().mean()):.3f}" for k, v in
                                  out[2].items())
            if w == 64:
                log(f"phase 16a {kind}-hit, {n_main} rays, mesh512k: K3 W=64 kStats per ray: "
                    f"{per[kind]} (hits bitwise the plain instantiation's)")
                continue
            ms64, ms = turns_vs_64(
                lambda: plk_cuda.plk_traverse(large, ro, rd, t0k, any_hit=any_hit, t_min=t_min),
                lambda: plk_cuda.plk_traverse(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min))
            b = bound(n_main, 8, pool, owork[kind])
            results["K3", w, kind] = {"ms": ms, "ms64": ms64, "plain_ms": plain_ms[kind],
                                      "bound": b, "err": err}
            log(f"phase 16a timing {kind}-hit, {n_main} rays, mesh512k: K3 W={w} {ms:.3f} ms, "
                f"W=64 {ms64:.3f} ms in turns ({ms / ms64:.3f}x); plain version "
                f"{plain_ms[kind]:.1f} ms; bound (the oracle walk's work) {b[0]:.4f} ms by "
                f"{b[1]}, {ms / b[0]:.1f}x; kStats per ray: {per[kind]} (hits bitwise the "
                f"plain instantiation's) [{card}]")
        log(f"phase 16a mesh512k W={w}: {scene['plk_nodes'].shape[0]} cut-tree nodes, "
            f"{scene['plk_slot2prim'].shape[0]} slots, layout built in {secs:.2f} s")
    del ro, rd, dist, oracle
    torch.cuda.empty_cache()
    log(f"phase 16a K3 windows: {time.time() - t16:.1f} s since the phase began")

    # K4 on the 102k mesh, every C
    n_k4 = n_main // 2
    cro, crd = camera_rays(cam, dev, jitter_rng=rng, subsamples=4)
    sro, srd = surface_rays(big, n_k4 - cro.shape[0], rng, dev)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_k4), dtype=torch.float32, device=dev)
    del cro, crd, sro, srd
    oracle = {kind: plain_walk(big, ro, rd, t_max=tm, any_hit=a, t_min=tn)
              for kind, tm, a, tn in (("closest", None, False, 1e-4), ("any", dist, True, 1e-3))}
    pool = array_bytes(big, BVH_ARRAYS)
    k4_64 = with_trl_layout(big)
    c1 = smt_cuda.DEFAULT_CHAINS
    for w in (w for w in WINDOWS16 if w != 64):  # 64's: phases 9 and 14
        scene, secs = layout(with_trl_layout, big, w)
        err, work, owork, plain_ms = compare_smt(f"phase 16a mesh102k K4 W={w}", scene, ro, rd,
                                                 dist, oracle)
        for kind, t0k, any_hit, t_min in kinds(dist):
            reset_counts()
            smt_cuda.smt_traverse(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min, chains=c1)
            one_pass["K4", w, kind] = read_counts()[smt_cuda.kernel_name(any_hit, c1, window=w)]
            ms64, ms = turns_vs_64(
                lambda: smt_cuda.smt_traverse(k4_64, ro, rd, t0k, any_hit=any_hit, t_min=t_min,
                                              chains=c1),
                lambda: smt_cuda.smt_traverse(scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min,
                                              chains=c1))
            b = bound(n_k4, 8, pool, owork[kind])
            results["K4", w, kind] = {"ms": ms, "ms64": ms64, "plain_ms": plain_ms[kind],
                                      "bound": b, "err": err}
            log(f"phase 16a timing {kind}-hit, {n_k4} rays, mesh102k: K4 C={c1} W={w} "
                f"{ms:.3f} ms, W=64 {ms64:.3f} ms in turns ({ms / ms64:.3f}x); plain version "
                f"{plain_ms[kind]:.1f} ms; bound {b[0]:.4f} ms by {b[1]}, {ms / b[0]:.1f}x; "
                f"K4's work {work[kind]} [{card}]")
        log(f"phase 16a mesh102k W={w}: {scene['trl_nodes'].shape[0]} cut-tree nodes, "
            f"{scene['trl_recs'].shape[0]} slots, layout built in {secs:.2f} s")
        del scene
    del ro, rd, dist, oracle, k4_64
    torch.cuda.empty_cache()
    log(f"phase 16a K4 windows: {time.time() - t16:.1f} s since the phase began")

    # the large mesh rendered through K3 at the fastest other window
    best = min((w for w in WINDOWS16 if w != 64),
               key=lambda w: sum(results["K3", w, k]["ms"] for k in ("closest", "any")))
    kw = {"spp": 16, "max_depth": 5, "rr_depth": 3}
    s_best = k3[best][0]
    render_image(s_best, lcam, **kw)  # warm-up
    img, wall, launches, peak, held = timed_render(lambda: render_image(s_best, lcam, **kw))
    names = plk_cuda.kernel_names("", best)
    log(f"phase 16a render launches at W={best}: {nonzero(launches)}")
    assert all(launches[k] > 0 for k in names), launches
    assert all(v == 0 for k, v in launches.items() if k not in names), launches
    for kind, name in zip(("closest", "any"), names):
        one_pass["K3", best, kind] = launches[name]
    log(f"phase 16a launches reported (the W={best} render's, else one pass of the rays): "
        f"{ {f'{k} W={w} {kind}': v for (k, w, kind), v in one_pass.items()} }")
    img = img.cpu().numpy()
    ref = render_image(large, lcam, **kw).cpu().numpy()
    log(f"phase 16a render 512x512 16spp depth 5 through K3 at W={best}: mean {img.mean():.5f} "
        f"wall {wall * 1e3:.1f} ms, {n_main / wall / 1e6:.3f} Mpaths/s, "
        f"{peak_text(peak, held)} [{card}]")
    check_image_bounds(f"phase 16a K3 W={best} render vs the W=64 render", img, ref)
    del k3, s_best, img, ref
    torch.cuda.empty_cache()
    # K4's windows 16 and 32 share one instantiation, entered at 32
    for kernel, src, rep, kn, windows in (("K3", PLK_SOURCE, PLK_REPLACES, None, (16, 32, 128)),
                                          ("K4", SMT_SOURCE, SMT_REPLACES, c1, (32, 128))):
        for w in windows:
            for kind in ("closest", "any"):
                r = results[kernel, w, kind]
                any_hit = kind == "any"
                name = (plk_cuda.kernel_names("", w)[int(any_hit)] if kernel == "K3"
                        else smt_cuda.kernel_name(any_hit, kn, window=w))
                entries.append({
                    "name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": one_pass[kernel, w, kind], "max_abs_err": r["err"],
                    "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": None})
    assert all(e["launches"] > 0 for e in entries), entries
    log(f"phase 16a took {time.time() - t16:.1f} s")

    # 16b: the lab's _t32 drain on a window-32 layout
    t = time.time()
    tab32 = kl.tables(with_trl_layout(big, window=32))
    lro, lrd, lt0 = kl.lab_rays(dataclasses.replace(cam, width=1024, height=1024), 1024, dev)
    out = kl.run(tab32, lro, lrd, lt0, "wide8_t32")
    tiles = torch.arange(0, lro.shape[0] // 1024, 16, device=dev)
    tp, pp = kl.run_plain(tab32, lro, lrd, lt0, "wide8_t32", tiles=tiles)
    sel = (tiles[:, None] * 1024 + torch.arange(1024, device=dev)).reshape(-1)
    exact = bool(torch.equal(out[0][sel], tp) and torch.equal(out[1][sel], pp))
    ms32 = kl.measure(tab32, lro, lrd, lt0, "wide8_t32")
    tab64 = kl.tables(with_trl_layout(big))
    ms64 = kl.measure(tab64, lro, lrd, lt0, "wide8")
    log(f"phase 16b L1 wide8_t32 on a window-32 layout: bitwise equal to its plain version on "
        f"{tiles.shape[0]} tiles {exact}; {ms32:.3f} ms, wide8 on the window-64 layout "
        f"{ms64:.3f} ms, {lro.shape[0]} lab rays; {time.time() - t:.1f} s [{card}]")
    assert exact
    del tab32, tab64, lro, lrd, lt0, out

    # 16c: the first-hit AOV G-buffer at bench.py's sponza_svgf shape
    t = time.time()
    ca = cam.arrays(dev)
    args = (cam.width, cam.height, 0, 0, 1, 5, 3)
    render_sample_with_aovs(big, ca, *args)  # warm-up
    (img, aovs), wall, launches, peak, held = timed_render(
        lambda: render_sample_with_aovs(big, ca, *args))
    ref, wall_rs, _, peak_rs, held_rs = timed_render(lambda: render_sample(big, ca, *args))
    log(f"phase 16c render_sample_with_aovs launches: {nonzero(launches)}")
    assert all(launches[k] > 0 for k in traverse_cuda.KERNELS), launches
    assert all(v == 0 for k, v in launches.items() if k not in traverse_cuda.KERNELS), launches
    same = bool(torch.equal(img, ref))
    hit = float((aovs["prim"] >= 0).float().mean())
    log(f"phase 16c render_sample_with_aovs 512x512 1spp depth 5 RR 3 through K1: wall "
        f"{wall * 1e3:.1f} ms, {peak_text(peak, held)}; render_sample {wall_rs * 1e3:.1f} ms, "
        f"{peak_text(peak_rs, held_rs)}; radiance bitwise render_sample's {same}; first hits "
        f"{hit:.4f} of pixels [{card}]")
    assert same and 0.2 < hit < 1.0
    log(f"phase 16c timed renders: {time.time() - t:.1f} s since 16c began")
    prof = profile_render(lambda: render_sample_with_aovs(big, ca, *args))
    log_profile("phase 16c render_sample_with_aovs", card, prof)
    log_profile("phase 16c render_sample", card,
                profile_render(lambda: render_sample(big, ca, *args)))
    # at 128x128 and depth 1 (the AOVs are bounce 0's; the plain walk is
    # host-bound)
    log(f"phase 16c profiles: {time.time() - t:.1f} s since 16c began")
    small = dataclasses.replace(cam, width=128, height=128)
    sa = (128, 128, 0, 0, 1, 1, 1)
    _, ak = render_sample_with_aovs(big, small.arrays(dev), *sa)
    _, ap = render_sample_with_aovs(big, small.arrays(dev), *sa, impl="plain")
    exact = {k: bool(torch.equal(ak[k], ap[k])) for k in ak}
    log(f"phase 16c AOVs at 128x128 through K1 bitwise the plain walk's: {exact}; phase 16c "
        f"took {time.time() - t:.1f} s; phase 16 took {time.time() - t16:.1f} s "
        f"(budget 60 s)")
    assert all(exact.values()), exact
    return entries


# the real-time path's gates (phase 17)
RT_FRAC = 0.999          # pixels within the card-against-CPU tolerance
RT_RTOL, RT_ATOL = 1e-3, 1e-5
ORBIT_YAW = 0.01         # radians a frame (0.57 degrees)
MOVED_INST = 13          # instanced_mesh_scene's knot near the front row
MOVE_DX = 0.5            # its translation a frame (about 13 pixels at 512x512)
AOV_KW = {"spp": 1, "max_depth": 5, "rr_depth": 3}  # bench.py's sponza_svgf frame


def close_frac(got, ref):
    """Fraction of pixels of got [H, W, ...] whose every value is within
    RT_RTOL, RT_ATOL of ref's (numpy)."""
    ok = abs(got - ref) <= RT_ATOL + RT_RTOL * abs(ref)
    return float(ok.reshape(ok.shape[0], ok.shape[1], -1).all(-1).mean())


def to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_cpu(v) for v in tree)
    return tree.cpu() if torch.is_tensor(tree) else tree


def phase17(card, dev):
    """Phase 17: the real-time path through K1 and K5.  17a: SVGF at
    bench.py's sponza_svgf shape on the 102,404-prim mesh (no Sponza: the
    asset-free stand-in), render_sample_with_aovs at 512x512 x 1 spp,
    depth 5, RR 3 through K1, then the denoiser, for 8 frames of a camera
    orbiting 0.01 rad a frame and 3 static ones; each frame's render and
    SVGF timed apart (CUDA events) with K1's launches, the history's
    acceptance gated, one step profiled (its device ops, idle share) with
    its peak memory, TAA and gt_tonemap on the output; the last orbit
    frame's SVGF, TAA and tonemap on the card against the port on this
    machine's CPU fed the same inputs and state; the denoised frame's
    median error against a 64 spp render_image under 0.75x the raw
    sample's.  17b: object motion through K5 on instanced_mesh_scene,
    rebuilt each frame with knot instance MOVED_INST moved MOVE_DX, 3
    frames, the denoiser fed the scene and not.  17c: render_ao on the
    102k mesh at 512x512, spp 2, 4 rays, radius 1 (2 closest-hit and 8
    any-hit launches of K1), and at 128x128, spp 1, against the oracle
    walk's.  17d: ReSTIR direct and GI (depth 5, RR 3) at bench.py's
    restir_126lights shape (many_light_scene, 512x512, 126 lights; 27
    prims, the dense test: no kernel), 3 frames each; at 64x64 with 32
    lights, 2 frames, against tests/golden/restir_{lights,gi}.npz and
    against the port on this machine's CPU.  17e: ReSTIR GI on the 102k
    mesh at 512x512, depth 5, 2 frames through K1, and a frame at
    128x128, depth 2, against the oracle walk's."""
    from aten_tpu_torch.scene.scenedefs import procedural_mesh_scene

    t17 = time.time()
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    svgf_frames(card, dev, big, cam)
    log(f"phase 17a took {time.time() - t17:.1f} s")
    object_motion(card, dev, cam.width, cam.height)
    ao_check(card, big, cam)
    restir_shapes(card, dev)
    restir_mesh(card, dev, big, cam)
    log(f"phase 17 took {time.time() - t17:.1f} s (aim 90 s)")


def only_kernels(launches, names, what):
    """A run's launches: each kernel of `names` launched, no other one."""
    got = nonzero(launches)
    log(f"{what} launches: {got}")
    assert all(got.get(k, 0) > 0 for k in names) and set(got) <= set(names), (what, got)
    return got


def svgf_frames(card, dev, big, cam):
    """Phase 17a (see phase17)."""
    import numpy as np
    import torch

    from aten_tpu_torch.core.camera import CameraOperator, camera_matrices
    from aten_tpu_torch.denoise import svgf
    from aten_tpu_torch.display import taa, tonemap
    from aten_tpu_torch.integrator.pathtracer import render_image, render_sample_with_aovs
    from aten_tpu_torch.ops import traverse_cuda

    W, H = cam.width, cam.height
    closest, any_hit = traverse_cuda.KERNELS
    t = time.time()
    img, aovs = render_sample_with_aovs(big, cam.arrays(dev), W, H, 0, 0, **AOV_KW)  # warm-up
    svgf.SVGFDenoiser(W, H, device=dev).step(img, aovs, cam)
    den = svgf.SVGFDenoiser(W, H, device=dev)
    hist = taa.init_history(H, W, dev)
    prev_cam = c = cam
    rows, cpu_check = [], None
    for f in range(11):
        if 0 < f < 8:
            c = CameraOperator.orbit(c, ORBIT_YAW, 0.0)
        ca = c.arrays(dev)
        reset_counts()
        (img, aovs), r_ms = timed_ms(lambda: render_sample_with_aovs(big, ca, W, H, f, 0,
                                                                      **AOV_KW))
        launches = only_kernels(read_counts(), traverse_cuda.KERNELS, f"phase 17a frame {f} render")
        assert launches[closest] == 5 and launches[any_hit] == 5, launches
        snap = to_cpu((den.state, hist)) if f == 7 else None
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out, s_ms = timed_ms(lambda: den.step(img, aovs, c))
        peak = torch.cuda.max_memory_allocated()
        pw2v, pv2c = camera_matrices(prev_cam, device=dev)
        (shown, hist), d_ms = timed_ms(lambda: taa.taa_step(out, aovs["pos"], aovs["depth"],
                                                            hist, pw2v, pv2c))
        mapped = tonemap.gt_tonemap(shown)
        hit = aovs["depth"] > 0
        hv = den.state["history"][hit]
        rows.append((f, r_ms, s_ms, d_ms, float((hv > 1).float().mean()),
                     float((hv >= 3).float().mean())))
        log(f"phase 17a frame {f} ({'orbit' if f < 8 else 'static'}): render {r_ms:.1f} ms, "
            f"SVGF {s_ms:.1f} ms ({peak_text(peak, held)}), TAA + tonemap {d_ms:.1f} ms; "
            f"history > 1 on {rows[-1][4]:.4f}, >= 3 on {rows[-1][5]:.4f} of "
            f"{int(hit.sum())} hit pixels [{card}]")
        assert bool(torch.isfinite(out).all() and torch.isfinite(mapped).all()), f
        if f == 7:
            cpu_check = (snap, img.cpu(), to_cpu(aovs), c, prev_cam, out.cpu(), to_cpu(den.state),
                         shown.cpu(), mapped.cpu())
        prev_cam = c
    assert all(r[4] >= 0.5 for r in rows[1:8]), rows
    assert rows[-1][5] >= 0.9, rows[-1]
    log(f"phase 17a: 11 frames in {time.time() - t:.1f} s; render mean "
        f"{np.mean([r[1] for r in rows[1:]]):.1f} ms, SVGF mean "
        f"{np.mean([r[2] for r in rows[1:]]):.1f} ms a frame (frames 1-10) [{card}]")
    log_profile("phase 17a", card, profile_render(lambda: den.step(img, aovs, c)),
                what="SVGF step")
    ca = c.arrays(dev)
    log_profile("phase 17a", card, profile_render(lambda: den.step(
        *render_sample_with_aovs(big, ca, W, H, 11, 0, **AOV_KW), c)),
        what="frame (render + SVGF)")
    # the last orbit frame on this machine's CPU, fed the card's inputs
    t = time.time()
    (st, th), cimg, caovs, cc, pc, out_k, st_k, shown_k, mapped_k = cpu_check
    out_c, st_c = svgf.svgf_step(cimg, caovs, st, den.params, cc, W, H)
    pw2v, pv2c = camera_matrices(pc, device="cpu")
    shown_c, _ = taa.taa_step(out_k, caovs["pos"], caovs["depth"], th, pw2v, pv2c)
    mapped_c = tonemap.gt_tonemap(shown_k)
    fr = {"SVGF out": close_frac(out_k.numpy(), out_c.numpy())}
    for k in ("color", "moments", "history"):
        fr[f"state {k}"] = close_frac(st_k[k].numpy(), st_c[k].numpy())
    fr["state valid"] = float((st_k["valid"] == st_c["valid"]).float().mean())
    fr["TAA"] = close_frac(shown_k.numpy(), shown_c.numpy())
    fr["gt_tonemap"] = close_frac(mapped_k.numpy(), mapped_c.numpy())
    log(f"phase 17a frame 7 on the card against this machine's CPU (rtol {RT_RTOL}, atol "
        f"{RT_ATOL}), fraction of pixels within: {fr}; SVGF out max abs "
        f"{float((out_k - out_c).abs().max()):.3e}; {time.time() - t:.1f} s")
    assert all(v >= RT_FRAC for v in fr.values()), fr
    # the denoised static frame against a converged render of its view
    ref = render_image(big, c, spp=64, max_depth=5, rr_depth=3, frame=100).cpu().numpy()
    hit = aovs["depth"].cpu().numpy() > 0
    raw, den_img = img.cpu().numpy(), out.cpu().numpy()
    err_raw = float(np.median(np.abs(raw - ref)[hit]))
    err_den = float(np.median(np.abs(den_img - ref)[hit]))
    log(f"phase 17a last static frame against a 64 spp render_image, median abs error over hit "
        f"pixels: raw {err_raw:.5f}, denoised {err_den:.5f} (ratio {err_den / err_raw:.3f}, "
        f"< 0.75)")
    assert err_den < 0.75 * err_raw, (err_den, err_raw)


def object_motion(card, dev, W, H):
    """Phase 17b (see phase17)."""
    import numpy as np
    import torch

    from aten_tpu_torch.denoise import svgf
    from aten_tpu_torch.integrator.pathtracer import render_sample_with_aovs
    from aten_tpu_torch.ops import tlas_cuda
    from aten_tpu_torch.scene.scene import SceneBuilder
    from aten_tpu_torch.scene.scenedefs import populate_instanced_mesh_scene

    closest, any_hit = tlas_cuda.KERNELS
    t = time.time()

    class MovedBuilder(SceneBuilder):
        """A builder that moves instance `MOVED_INST` by dx along x."""

        def __init__(self, dx):
            super().__init__()
            self.dx, self.n = dx, 0

        def add_instance(self, obj_id, l2w):
            m = np.array(l2w, np.float32)
            if self.n == MOVED_INST:
                m[0, 3] += self.dx
            self.n += 1
            return super().add_instance(obj_id, m)

    frames = []
    for f in range(3):
        tb = time.time()
        b = MovedBuilder(MOVE_DX * f)
        icam = populate_instanced_mesh_scene(b, W, H)
        scene = b.build(dev)
        torch.cuda.synchronize()
        build_s = time.time() - tb
        ica = icam.arrays(dev)
        if f == 0:
            render_sample_with_aovs(scene, ica, W, H, 0, 0, **AOV_KW)  # warm-up
        reset_counts()
        (img, aovs), r_ms = timed_ms(lambda: render_sample_with_aovs(scene, ica, W, H, f, 0,
                                                                      **AOV_KW))
        launches = only_kernels(read_counts(), tlas_cuda.KERNELS, f"phase 17b frame {f} render")
        assert launches[closest] == 5 and launches[any_hit] == 5, launches
        frames.append((img, aovs, {"inst_w2l": scene["inst_w2l"]}))
        log(f"phase 17b frame {f}: rebuild {build_s:.2f} s, render {r_ms:.1f} ms, instance "
            f"{MOVED_INST} on {int((aovs['inst'] == MOVED_INST).sum())} pixels [{card}]")
        del scene
    for fed in (True, False):
        den = svgf.SVGFDenoiser(W, H, device=dev)
        for f, (img, aovs, sc) in enumerate(frames):
            _, s_ms = timed_ms(lambda: den.step(img, aovs, icam, scene=sc if fed else None))
            on = aovs["inst"] == MOVED_INST
            hv = den.state["history"][on & (aovs["depth"] > 0)]
            above, one = float((hv > 1).float().mean()), float((hv == 1).float().mean())
            log(f"phase 17b frame {f}, denoiser {'fed' if fed else 'not fed'} the scene: SVGF "
                f"{s_ms:.1f} ms; on the moving instance's {hv.numel()} hit pixels history > 1 "
                f"on {above:.4f}, == 1 on {one:.4f}")
            if f:
                assert (above >= 0.8) if fed else (one >= 0.8), (fed, f, above, one)
    log(f"phase 17b took {time.time() - t:.1f} s")


def ao_check(card, big, cam):
    """Phase 17c (see phase17)."""
    import numpy as np

    from aten_tpu_torch.integrator.ao import render_ao
    from aten_tpu_torch.ops import traverse_cuda

    closest, any_hit = traverse_cuda.KERNELS
    t = time.time()
    ao_kw = {"spp": 2, "num_rays": 4, "ao_radius": 1.0}
    render_ao(big, cam, **ao_kw)  # warm-up
    reset_counts()
    ao, ao_ms = timed_ms(lambda: render_ao(big, cam, **ao_kw))
    launches = only_kernels(read_counts(), traverse_cuda.KERNELS, "phase 17c render_ao")
    assert launches[closest] == 2 and launches[any_hit] == 8, launches
    ao = ao.cpu().numpy()
    assert np.isfinite(ao).all() and 0.0 <= ao.min() and ao.max() <= 1.0 and ao.min() < 1.0
    # at 128x128 and one sample (the oracle walk's time is set by its
    # walks, one closest-hit and four any-hit here, not by its rays)
    small = dataclasses.replace(cam, width=128, height=128)
    ao_kw["spp"] = 1
    ak = render_ao(big, small, **ao_kw).cpu().numpy()
    ap = render_ao(big, small, impl="plain", **ao_kw).cpu().numpy()
    same = (ak == ap).all(-1)
    log(f"phase 17c render_ao {cam.width}x{cam.height} spp 2, 4 rays, radius 1 through K1: "
        f"{ao_ms:.1f} ms, mean "
        f"{ao.mean():.4f}; at 128x128 spp 1 equal to the oracle walk's on {same.mean():.6f} of "
        f"pixels, "
        f"differing at {np.argwhere(~same).tolist()[:20]}; {time.time() - t:.1f} s [{card}]")
    assert same.mean() >= RT_FRAC


def restir_shapes(card, dev):
    """Phase 17d (see phase17)."""
    import numpy as np
    import torch

    from aten_tpu_torch.integrator import restir
    from aten_tpu_torch.scene.scenedefs import many_light_scene

    t = time.time()
    ml, mcam = many_light_scene(512, 512, num_lights=126, device=dev)
    for gi in (False, True):
        r = restir.ReSTIRRenderer(ml, mcam, gi=gi)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = []
        for _ in range(3):
            img, m = timed_ms(r.render_frame)
            ms.append(m)
        peak = torch.cuda.max_memory_allocated()
        assert not nonzero(read_counts()), read_counts()
        img = img.cpu().numpy()
        assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3
        log(f"phase 17d ReSTIR {'GI depth 5 RR 3' if gi else 'direct'} "
            f"{mcam.width}x{mcam.height}, 126 lights: "
            f"{', '.join(f'{v:.1f}' for v in ms)} ms a frame, mean {img.mean():.5f}, "
            f"{peak_text(peak, held)}, 0 kernel launches (27 prims: the dense test) [{card}]")
    log_profile("phase 17d", card, profile_render(r.render_frame), what="ReSTIR GI frame")
    del ml, r
    gscene, gcam = many_light_scene(64, 64, num_lights=32, device=dev)
    cscene, _ = many_light_scene(64, 64, num_lights=32, device="cpu")
    for name, fn, kw in (("restir_lights", restir.restir_direct_sample, {}),
                         ("restir_gi", restir.restir_gi_sample, {"max_depth": 3, "rr_depth": 2})):
        imgs = []
        for sc, d in ((gscene, dev), (cscene, "cpu")):
            st = restir.init_state(64, 64, d)
            for f in range(2):
                img, st = fn(sc, gcam.arrays(d), 64, 64, f, st, **kw)
            imgs.append(img.cpu().numpy())
        with np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz")) as z:
            gold = z["img"]
        err = np.abs(imgs[0] - gold).max(-1)
        # the max bound at every pixel where the port on this machine's CPU
        # meets it (tests/test_torch_restir.py holds the CPU to the same)
        cpu_ok = np.abs(imgs[1] - gold).max(-1) < 5e-3
        over = np.argwhere(err >= 5e-3)
        log(f"phase 17d {name} 64x64 on the card against the golden: max {err.max():.4e} "
            f"(bound 5e-3), mean {np.abs(imgs[0] - gold).mean():.4e} (bound 5e-4); {len(over)} "
            f"pixels over the max bound {[(p.tolist(), float(err[tuple(p)])) for p in over]}, "
            f"the CPU's over it at {np.argwhere(~cpu_ok).tolist()}; max over the pixels where "
            f"the CPU meets it {err[cpu_ok].max():.4e}")
        assert np.abs(imgs[0] - gold).mean() < 5e-4
        assert err[cpu_ok].max() < 5e-3, err[cpu_ok].max()
        check_image_bounds(f"phase 17d {name} 64x64, the card against this machine's CPU",
                           imgs[0], imgs[1])
    log(f"phase 17d took {time.time() - t:.1f} s")


def restir_mesh(card, dev, big, cam):
    """Phase 17e (see phase17)."""
    import numpy as np

    from aten_tpu_torch.integrator import restir
    from aten_tpu_torch.ops import traverse_cuda

    W, H = cam.width, cam.height
    t = time.time()
    closest, any_hit = traverse_cuda.KERNELS
    st = restir.init_state(H, W, dev)
    ca = cam.arrays(dev)
    for f in range(2):
        reset_counts()
        (img, st), ms = timed_ms(lambda: restir.restir_gi_sample(big, ca, W, H, f, st))
        # a primary walk, 4 bounce walks; the reservoir's two shadow rays
        # and one NEE shadow ray a bounce
        launches = only_kernels(read_counts(), traverse_cuda.KERNELS,
                                f"phase 17e ReSTIR GI frame {f}")
        assert launches[closest] == 5 and launches[any_hit] == 6, launches
        log(f"phase 17e ReSTIR GI {W}x{H} depth 5 RR 3 on the 102k mesh, frame {f}: {ms:.1f} ms "
            f"[{card}]")
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-3
    sca = dataclasses.replace(cam, width=128, height=128).arrays(dev)
    got = {}
    for impl in ("auto", "plain"):
        reset_counts()
        im, _ = restir.restir_gi_sample(big, sca, 128, 128, 0, restir.init_state(128, 128, dev),
                                        max_depth=2, rr_depth=1, impl=impl)
        if impl == "auto":
            launches = only_kernels(read_counts(), traverse_cuda.KERNELS,
                                    "phase 17e ReSTIR GI 128x128 depth 2")
            assert launches[closest] == 2 and launches[any_hit] == 3, launches
        else:
            assert not nonzero(read_counts()), read_counts()
        got[impl] = im.cpu().numpy()
    check_image_bounds("phase 17e ReSTIR GI 128x128 depth 2, K1 vs the plain walk",
                       got["auto"], got["plain"])
    log(f"phase 17e took {time.time() - t:.1f} s")


# Phase 18's renders.  18a: bench.py's hetero_volume_ms call
# (bench.py:332-348): render_volpt_sample, sample i of 4, depth 8, RR 4,
# frame 1, at 256x256; 18b the same on the homogeneous fog box.
VOL_BENCH = {"spp": 4, "max_depth": 8, "rr_depth": 4}
VOL_FRAME = 1
VOL_CHECK = {"spp": 4, "max_depth": 6}  # tests/golden/volume.npz's config, at 32x32
# the statistical bounds of tests/test_torch_volume.py: tracking decisions
# flip on an ulp of log or exp, and the path then takes another walk
VOL_PIXEL_FRAC, VOL_MEAN_REL, VOL_BLOCK_REL = 0.90, 0.02, 0.10
FOG_KW = {"spp": 2, "max_depth": 5, "rr_depth": 3}  # 18c, through K1
# 18c's renders against K1's plain version: 64x64, 2 spp, depth 2, RR 1
# (the plain walk is host-bound, its time set by its walks, ~0.8 s each)
FOG_SMALL = 64
FOG_SMALL_KW = {"spp": 2, "max_depth": 2, "rr_depth": 1}
NPR_SMALL = 64  # 18d's renders against the oracle walk
LINE_SAMPLES = 8
LINE_AGREE = 0.999


SYNC_SITES = ("tracking", "shadow")
_SYNC_ZERO = {}


def _syncs():
    from aten_tpu_torch.utils import spans

    c = spans.counters()
    return {k: c.get("host_sync." + k, 0) for k in SYNC_SITES}


def reset_syncs():
    """Take the volume tracer's host-sync counters as zero from here."""
    _SYNC_ZERO.update(_syncs())


def read_syncs():
    """The volume tracer's host syncs since reset_syncs: the tracking
    loops' and the shadow walks' live counts."""
    return {k: v - _SYNC_ZERO[k] for k, v in _syncs().items()}


def volume_image_stats(img, ref):
    """(fraction of pixels within 1e-4 in every channel, |mean - ref mean|
    / ref mean, largest rel difference of 4x4-block means), as
    tests/test_torch_volume.py holds the port to the reference."""
    import numpy as np

    within = float((np.abs(img - ref) <= 1e-4).all(-1).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    h, w = img.shape[0] // 4, img.shape[1] // 4
    bi = img[:h * 4, :w * 4].reshape(h, 4, w, 4, 3).mean((1, 3, 4))
    br = ref[:h * 4, :w * 4].reshape(h, 4, w, 4, 3).mean((1, 3, 4))
    return within, mean_rel, float((np.abs(bi - br) / np.maximum(np.abs(br), 1e-2)).max())


def check_volume_bounds(name, img, ref):
    import numpy as np

    within, mean_rel, block_rel = volume_image_stats(img, ref)
    log(f"{name}: {within:.4f} of pixels within 1e-4 (>= {VOL_PIXEL_FRAC}), mean rel "
        f"{mean_rel:.5f} (<= {VOL_MEAN_REL}), 4x4-block means rel <= {block_rel:.4f} "
        f"(<= {VOL_BLOCK_REL})")
    assert np.isfinite(img).all() and (img >= 0).all(), name
    assert (within >= VOL_PIXEL_FRAC and mean_rel <= VOL_MEAN_REL
            and block_rel <= VOL_BLOCK_REL), name


def phase18(card, dev):
    """Phase 18: participating media and NPR.  18a: bench.py's
    hetero_volume_ms call on hetero_volume_scene(256, 256) (res 48; 16
    prims, the dense test: no kernel), render_volpt_sample, sample i of
    4, depth 8, RR 4, frame 1: a warm-up, 3 frames by CUDA events with
    the host syncs a frame (the tracking loops' and shadow walks' live
    counts) and the peak added, one profiled frame; at 32x32 (res 24, 4
    spp, depth 6) the card against the port on this machine's CPU and
    against tests/golden/volume.npz, within the statistical bounds of
    tests/test_torch_volume.py.  18b: the same on
    homogeneous_volume_scene(256, 256).  18c: the 102,404-prim knot in a
    homogeneous null-boundary fog box and in a smoke_plume(48) grid
    medium (fog_knot_scene), each render_volpt at 256x256, 2 spp, depth 5,
    RR 3 through K1 (closest-hit launches only), and at 64x64 bitwise
    the render through K1's plain version.  18d: render_npr on the 102k
    mesh at 512x512 through K1 (2 closest-hit, 3 any-hit launches) and
    feature_lines_sample_rays at 512x512 with 8 samples (9 closest-hit),
    and both at 64x64 against the oracle walk."""
    from aten_tpu_torch.scene.scenedefs import hetero_volume_scene, homogeneous_volume_scene

    t18 = time.time()
    for part, make, small_kw in (("a", hetero_volume_scene, {"res": 24}),
                                 ("b", homogeneous_volume_scene, {})):
        volume_frames(card, dev, part, make, small_kw)
    fog_knot(card, dev)
    npr_check(card, dev)
    log(f"phase 18 took {time.time() - t18:.1f} s (aim 90 s) [{card}]")


def volume_frames(card, dev, part, make, small_kw):
    """Phase 18a or 18b (see phase18); small_kw: the 32x32 scene's
    arguments (the hetero grid at res 24, the golden's)."""
    import numpy as np
    import torch

    from aten_tpu_torch.integrator.volpt import render_volpt, render_volpt_sample

    t = time.time()
    scene, cam = make(256, 256, device=dev)
    W, H, ca = cam.width, cam.height, cam.arrays(dev)
    name = f"phase 18{part} {make.__name__}"

    def frame(i):
        return render_volpt_sample(scene, ca, W, H, VOL_FRAME, i, **VOL_BENCH)

    frame(3)  # warm-up
    log(f"{name}: built and warmed up in {time.time() - t:.1f} s")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rows = []
    for i in range(3):
        reset_syncs()
        img, ms = timed_ms(lambda: frame(i))
        rows.append((ms, read_syncs()))
    peak = torch.cuda.max_memory_allocated()
    assert not nonzero(read_counts()), read_counts()
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3, img.mean()
    log(f"{name} {W}x{H}, bench.py's call (a sample of 4, depth 8, RR 4, frame 1; 16 prims, the "
        f"dense test: 0 kernel launches): "
        f"{', '.join(f'{ms:.1f} ms ({s})' for ms, s in rows)} a frame (host syncs), mean "
        f"{img.mean():.5f}, {peak_text(peak, held)} [{card}]")
    log_profile(name, card, profile_render(lambda: frame(0)), what="frame")
    # at 32x32: the card against this machine's CPU and the golden
    imgs = []
    for d in (dev, "cpu"):
        tc = time.time()
        s, c = make(32, 32, device=d, **small_kw)
        imgs.append(render_volpt(s, c, **VOL_CHECK).cpu().numpy())
        log(f"{name} 32x32 render on {d}: {time.time() - tc:.1f} s [{card}]")
    check_volume_bounds(f"{name} 32x32 4 spp depth 6, the card against this machine's CPU",
                        *imgs)
    if small_kw:
        with np.load(os.path.join(ROOT, "tests", "golden", "volume.npz")) as z:
            check_volume_bounds(f"{name} 32x32, the card against tests/golden/volume.npz",
                                imgs[0], z["img"])
    log(f"{name} took {time.time() - t:.1f} s [{card}]")


def fog_knot(card, dev):
    """Phase 18c (see phase18)."""
    import numpy as np
    import torch

    from aten_tpu_torch.integrator.volpt import render_volpt
    from aten_tpu_torch.ops import traverse_cuda
    from aten_tpu_torch.scene.scenedefs import fog_knot_scene

    closest = traverse_cuda.KERNELS[0]
    for grid in (None, 48):
        t = time.time()
        scene, cam = fog_knot_scene(256, 256, grid_res=grid, device=dev)
        name = f"phase 18c fog_knot_scene ({'smoke_plume(48) grid' if grid else 'homogeneous'})"
        assert "traversal" not in scene, scene.static  # K1's
        log(f"{name}: {scene['num_tris']} prims, built in {time.time() - t:.1f} s")
        render_volpt(scene, cam, **FOG_KW)  # warm-up
        reset_counts()
        reset_syncs()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        img, ms = timed_ms(lambda: render_volpt(scene, cam, **FOG_KW))
        peak = torch.cuda.max_memory_allocated()
        launches = only_kernels(read_counts(), (closest,), f"{name} render")
        img = img.cpu().numpy()
        assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3, img.mean()
        log(f"{name} render_volpt {cam.width}x{cam.height} 2 spp depth 5 RR 3 through K1: "
            f"{ms:.1f} ms, mean {img.mean():.5f}, {launches[closest]} closest-hit launches, "
            f"host syncs {read_syncs()}, {peak_text(peak, held)} [{card}]")
        log_profile(name, card, profile_render(lambda: render_volpt(scene, cam, **FOG_KW)))
        t = time.time()
        small = dataclasses.replace(cam, width=FOG_SMALL, height=FOG_SMALL)
        ik = render_volpt(scene, small, **FOG_SMALL_KW).cpu().numpy()
        reset_counts()
        ip = render_volpt(scene, small, impl="plain", **FOG_SMALL_KW).cpu().numpy()
        assert not nonzero(read_counts()), read_counts()
        same = bool(np.array_equal(ik, ip))
        log(f"{name} {FOG_SMALL}x{FOG_SMALL} 2 spp depth 2: K1 against its plain version "
            f"bitwise {same}, mean {ik.mean():.5f}; {time.time() - t:.1f} s [{card}]")
        assert same, name
        del scene
        torch.cuda.empty_cache()


def npr_check(card, dev):
    """Phase 18d (see phase18)."""
    import numpy as np

    from aten_tpu_torch.integrator.npr import ToonParams, feature_lines_sample_rays, render_npr
    from aten_tpu_torch.ops import traverse_cuda
    from aten_tpu_torch.scene.scenedefs import procedural_mesh_scene

    t = time.time()
    closest, any_hit = traverse_cuda.KERNELS
    big, cam = procedural_mesh_scene(512, 512, device=dev)
    W, H, ca = cam.width, cam.height, cam.arrays(dev)
    params = ToonParams()

    def lines(sc, a, w, h, **kw):
        return feature_lines_sample_rays(sc, a, w, h, 0, params, num_samples=LINE_SAMPLES, **kw)

    render_npr(big, cam)  # warm-up
    lines(big, ca, W, H)
    reset_counts()
    img, npr_ms = timed_ms(lambda: render_npr(big, cam))
    got = only_kernels(read_counts(), traverse_cuda.KERNELS, "phase 18d render_npr")
    # the G-buffer pass's two bounces and their NEE rays, the key light's shadow ray
    assert got == {closest: 2, any_hit: 3}, got
    reset_counts()
    mask, line_ms = timed_ms(lambda: lines(big, ca, W, H))
    got_l = only_kernels(read_counts(), (closest,), "phase 18d feature_lines_sample_rays")
    assert got_l == {closest: 1 + LINE_SAMPLES}, got_l
    img, mask = img.cpu().numpy(), mask.cpu().numpy()
    assert np.isfinite(img).all() and 0.0 < mask.mean() < 0.5, mask.mean()
    log(f"phase 18d render_npr {W}x{H} through K1: {npr_ms:.1f} ms, launches {got}; "
        f"feature_lines_sample_rays {W}x{H}, {LINE_SAMPLES} samples: {line_ms:.1f} ms, launches "
        f"{got_l}, lines on {mask.mean():.4f} of pixels [{card}]")
    log_profile("phase 18d", card, profile_render(lambda: render_npr(big, cam)),
                what="render_npr")
    small = dataclasses.replace(cam, width=NPR_SMALL, height=NPR_SMALL)
    sa = small.arrays(dev)
    t2 = time.time()
    ik = render_npr(big, small).cpu().numpy()
    ip = render_npr(big, small, impl="plain").cpu().numpy()
    lk = lines(big, sa, NPR_SMALL, NPR_SMALL).cpu().numpy()
    lp = lines(big, sa, NPR_SMALL, NPR_SMALL, impl="plain").cpu().numpy()
    agree = float((lk == lp).mean())
    log(f"phase 18d {NPR_SMALL}x{NPR_SMALL} against the oracle walk: line masks agree on "
        f"{agree:.6f} of pixels (>= {LINE_AGREE}); {time.time() - t2:.1f} s [{card}]")
    assert agree >= LINE_AGREE, agree
    check_image_bounds(f"phase 18d render_npr {NPR_SMALL}x{NPR_SMALL}, K1 vs the oracle walk",
                       ik, ip)
    log(f"phase 18d took {time.time() - t:.1f} s [{card}]")


def golden_zoo_bounds(name, img, gold):
    """The zoo's golden gate: the full-image radiance bounds over the whole
    image, and the golden-test bounds (max < 5e-3, mean < 5e-4 absolute)
    over at least 99.8% of its pixels; a few firefly paths through the
    rough-dielectric and retroreflective spheres are too ill-conditioned
    to hold to the golden's own bounds (ROADMAP.md queue 3)."""
    import numpy as np

    assert img.shape == gold.shape and np.isfinite(img).all(), name
    check_image_bounds(name, img, gold)
    err = np.abs(img - gold).max(axis=-1)
    ok = err < 5e-3
    log(f"{name}: max abs {err.max():.3e}, mean abs {err.mean():.3e}; {int((~ok).sum())} of "
        f"{ok.size} pixels over 5e-3, mean abs over the others {err[ok].mean():.3e} (< 5e-4)")
    assert ok.mean() >= 0.998 and err[ok].mean() < 5e-4, name


def zoo_phase(card, dev):
    """Phase 12: the material zoo, IBL and textures (no kernel: the zoo
    has 13-15 prims, so traversal is the dense test).  12a: the zoo
    against its golden on the card; 12b: the reference bench's zoo+IBL
    config, 512x512 x 32 spp, depth 5, RR depth 3, timed and profiled;
    12c and 12d: zoo+IBL and the texture fixture on the card against the
    port on this machine's CPU, at the full-image bounds."""
    import numpy as np
    import torch

    from aten_tpu_torch.integrator import pathtracer
    from aten_tpu_torch.scene.scenedefs import material_test_scene, sky_envmap, textured_scene

    t12 = time.time()
    # 12a: the zoo against the golden
    scene, cam = material_test_scene(96, 48, device=dev)
    img = pathtracer.render_image(scene, cam, spp=8, max_depth=4).cpu().numpy()
    with np.load(os.path.join(ROOT, "tests", "golden", "mtrl_zoo.npz")) as z:
        gold = z["img"]
    golden_zoo_bounds("phase 12a zoo 96x48 8spp depth 4 vs golden", img, gold)

    # 12b: the bench's zoo+IBL config
    sky = sky_envmap()
    scene, cam = material_test_scene(512, 512, envmap=sky, device=dev)
    assert scene["num_tris"] + scene["num_spheres"] == 13 and "envmap" in scene
    kw = {"spp": 32, "max_depth": 5, "rr_depth": 3}
    pathtracer.render_image(scene, cam, **kw)  # warm-up
    torch.cuda.synchronize()
    dispatches = []
    real = pathtracer.render_sample

    def counted(*a, **k):
        dispatches.append(k.get("spp_chunk"))
        return real(*a, **k)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    pathtracer.render_sample = counted
    try:
        t = time.time()
        img = pathtracer.render_image(scene, cam, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t
    finally:
        pathtracer.render_sample = real
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    img = img.cpu().numpy()
    log(f"phase 12b launches: {launches} (the zoo runs the dense test, no kernel)")
    assert not any(launches.values()), launches
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-2 <= img.mean() <= 1e2 and img.std() > 0, (img.mean(), img.std())
    log(f"phase 12b zoo+IBL 512x512 32spp depth 5: {len(dispatches)} dispatches of "
        f"spp_chunk {dispatches}, mean {img.mean():.5f} std {img.std():.5f} finite "
        f"{bool(np.isfinite(img).all())}, wall {wall * 1e3:.1f} ms, "
        f"{512 * 512 * 32 / wall / 1e6:.3f} Mpaths/s, peak allocated "
        f"{peak / 2**30:.2f} GiB [{card}]")
    assert len(dispatches) == 2 and dispatches == [16, 16], dispatches
    log_profile("phase 12b", card,
                profile_render(lambda: pathtracer.render_image(scene, cam, **kw)))
    del scene, img
    torch.cuda.empty_cache()

    # 12c and 12d: the card against the port on the CPU
    for name, make, w, h in (
            ("12c zoo+IBL", lambda w, h, d: material_test_scene(w, h, envmap=sky, device=d),
             64, 32),
            ("12d textured", lambda w, h, d: textured_scene(w, h, device=d), 32, 32)):
        imgs = []
        t = time.time()
        for d in (dev, "cpu"):
            sc, c = make(w, h, d)
            imgs.append(pathtracer.render_image(sc, c, spp=4, max_depth=4).cpu().numpy())
        assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 1e-2, name
        check_image_bounds(f"phase {name} {w}x{h} 4spp depth 4, card vs CPU ({time.time() - t:.1f} "
                           "s)", *imgs)
    log(f"phase 12 took {time.time() - t12:.1f} s")


def log_step_profile(phase, card, prof, fwd_busy):
    """log_profile's lines for one profiled train step, with the forward
    pass's share of busy time (fwd_busy: the busy ms of the forward pass
    alone, profiled on its own)."""
    log_profile(phase, card, prof, what="step")
    busy = prof[1]
    log(f"{phase}   forward pass alone: device busy {fwd_busy:.1f} ms, {fwd_busy / busy:.3f} of "
        f"the step's busy; backward, all-reduce and update {busy - fwd_busy:.1f} ms, "
        f"{1.0 - fwd_busy / busy:.3f} [{card}]")


def peak_text(peak, held):
    """The peak of allocated memory, and what of it was already held (the
    scene, and whatever earlier phases keep) before the timed work."""
    return (f"peak allocated {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before, "
            f"{(peak - held) / 2**30:.3f} GiB added)")


def forward_pass(scene, ca, target, frame, w, h, spp, depth, rr_depth, fields):
    """The train step's forward pass alone: its leaves, render and loss."""
    import torch

    from aten_tpu_torch.integrator.pathtracer import _trace_paths
    from aten_tpu_torch.parallel import mesh

    params = {k: mesh._get_param(scene, k).detach().requires_grad_(True)
              for k in fields if mesh._has_param(scene, k)}
    rad = _trace_paths(mesh._set_params(scene, params), ca, w, h, frame, 0, spp, depth, rr_depth)
    return torch.mean((rad.reshape(h, w, 3) - target) ** 2)


def timed_steps(step, scene, ca, target, n):
    """Wall ms of each of n steps (frames 1..n), each ended by a
    synchronize, after one warm-up step (frame 0); the last loss."""
    import torch

    step(scene, ca, target, 0)
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        t = time.time()
        loss, _ = step(scene, ca, target, i + 1)
        torch.cuda.synchronize()
        times.append((time.time() - t) * 1e3)
    return times, float(loss)


def populate_textured_quad(b, width, height):
    """tests/test_grad.py's textured setup: a quad under a 4x4 albedo
    texture of 0.5 filling the view, lit by a quad light."""
    import numpy as np

    from aten_tpu_torch.core.camera import PinholeCamera
    from aten_tpu_torch.scene.materials import MaterialType

    tid = b.add_texture(np.full((4, 4, 3), 0.5, np.float32))
    m = b.add_material(MaterialType.DIFFUSE, base_color=(1, 1, 1), albedo_map=tid)
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(8, 8, 8))
    b.add_quad((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0), m)
    ls, lc = b.add_quad((-1, -1, 3), (-1, 1, 3), (1, 1, 3), (1, -1, 3), emit)
    b.add_area_light_tris(ls, lc, le=(8, 8, 8))
    return PinholeCamera(origin=(0, 0, 2.2), lookat=(0, 0, 0), vfov_deg=60,
                         width=width, height=height)


def populate_point_lit_quad(b, width, height):
    """tests/test_grad.py's light-position setup: a quad under a point light."""
    from aten_tpu_torch.core.camera import PinholeCamera
    from aten_tpu_torch.scene.materials import MaterialType

    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.8, 0.8, 0.8))
    b.add_quad((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0), m)
    b.add_point_light((0.5, 0.5, 2.0), (6, 6, 6))
    return PinholeCamera(origin=(0, 0, 2.5), lookat=(0, 0, 0), vfov_deg=60,
                         width=width, height=height)


def field_grad(populate, spec, depth, device, size=16):
    """d mean(radiance) / d `spec` of tests/test_grad.py's 16x16, 1 spp
    render, RR depth 2, on `device`, as numpy."""
    import torch

    from aten_tpu_torch.integrator.pathtracer import _trace_paths
    from aten_tpu_torch.parallel import mesh
    from aten_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    cam = populate(b, size, size)
    scene = b.build(device)
    leaf = mesh._get_param(scene, spec).clone().requires_grad_(True)
    rad = _trace_paths(mesh._set_params(scene, {spec: leaf}), cam.arrays(device), size, size,
                       0, 0, 1, depth, 2)
    (g,) = torch.autograd.grad(rad.mean(), leaf)
    return g.cpu().numpy()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_phase(card, dev):
    """Phase 13: the toon families and the inverse-rendering train step
    (aten_tpu_torch/parallel/mesh.py).  13a: toon_scene, plain and
    stylized, on the card against the port on this machine's CPU, then
    512x512 x 16 spp timed and profiled; 13b: the reference bench's
    cornell_fwd_bwd config (256x256, spp 4, depth 3, RR depth 2, a black
    target), ms/step, lanes traced, peak memory and a profiled step; 13c:
    the gradients of tests/test_grad.py's setups on the card against the
    CPU, and 20 steps of descent from base_color x 0.5; 13d: the train
    step on the 102,404-prim mesh scene through K1, its loss and
    gradients bitwise those of the plain walk; 13e: render_tiled and a
    step through a one-rank NCCL group, bitwise those without a group."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from aten_tpu_torch.integrator import pathtracer
    from aten_tpu_torch.integrator.pathtracer import _trace_paths, render_sample
    from aten_tpu_torch.ops import traverse_cuda
    from aten_tpu_torch.parallel import mesh
    from aten_tpu_torch.scene.scenedefs import (
        cornell_box, populate_cornell_box, procedural_mesh_scene, toon_scene)

    t13 = time.time()
    # 13a: toon, card against CPU, then the 512x512 render
    for stylized in (False, True):
        imgs = []
        for d in (dev, "cpu"):
            sc, c = toon_scene(64, 64, stylized, device=d)
            imgs.append(pathtracer.render_image(sc, c, spp=4, max_depth=4).cpu().numpy())
        assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.05, stylized
        check_image_bounds(f"phase 13a toon_scene(64, 64, stylized={stylized}) 4spp depth 4, "
                           "card vs CPU", *imgs)
    scene, cam = toon_scene(512, 512, device=dev)
    kw = {"spp": 16, "max_depth": 5, "rr_depth": 3}
    pathtracer.render_image(scene, cam, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.time()
    img = pathtracer.render_image(scene, cam, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    img = img.cpu().numpy()
    assert not any(launches.values()), launches  # 4 prims: the dense test
    assert np.isfinite(img).all() and (img >= 0).all() and img.std() > 0
    log(f"phase 13a toon_scene 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f}, "
        f"wall {wall * 1e3:.1f} ms, {512 * 512 * 16 / wall / 1e6:.3f} Mpaths/s, "
        f"{peak_text(peak, held)}, kernel launches {launches} [{card}]")
    log_profile("phase 13a", card, profile_render(
        lambda: pathtracer.render_image(scene, cam, **kw)))
    del scene, img
    torch.cuda.empty_cache()

    # 13b: bench.py's cornell_fwd_bwd_mrays config
    W = H = 256
    scene, cam = cornell_box(W, H, device=dev)
    ca = cam.arrays(dev)
    target = torch.zeros((H, W, 3), device=dev)
    cfg = {"spp": 4, "max_depth": 3, "rr_depth": 2}
    step = mesh.make_train_step(W, H, **cfg)
    live = [k for k in mesh.TRAINABLE_FIELDS if mesh._has_param(scene, k)]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times, loss = timed_steps(step, scene, ca, target, 5)
    peak = torch.cuda.max_memory_allocated()
    ms = sum(times) / len(times)
    lanes = W * H  # one sample per pixel: the step traces sample 0
    assert np.isfinite(loss) and loss > 0, loss
    log(f"phase 13b cornell_fwd_bwd 256x256 spp 4 depth 3 RR 2, fields {live}: "
        f"{ms:.1f} ms/step (steps {', '.join(f'{x:.1f}' for x in times)}), last loss {loss:.6f}; "
        f"lanes traced per step {lanes} -> {lanes / ms / 1e3:.4f} M traced paths/s; bench.py "
        f"counts W*H*spp = {W * H * 4} -> {W * H * 4 / ms / 1e3:.4f} 'Mrays/s' (4x the lanes "
        f"traced); {peak_text(peak, held)} [{card}]")
    prof = profile_render(lambda: step(scene, ca, target, 1))
    fwd = profile_render(lambda: forward_pass(scene, ca, target, 1, W, H, 4, 3, 2, live))
    log_step_profile("phase 13b", card, prof, fwd[1])

    # 13e: a one-rank NCCL group gives what no group gives, bit for bit
    torch.cuda.set_device(dev)
    group = mesh.distributed_init(f"tcp://127.0.0.1:{free_port()}", 1, 0, "nccl")
    try:
        a = mesh.render_tiled(scene, ca, W, H, 0, 0, group=group, **cfg)
        b = mesh.render_tiled(scene, ca, W, H, 0, 0, group=None, **cfg)
        lg, sg = mesh.make_train_step(W, H, group=group, **cfg)(scene, ca, target, 0)
        ln, sn = step(scene, ca, target, 0)
        same = torch.equal(a, b) and torch.equal(lg, ln) and all(
            torch.equal(mesh._get_param(sg, k), mesh._get_param(sn, k)) for k in live)
        gloo = dist.new_group([0], backend="gloo")
        try:
            mesh.render_tiled(scene, ca, W, H, 0, 0, group=gloo, **cfg)
            refused = False
        except ValueError:
            refused = True
    finally:
        dist.destroy_process_group()
    log(f"phase 13e one-rank NCCL group: render_tiled and a train step bitwise equal to no "
        f"group: {same}; a gloo group refused for CUDA tensors: {refused}")
    assert same and refused
    del scene, target
    torch.cuda.empty_cache()

    # 13c: gradients on the card against the CPU, then a descent
    for name, populate, spec, depth in (
            ("cornell base_color", populate_cornell_box, "base_color", 3),
            ("cornell lights.le", populate_cornell_box, "lights.le", 3),
            ("textured quad tex_stack", populate_textured_quad, "textures.tex_stack", 2),
            ("point-lit quad lights.pos", populate_point_lit_quad, "lights.pos", 2)):
        gd, gc = (field_grad(populate, spec, depth, d) for d in (dev, "cpu"))
        rel = np.abs(gd - gc) / np.maximum(np.abs(gc), 1e-12)
        log(f"phase 13c grad {name}: max |card - CPU| {np.abs(gd - gc).max():.3e}, max rel "
            f"{rel[np.abs(gc) > 1e-6].max() if (np.abs(gc) > 1e-6).any() else 0.0:.3e}, "
            f"max |grad| {np.abs(gc).max():.4f}")
        assert np.abs(gc).max() > 1e-3, name
        np.testing.assert_allclose(gd, gc, rtol=1e-4, atol=1e-6, err_msg=name)
    S = 64
    scene, cam = cornell_box(S, S, device=dev)
    ca = cam.arrays(dev)
    target = render_sample(scene, ca, S, S, 0, 0, 1, 2, 1)
    s = mesh._set_params(scene, {"base_color": scene["materials"]["base_color"] * 0.5})
    step = mesh.make_train_step(S, S, spp=1, max_depth=2, rr_depth=1, lr=0.1)
    losses = []
    for _ in range(20):
        loss, s = step(s, ca, target, 0)
        losses.append(float(loss))
    log(f"phase 13c descent from base_color x 0.5, cornell 64x64, 20 steps at lr 0.1: loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} ({losses[-1] / losses[0]:.4f} of the first)")
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0], losses

    # 13d: the train step on the 102,404-prim mesh, through K1
    W = H = 512
    t = time.time()
    scene, cam = procedural_mesh_scene(W, H, device=dev)
    ca = cam.arrays(dev)
    assert scene["num_tris"] + scene["num_spheres"] == 102404
    target = render_sample(scene, ca, W, H, 0, 0, 1, 3, 2)
    scene = mesh._set_params(scene, {"base_color": scene["materials"]["base_color"] * 0.5})
    log(f"phase 13d: mesh scene and its 1-spp target in {time.time() - t:.1f} s")
    step = mesh.make_train_step(W, H, **cfg)
    live = [k for k in mesh.TRAINABLE_FIELDS if mesh._has_param(scene, k)]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times, _ = timed_steps(step, scene, ca, target, 3)
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    prof = profile_render(lambda: step(scene, ca, target, 0))
    launches = read_counts()
    log(f"phase 13d mesh train step 512x512 spp 4 depth 3 RR 2, fields {live}: "
        f"{sum(times) / len(times):.1f} ms/step (steps {', '.join(f'{x:.1f}' for x in times)}), "
        f"{peak_text(peak, held)}; launches in the profiled step {launches} "
        f"[{card}]")
    assert [launches[k] for k in traverse_cuda.KERNELS] == [3, 3], launches
    fwd = profile_render(lambda: forward_pass(scene, ca, target, 0, W, H, 4, 3, 2, live))
    log_step_profile("phase 13d", card, prof, fwd[1])
    # the same loss and gradients through the plain walk
    loss_s, new_s = step(scene, ca, target, 0)
    loss_k, grads_k = mesh.band_loss_and_grads(scene, ca, target, 0, W, H, 4, 3, 2)
    params = {k: mesh._get_param(scene, k).detach().requires_grad_(True) for k in live}
    rad = _trace_paths(mesh._set_params(scene, params), ca, W, H, 0, 0, 4, 3, 2, impl="plain")
    loss_p = torch.mean((rad.reshape(H, W, 3) - target) ** 2)
    grads_p = dict(zip(live, torch.autograd.grad(loss_p, [params[k] for k in live])))
    new_p = mesh.rms_update(scene, grads_p, 0.05)
    same = (torch.equal(loss_s, loss_p.detach()) and torch.equal(loss_k, loss_p.detach())
            and all(torch.equal(grads_k[k], grads_p[k]) for k in live)
            and all(torch.equal(mesh._get_param(new_s, k), mesh._get_param(new_p, k))
                    for k in live))
    log(f"phase 13d loss {float(loss_s):.6f}; the step's loss, gradients and new fields bitwise "
        f"those of the plain walk: {same}; max |grad| "
        f"{', '.join(f'{k} {float(g.abs().max()):.4e}' for k, g in grads_p.items())}")
    assert same and np.isfinite(float(loss_s))
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads_p.values())
    del scene, target, rad, params, grads_p, grads_k
    torch.cuda.empty_cache()
    log(f"phase 13 took {time.time() - t13:.1f} s")


# Phase 19's skinned knot: procedural_mesh_scene's knot bound to a chain
# of KNOT_JOINTS joints along its parameter u, at most 4 joints a vertex,
# and a clip of KNOT_KEYS keys that bends the chain, sampled at
# KNOT_FRAMES frames
KNOT_JOINTS = 8
KNOT_KEYS = 8
KNOT_FRAMES = 8
KNOT_BEND = 0.12  # radians a joint at the clip's peak


def knot_rig(n_u=400, n_v=128, n_joints=KNOT_JOINTS, n_keys=KNOT_KEYS):
    """The skinned knot's data as numpy (no torch): the knot's pos, nml,
    faces (scenedefs.torus_knot_mesh), LBS weights and joints [V, 4] from
    the vertices' ring index, the chain's parents and local bind TRS
    (joint k at the knot curve's point at u = (k + 0.5) / n_joints), and
    the clip's tracks (each joint turning about its own seeded axis)."""
    import numpy as np

    from aten_tpu_torch.scene.scenedefs import torus_knot_mesh

    pos, nml, _, faces = torus_knot_mesh(n_u, n_v)
    u = (np.arange(pos.shape[0]) // n_v) / n_u
    centre = (np.arange(n_joints) + 0.5) / n_joints
    w = np.clip(1.0 - np.abs(u[:, None] - centre[None, :]) * n_joints / 2.0, 0.0, None) ** 2
    joints = np.argsort(-w, axis=1, kind="stable")[:, :4]
    weights = np.take_along_axis(w, joints, axis=1)
    weights = (weights / weights.sum(1, keepdims=True)).astype(np.float32)
    ring = pos.reshape(n_u, n_v, 3).mean(1)  # the tube's centre line
    anchor = ring[np.minimum((centre * n_u).astype(np.int64), n_u - 1)]
    bind_t = np.diff(anchor, axis=0, prepend=np.zeros((1, 3), np.float32)).astype(np.float32)
    idq = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (n_joints, 1))
    rng = np.random.default_rng(SEED)
    axes = rng.standard_normal((n_joints, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    times = np.linspace(0.0, 1.0, n_keys, dtype=np.float32)
    tracks = []
    for k in range(n_joints):
        a = KNOT_BEND * np.sin(2.0 * np.pi * times + 0.7 * k)
        rot = np.concatenate([axes[k][None] * np.sin(a / 2)[:, None], np.cos(a / 2)[:, None]], 1)
        tracks.append({"times": times, "trans": np.tile(bind_t[k], (n_keys, 1)),
                       "rot": rot.astype(np.float32), "scale": np.ones((n_keys, 3), np.float32)})
    return {"pos": pos, "nml": nml, "faces": faces, "weights": weights,
            "joints": joints.astype(np.int32), "parents": tuple(range(-1, n_joints - 1)),
            "bind_t": bind_t, "bind_q": idq, "bind_s": np.ones((n_joints, 3), np.float32),
            "tracks": tracks}


def populate_skinned_knot(b, attach, rig, width, height):
    """procedural_mesh_scene's scene with its knot attached as the
    deformable mesh of `rig` (knot_rig) by `attach` (a package's
    DeformableMesh.attach; b is that package's builder), so the prims are
    those of populate_procedural_mesh_scene.  Returns (the mesh handle,
    the camera)."""
    from aten_tpu_torch.core.camera import PinholeCamera
    from aten_tpu_torch.scene.materials import MaterialType

    gold = b.add_material(MaterialType.GGX, base_color=(0.95, 0.75, 0.35), roughness=0.25,
                          ior=2.5)
    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(26.0, 25.0, 23.0))
    dm = attach(b, rig["pos"], rig["faces"], gold, rig["weights"], rig["joints"], nml=rig["nml"])
    ext = 30.0
    b.add_quad([-ext, -0.6, ext], [ext, -0.6, ext], [ext, -0.6, -ext], [-ext, -0.6, -ext], floor)
    ls, lc = b.add_quad([-4, 14, 4], [-4, 14, -4], [4, 14, -4], [4, 14, 4], emit)
    b.add_area_light_tris(ls, lc, le=(26.0, 25.0, 23.0))
    b.set_background((0.12, 0.14, 0.18))
    return dm, PinholeCamera(origin=(0.0, 4.0, 14.0), lookat=(0.0, 1.5, 0.0), vfov_deg=40.0,
                             width=width, height=height)


# Phase 19's sizes: the knot's rings and ring vertices (102,400 triangles,
# 51,200 vertices), large_mesh_scene's knot (512,000 triangles) and the
# image side of the 19a and 19b renders
KNOT_UV = (400, 128)
LARGE_UV = (1000, 256)
RES19 = 512
# Phase 19's renders: bench.py's real-time frame (512x512, 1 spp, depth 5,
# RR 3) for the posed frames, the main path's (16 spp) for one frame and
# the OBJ scene; the instanced .glb at 256x256 x 4 spp; the renders held
# bitwise against the plain walks at 64x64
RT_FRAME = {"spp": 1, "max_depth": 5, "rr_depth": 3}
MAIN_KW = {"spp": 16, "max_depth": 5, "rr_depth": 3}
GLB_KW = {"spp": 4, "max_depth": 5, "rr_depth": 3}
SMALL19 = 64
SMALL19_KW = {"spp": 2, "max_depth": 3, "rr_depth": 2}
# the .glb's four nodes: (translation, rotation about y, uniform scale)
GLB_NODES = (((-3.2, 1.0, -1.0), 0.3, 0.55), ((3.2, 1.0, -1.0), -0.5, 0.55),
             ((-1.6, 0.4, 3.0), 1.1, 0.4), ((1.6, 0.4, 3.0), 2.0, 0.4))


def count_syncs(fn):
    """(fn(), the host syncs it made): torch's sync debug mode warns at
    every synchronizing CUDA call it detects (a device-to-host copy,
    .item(), a boolean mask, nonzero, a pageable host-to-device copy),
    and those warnings are counted (not the mode's own notice that it is
    a prototype)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if where:
        log(f"host syncs at {where}")
    return out, len(where)


def bits_equal(a, b):
    """Two tensors equal bit for bit (K1's records hold int words)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = (x.contiguous().reshape(-1).view(torch.uint8).cpu() for x in (a, b))
    return bool(torch.equal(a, b))


def scene_arrays_equal(name, a, b):
    """Every tensor (nested tables too) and static of two scenes equal
    bit for bit; raises naming the first that differs."""
    import torch

    def flat(arrays, prefix=""):
        for k, v in arrays.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, v

    fa, fb = dict(flat(a.arrays)), dict(flat(b.arrays))
    assert sorted(fa) == sorted(fb), (name, sorted(set(fa) ^ set(fb)))
    bad = [k for k in fa if not (torch.is_tensor(fa[k]) and bits_equal(fa[k], fb[k]))]
    assert not bad and a.static == b.static, (name, bad[:5])
    return len(fa)


def phase19(card, dev):
    """Phase 19: scene files and skinned animation.  19a: the skinned
    knot (knot_rig on procedural_mesh_scene's 102,404 prims: 51,200
    vertices and 102,400 triangles on a chain of 8 joints), 8 frames of
    its 8-key clip, each the pose step (skinning_palette, apply_pose:
    skin, normals, the LBVH and K1's preorder records on the card; CUDA
    events, host syncs counted: 0 allowed) and render_sample at bench.py's
    real-time shape through K1; one frame's LBVH arrays and K1 records
    bitwise the port's build on this machine's CPU from the card's skinned
    vertices (Morton codes compared first); K1 on 4,194,304 camera and
    bounce rays of that frame bitwise the oracle walk over the LBVH's own
    arrays; its 64x64 render through K1 bitwise the plain walk's; the
    frame at the main path's shape (512x512 x 16 spp) timed, with its
    peak and a profile (K1 5 + 5); and K1 on the bind pose's LBVH against
    K1 on its SAH tree on the same rays, in turns, with bound().  19b: the
    knot scene written as OBJ + MTL, a sky as .hdr and one knot under 4
    instancing nodes as .glb; each loaded and built on the card and on
    this machine's CPU, arrays equal; the OBJ scene under the .hdr at
    512x512 x 16 spp through K1; the .glb at 256x256 x 4 spp through K5
    and at 64x64 bitwise K5's plain version.  19c: large_mesh_scene's
    512,004 prims built, then built from a bvh_cache .npz of that build:
    both set-up times, every array equal."""
    import shutil

    t19 = time.time()
    out_dir = os.path.join(ROOT, "build", "phase19")
    os.makedirs(out_dir, exist_ok=True)
    try:
        skinned_frames(card, dev)
        t = phase_clock("19a", t19)
        scene_files(card, dev, out_dir)
        t = phase_clock("19b", t)
        bvh_cache_builds(card, dev, out_dir)
        phase_clock("19c", t)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"phase 19 took {time.time() - t19:.1f} s (budget 45 s) [{card}]")


def skinned_knot(dev, width, height, n_u, n_v):
    """(scene on dev, camera, the mesh, skeleton, clip and inverse bind on
    dev) of the skinned knot."""
    import torch

    from aten_tpu_torch.anim.animation import AnimationClip
    from aten_tpu_torch.anim.skeleton import Skeleton
    from aten_tpu_torch.anim.skinning import DeformableMesh
    from aten_tpu_torch.scene.scene import SceneBuilder

    rig = knot_rig(n_u, n_v)
    b = SceneBuilder()
    dm, cam = populate_skinned_knot(b, DeformableMesh.attach, rig, width, height)
    skel = Skeleton(rig["parents"], rig["bind_t"], rig["bind_q"], rig["bind_s"])
    clip = AnimationClip.from_tracks(rig["tracks"])
    inv = torch.from_numpy(skel.inverse_bind()).to(dev)
    return b.build(dev), cam, dm.to(dev), skel, clip.to(dev), inv


def pose_step(scene, dm, skel, clip, inv, t):
    """The per-frame chain: the clip at t, the palette, the skinned and
    rebuilt scene."""
    from aten_tpu_torch.anim.skeleton import skinning_palette
    from aten_tpu_torch.anim.skinning import apply_pose

    return apply_pose(scene, dm, skinning_palette(skel, *clip.sample(t), inv))


def skinned_frames(card, dev):
    """Phase 19a (see phase19)."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel import lbvh
    from aten_tpu_torch.accel.traverse import traverse
    from aten_tpu_torch.integrator.pathtracer import render_image, render_sample
    from aten_tpu_torch.ops import bvh_layout, traverse_cuda
    from aten_tpu_torch.scene.scene import BVH_KEYS, Scene

    t = t19a = time.time()
    scene, cam, dm, skel, clip, inv = skinned_knot(dev, RES19, RES19, *KNOT_UV)
    W, H, ca = cam.width, cam.height, cam.arrays(dev)
    n_prims = scene["num_tris"] + scene["num_spheres"]
    n_knot = 2 * KNOT_UV[0] * KNOT_UV[1]
    assert n_prims == n_knot + 4 and dm.faces.shape[0] == n_knot
    assert dm.bind_pos.shape[0] == n_knot // 2
    log(f"phase 19a skinned knot: {n_prims} prims, {dm.bind_pos.shape[0]} skinned vertices, "
        f"{skel.num_joints} joints, {clip.times.shape[1]} keys; built in {time.time() - t:.1f} s")
    closest, any_hit = traverse_cuda.KERNELS

    duration = clip.duration  # a host read of the clip's keys, outside the pose step

    def frame_t(i):
        return duration * i / KNOT_FRAMES

    posed = pose_step(scene, dm, skel, clip, inv, 0.0)  # warm-up: the level index, the sort
    render_sample(posed, ca, W, H, 0, 0, **RT_FRAME)
    rows, start, stop = [], torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    for i in range(KNOT_FRAMES):
        torch.cuda.synchronize()
        start.record()
        posed, syncs = count_syncs(lambda: pose_step(scene, dm, skel, clip, inv, frame_t(i)))
        stop.record()
        torch.cuda.synchronize()
        pose_ms = start.elapsed_time(stop)
        reset_counts()
        img, render_ms = timed_ms(lambda: render_sample(posed, ca, W, H, i, 0, **RT_FRAME))
        got = only_kernels(read_counts(), traverse_cuda.KERNELS, f"phase 19a frame {i} render")
        assert syncs == 0, (i, syncs)
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3, i
        rows.append((pose_ms, render_ms, got[closest], got[any_hit]))
    pose_ms, render_ms = [r[0] for r in rows], [r[1] for r in rows]
    log(f"phase 19a {KNOT_FRAMES} frames, pose step (clip, palette, skin, normals, LBVH, K1 "
        f"records; 0 host syncs each) {', '.join(f'{x:.2f}' for x in pose_ms)} ms, mean "
        f"{np.mean(pose_ms):.2f}; render_sample {W}x{H} 1 spp depth 5 RR 3 through K1 "
        f"{', '.join(f'{x:.1f}' for x in render_ms)} ms, mean {np.mean(render_ms):.1f}; K1 "
        f"launches a frame {sorted({(r[2], r[3]) for r in rows})} [{card}]")
    last_t = frame_t(KNOT_FRAMES - 1)
    moved = float((posed["tri_v0"][:n_knot] - scene["tri_v0"][:n_knot]).abs().max())
    log(f"phase 19a the knot's vertices move up to {moved:.3f} from the bind pose (t={last_t:.3f})")
    assert moved > 0.05, moved

    # the card's LBVH and records against the port's build on this
    # machine's CPU from the same skinned triangles: codes first
    t = time.time()
    cpu = Scene(to_cpu(posed.arrays), posed.static, torch.device("cpu"))
    nt = scene["num_tris"]
    boxes = [lbvh.tri_boxes(s["tri_v0"][:nt], s["tri_e1"][:nt], s["tri_e2"][:nt])
             for s in (posed, cpu)]
    codes = [lbvh.morton3d((bmin + bmax) * 0.5, torch.amin(bmin, 0), torch.amax(bmax, 0))
             for bmin, bmax in boxes]
    n_codes = int((codes[0].cpu() != codes[1]).sum())
    ref = lbvh.rebuild_scene_bvh(cpu)
    same = {k: bits_equal(posed[k], ref[k]) for k in BVH_KEYS + bvh_layout.ARRAY_KEYS}
    log(f"phase 19a LBVH on the card against the port on this machine's CPU (the same "
        f"{nt} skinned triangles): {n_codes} of {nt} Morton codes differ; arrays bitwise "
        f"equal {same}; the CPU build took {time.time() - t:.1f} s")
    assert n_codes == 0 and all(same.values()), (n_codes, same)
    del cpu, ref
    t_part = phase_clock("19a's frames and the CPU build", t19a)

    # K1 on the rebuilt tree against the oracle walk over the LBVH's arrays
    rng = np.random.default_rng(SEED + 19)
    n_main = W * H * 16
    cro, crd = camera_rays(cam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = first_hit_rays(posed, cro, crd, n_main - cro.shape[0], rng)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    del cro, crd, sro, srd
    reset_counts()
    _, _, work_lbvh, _, _ = compare_traversal("phase 19a posed frame, K1 on the LBVH records",
                                              posed, ro, rd, dist, exact=True)
    assert nonzero(read_counts()) == {closest: 1, any_hit: 1}, read_counts()
    del ro, rd, dist
    t_part = phase_clock("19a's K1 against the oracle walk", t_part)
    # the render through K1 against the same render through the plain walk
    small = dataclasses.replace(cam, width=SMALL19, height=SMALL19)
    reset_counts()
    ik = render_image(posed, small, **SMALL19_KW)
    assert read_counts()[closest] > 0, read_counts()
    ip = render_image(posed, small, impl="plain", **SMALL19_KW)
    same = bool(torch.equal(ik, ip))
    log(f"phase 19a {SMALL19}x{SMALL19} {SMALL19_KW['spp']} spp depth {SMALL19_KW['max_depth']} "
        f"render of the posed frame: K1 bitwise the plain walk's {same}")
    assert same
    # the frame at the main path's shape
    render_image(posed, cam, **MAIN_KW)  # warm-up
    img, wall, launches, peak, held = timed_render(lambda: render_image(posed, cam, **MAIN_KW))
    got = only_kernels(launches, traverse_cuda.KERNELS, "phase 19a 16 spp render")
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3, img.mean()
    log(f"phase 19a posed frame {W}x{H} 16 spp depth 5 RR 3 through K1: wall {wall * 1e3:.1f} "
        f"ms, {W * H * 16 / wall / 1e6:.3f} Mpaths/s, mean {img.mean():.5f}, launches {got}, "
        f"{peak_text(peak, held)} [{card}]")
    reset_counts()
    log_profile("phase 19a", card, profile_render(lambda: render_image(posed, cam, **MAIN_KW)))
    prof = nonzero(read_counts())
    log(f"phase 19a profiled render's K1 launches {prof} (expected 5 + 5)")
    assert prof == {closest: 5, any_hit: 5}, prof
    del posed
    t_part = phase_clock("19a's renders", t_part)

    # K1 on the bind pose's LBVH against K1 on its SAH tree, same rays
    bind_lbvh = lbvh.rebuild_scene_bvh(scene)
    cro, crd = camera_rays(cam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = first_hit_rays(scene, cro, crd, n_main - cro.shape[0], rng)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    del cro, crd, sro, srd
    t0 = torch.full((n_main,), 3.4e38, dtype=torch.float32, device=dev)
    trees = {"SAH": scene, "LBVH": bind_lbvh}
    ms = {k: [] for k in trees}
    for name in ("SAH", "LBVH", "LBVH", "SAH"):
        ms[name].append(cuda_ms(lambda: traverse_cuda.bvh_traverse(trees[name], ro, rd, t0),
                                reps=10))
    hits = {k: traverse(v, ro, rd, impl="cuda")["prim"] for k, v in trees.items()}
    agree = float((hits["SAH"] == hits["LBVH"]).float().mean())
    line = []
    for name, sc in trees.items():
        _, work = plain_walk(sc, ro, rd)
        b = bound(n_main, 16, array_bytes(sc, BVH_ARRAYS), work)
        line.append(f"{name} {ms[name][0]:.3f}, {ms[name][1]:.3f} ms (work {work}; bound "
                    f"{b[0]:.4f} ms by {b[1]}, {np.mean(ms[name]) / b[0]:.1f}x)")
    ratio = np.mean(ms["LBVH"]) / np.mean(ms["SAH"])
    log(f"phase 19a K1 closest-hit on {n_main} camera and bounce rays of the bind pose, in "
        f"turns: {'; '.join(line)}; LBVH / SAH {ratio:.3f}; prims agree on {agree:.6f} [{card}]")
    assert agree >= PRIM_AGREE, agree
    del bind_lbvh, trees, ro, rd, t0, scene
    torch.cuda.empty_cache()
    phase_clock("19a's LBVH against SAH", t_part)


def write_glb(path, pos, nml, faces, nodes):
    """A .glb of one mesh (float32 positions and normals, uint32 indices,
    a gold material) under one node per (translation, rotation about y,
    scale) of `nodes`."""
    import numpy as np

    idx = np.ascontiguousarray(faces, np.uint32).reshape(-1)
    parts = [np.ascontiguousarray(pos, np.float32), np.ascontiguousarray(nml, np.float32), idx]
    offs = np.cumsum([0] + [a.nbytes for a in parts])
    buf = b"".join(a.tobytes() for a in parts)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": [{"mesh": 0, "translation": list(tr), "scale": [s, s, s],
                   "rotation": [0.0, float(np.sin(a / 2)), 0.0, float(np.cos(a / 2))]}
                  for tr, a, s in nodes],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2,
                                    "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.95, 0.75, 0.35, 1.0],
                                                "metallicFactor": 1.0, "roughnessFactor": 0.3}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": len(nml), "type": "VEC3"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx), "type": "SCALAR"},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": int(offs[i]), "byteLength": int(a.nbytes)}
                        for i, a in enumerate(parts)],
        "buffers": [{"byteLength": len(buf)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    buf += b"\0" * (-len(buf) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(buf)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(buf), 0x004E4942) + buf)


def add_floor_and_light(b):
    """procedural_mesh_scene's grey floor and quad area light, as world
    geometry."""
    from aten_tpu_torch.scene.materials import MaterialType

    floor = b.add_material(MaterialType.DIFFUSE, base_color=(0.55, 0.55, 0.55))
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(26.0, 25.0, 23.0))
    ext = 30.0
    b.add_quad([-ext, -0.6, ext], [ext, -0.6, ext], [ext, -0.6, -ext], [-ext, -0.6, -ext], floor)
    ls, lc = b.add_quad([-4, 14, 4], [-4, 14, -4], [4, 14, -4], [4, 14, 4], emit)
    b.add_area_light_tris(ls, lc, le=(26.0, 25.0, 23.0))


def write_knot_obj(out_dir, res):
    """procedural_mesh_scene's knot scene (102,404 prims: the knot, its
    floor and light quads) as knot.obj + knot.mtl in out_dir: (the .obj's
    path, the scene's camera at res x res)."""
    import numpy as np

    from aten_tpu_torch.io.obj_writer import write_mtl, write_obj
    from aten_tpu_torch.scene.scene import SceneBuilder
    from aten_tpu_torch.scene.scenedefs import populate_procedural_mesh_scene, torus_knot_mesh

    src = SceneBuilder()
    cam = populate_procedural_mesh_scene(src, res, res, *KNOT_UV)
    corners, face_mtl = src._positions()[src._face_array()[:, :3]], src._face_array()[:, 3]
    n_knot = 2 * KNOT_UV[0] * KNOT_UV[1]
    names = ["gold", "floor", "light"]
    obj_path, mtl_path = (os.path.join(out_dir, f"knot.{e}") for e in ("obj", "mtl"))
    pos, _, _, faces = torus_knot_mesh(*KNOT_UV)
    # the knot indexed, the floor's and the light's quads as corner triangles
    quad = corners[n_knot:].reshape(-1, 3)
    all_pos = np.concatenate([pos, quad])
    all_faces = np.concatenate([faces, len(pos) + np.arange(quad.shape[0]).reshape(-1, 3)])
    write_mtl(mtl_path, src.materials, names=names)
    write_obj(obj_path, all_pos, all_faces, face_mtl=face_mtl, mtl_names=names,
              mtl_path=mtl_path)
    return obj_path, cam


def scene_files(card, dev, out_dir):
    """Phase 19b (see phase19)."""
    import numpy as np
    import torch

    from aten_tpu_torch.integrator.pathtracer import render_image
    from aten_tpu_torch.io.gltf import load_gltf
    from aten_tpu_torch.io.hdr import read_hdr, write_hdr
    from aten_tpu_torch.io.image import load_image
    from aten_tpu_torch.ops import tlas_cuda, traverse_cuda
    from aten_tpu_torch.scene.materials import MaterialType
    from aten_tpu_torch.scene.objloader import _mtl_to_material, load_obj
    from aten_tpu_torch.scene.scene import SceneBuilder
    from aten_tpu_torch.scene.scenedefs import sky_envmap, torus_knot_mesh

    t = time.time()
    obj_path, cam = write_knot_obj(out_dir, RES19)
    n_knot = 2 * KNOT_UV[0] * KNOT_UV[1]
    nt = n_knot + 4
    pos, nml, _, faces = torus_knot_mesh(*KNOT_UV)
    hdr_path = os.path.join(out_dir, "sky.hdr")
    write_hdr(hdr_path, sky_envmap(64, 128))
    glb_path = os.path.join(out_dir, "knots.glb")
    write_glb(glb_path, pos - np.asarray([0.0, 1.7, 0.0], np.float32), nml, faces, GLB_NODES)
    log(f"phase 19b wrote {obj_path} ({os.path.getsize(obj_path)} B), its .mtl, "
        f"{hdr_path} ({os.path.getsize(hdr_path)} B) and {glb_path} "
        f"({os.path.getsize(glb_path)} B) in {time.time() - t:.1f} s")

    # the OBJ scene under the .hdr sky, built on the card and on the CPU
    t = time.time()
    b = SceneBuilder()
    le = (26.0, 25.0, 23.0)

    def override(name, mtl):
        if name == "light":
            return b.add_material(MaterialType.EMISSIVE, base_color=le)
        if name == "gold":
            return b.add_material(MaterialType.GGX, base_color=mtl["kd"], roughness=0.25,
                                  ior=mtl["ni"])
        return _mtl_to_material(b, mtl)

    groups = load_obj(b, obj_path, mtl_override=override)
    b.add_area_light_tris(*groups["light"], le=le)
    b.set_envmap(load_image(hdr_path))
    t_load = time.time() - t
    obj_scene, obj_cpu = b.build(dev), b.build("cpu")
    n = scene_arrays_equal("phase 19b OBJ scene", obj_scene, obj_cpu)
    assert obj_scene["num_tris"] == nt, obj_scene.static
    assert np.array_equal(obj_cpu["envmap"].numpy(), read_hdr(hdr_path))
    log(f"phase 19b OBJ scene: {obj_scene['num_tris']} triangles in groups "
        f"{ {k: v[1] for k, v in groups.items()} }, loaded in {t_load:.1f} s; built on the card "
        f"and on this machine's CPU: {n} arrays bitwise equal")
    del obj_cpu
    render_image(obj_scene, cam, **MAIN_KW)  # warm-up
    img, wall, launches, peak, held = timed_render(lambda: render_image(obj_scene, cam, **MAIN_KW))
    got = only_kernels(launches, traverse_cuda.KERNELS, "phase 19b OBJ render")
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3, img.mean()
    log(f"phase 19b OBJ scene under the .hdr sky {cam.width}x{cam.height} 16 spp depth 5 RR 3 "
        f"through K1: wall {wall * 1e3:.1f} ms, {cam.width * cam.height * 16 / wall / 1e6:.3f} "
        f"Mpaths/s, mean {img.mean():.5f}, "
        f"launches {got}, {peak_text(peak, held)} [{card}]")
    del obj_scene

    # the instanced .glb: one knot object under 4 nodes, floor and light
    t = time.time()
    b = SceneBuilder()
    prims = load_gltf(b, glb_path, instanced=True)
    add_floor_and_light(b)
    b.set_background((0.12, 0.14, 0.18))
    glb_scene, glb_cpu = b.build(dev), b.build("cpu")
    n = scene_arrays_equal("phase 19b .glb scene", glb_scene, glb_cpu)
    assert glb_scene["num_instances"] == len(GLB_NODES) + 1
    log(f"phase 19b .glb scene: {glb_scene['num_instances']} instances (4 knots and the world), "
        f"{glb_scene['num_tris']} triangles, loaded and built in {time.time() - t:.1f} s; on the "
        f"card and on this machine's CPU: {n} arrays bitwise equal")
    assert prims == [(0, n_knot)], prims
    del glb_cpu
    gcam = dataclasses.replace(cam, width=RES19 // 2, height=RES19 // 2)
    render_image(glb_scene, gcam, **GLB_KW)  # warm-up
    img, wall, launches, peak, held = timed_render(
        lambda: render_image(glb_scene, gcam, **GLB_KW))
    got = only_kernels(launches, tlas_cuda.KERNELS, "phase 19b .glb render")
    img = img.cpu().numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3, img.mean()
    log(f"phase 19b .glb scene {gcam.width}x{gcam.height} 4 spp depth 5 RR 3 through K5: wall "
        f"{wall * 1e3:.1f} ms, {gcam.width * gcam.height * 4 / wall / 1e6:.3f} Mpaths/s, mean {img.mean():.5f}, launches {got}, "
        f"{peak_text(peak, held)} [{card}]")
    small = dataclasses.replace(cam, width=SMALL19, height=SMALL19)
    ik = render_image(glb_scene, small, **SMALL19_KW)
    ip = render_image(glb_scene, small, impl="plain", **SMALL19_KW)
    same = bool(torch.equal(ik, ip))
    log(f"phase 19b .glb {SMALL19}x{SMALL19} render through K5 bitwise its plain version's {same}")
    assert same
    del glb_scene
    torch.cuda.empty_cache()


def bvh_cache_builds(card, dev, out_dir):
    """Phase 19c (see phase19)."""
    import torch

    from aten_tpu_torch.scene.scene import SceneBuilder, save_bvh_cache
    from aten_tpu_torch.scene.scenedefs import populate_procedural_mesh_scene

    cache = os.path.join(out_dir, "large_mesh_bvh.npz")
    built = {}
    b = SceneBuilder()
    populate_procedural_mesh_scene(b, RES19, RES19, *LARGE_UV)
    for name, kw in (("built", {}), ("from the cache", {"bvh_cache": cache})):
        t = time.time()
        built[name] = b.build(dev, **kw)
        torch.cuda.synchronize()
        built[name, "s"] = time.time() - t
        if name == "built":
            save_bvh_cache(built[name], cache)
    a, c = built["built"], built["from the cache"]
    n = scene_arrays_equal("phase 19c", a, c)
    assert a["num_tris"] == 2 * LARGE_UV[0] * LARGE_UV[1] + 4, a.static
    assert a.get("traversal") == c.get("traversal"), (a.static, c.static)
    log(f"phase 19c large_mesh_scene ({a['num_tris']} prims, traversal {a.get('traversal')!r}): "
        f"set-up {built['built', 's']:.2f} s building its BVH, {built['from the cache', 's']:.2f} s "
        f"from the cache ({os.path.getsize(cache)} B); {n} arrays bitwise equal [{card}]")
    del built, a, c
    torch.cuda.empty_cache()


# -- phase 20: the CLI, SBVH, frustum culling, compaction, dispatch, entry()
P20_RES = 512
CLI_SPP = 16
CLI_SMALL, CLI_SMALL_SPP = 64, 2
SLIVERS = 65536
SBVH_SUBSAMPLES = 16           # 512x512 x 16 = 4,194,304 camera rays
SBVH_TURNS, SBVH_REPS = 3, 5
PLAIN20 = 256                  # 20b's plain-version check: 256x256 pixel centres (knot)
COMPACT_N = 1 << 22
ZOO_KW = {"spp": 8, "max_depth": 5, "rr_depth": 3}

CHILD_PARTITION = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np, torch
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene.scenedefs import material_test_scene, sky_envmap
from aten_tpu_torch.shading import dispatch
scene, cam = material_test_scene({res}, {res}, envmap=sky_envmap(), device="cuda")
torch.cuda.synchronize()
sys.stdin.readline()  # the parent's go, once its own renders are done
kw = {kw!r}
render_image(scene, cam, **kw)  # warm-up
torch.cuda.synchronize()
calls = []
real = dispatch._dispatch
dispatch._dispatch = lambda *a: calls.append(1) or real(*a)
t = time.time()
img = render_image(scene, cam, **kw)
torch.cuda.synchronize()
wall = time.time() - t
np.save({out!r}, img.cpu().numpy())
print(json.dumps({{"partition": dispatch._ENV_PARTITION, "wall_ms": wall * 1e3,
                  "partitioned_calls": len(calls)}}))
"""


def sliver_triangles(n, seed):
    """[n, 3, 3] float32: n/2 long slivers along x and n/2 small triangles,
    tests/test_sbvh.py's sliver generator vectorized, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h = n // 2
    y, z = rng.uniform(-3, 3, (2, h))
    x0 = rng.uniform(-5, 0, h)
    l1, l2 = rng.uniform(4, 8, h), rng.uniform(2, 4, h)
    sl = np.stack([np.stack([x0, y, z], -1), np.stack([x0 + l1, y + 0.05, z], -1),
                   np.stack([x0 + l2, y, z + 0.05], -1)], 1)
    small = rng.uniform(-4, 4, (n - h, 1, 3)) + rng.uniform(-0.2, 0.2, (n - h, 3, 3))
    return np.concatenate([sl, small]).astype(np.float32)


def phase20(card, dev):
    """Phase 20: the last modules.  20a: aten_tpu_torch.cli.render on the
    102,404-prim knot written as OBJ, 512x512 x 16 spp with --stats and a
    checkpoint, then again resuming it; the resumed film bitwise the same
    32 render_sample calls accumulated here; K1 5 + 0 launches a sample
    (the CLI's OBJ scene has no light table entry, so no shadow ray);
    the 64x64 CLI render on the card against the same call with --device
    cpu.  20b: cli.bvh_builder --spatial-splits on the knot OBJ and on
    65,536 slivers (sliver_triangles), each SBVH put on its scene with
    Scene.replace (K1's records attached); K1 on 4,194,304 camera rays on
    the SBVH against K1 on the SAH tree (hits; prims, but for ties at an
    edge two triangles share; t within 1e-5), on the knot's SBVH bitwise
    its plain version on the 256x256 pixel centres, and timed in turns
    with the SAH tree's,
    the bound from its kStats counts.  20c:
    visible_prims on the knot from its camera, the card's masks the
    CPU's, every prim K1 hits through the 512x512 pixel centres inside.
    20d: compact and scatter_back on 4,194,304 lanes bitwise the CPU's.
    20e: zoo+IBL
    at 512x512 x 8 spp with the partitioned dispatch off, then on in a
    child process under ATEN_TPU_PARTITION=1 (started with the phase, it
    renders once the parent's renders are done), within the full-image
    bounds.  20f: entry()'s step on the card against the CPU."""
    import shutil

    t20 = time.time()
    out_dir = os.path.join(ROOT, "build", "phase20")
    os.makedirs(out_dir, exist_ok=True)
    # 20e's child under ATEN_TPU_PARTITION=1 starts now and waits for its
    # go, so its start-up overlaps 20a-20d and its render runs alone
    npy = os.path.join(out_dir, "partition_on.npy")
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD_PARTITION.format(root=ROOT, res=P20_RES, kw=ZOO_KW, out=npy)],
        cwd=ROOT, env={**os.environ, "ATEN_TPU_PARTITION": "1"}, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        obj_path, cam = write_knot_obj(out_dir, P20_RES)
        knot = cli_runs(card, dev, obj_path, cam, out_dir)
        t = phase_clock("20a", t20)
        sbvh_walks(card, dev, knot, obj_path, cam, out_dir)
        t = phase_clock("20b", t)
        frustum_check(card, dev, knot, cam)
        del knot
        t = phase_clock("20c", t)
        compaction_check(card, dev)
        t = phase_clock("20d", t)
        dispatch_check(card, dev, child, npy)
        t = phase_clock("20e", t)
        entry_check(card, dev)
        phase_clock("20f", t)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"phase 20 took {time.time() - t20:.1f} s (budget 45 s) [{card}]")


def cli_args(obj, cam, res, spp, out, checkpoint, device):
    return ["--obj", obj, "--width", str(res), "--height", str(res), "--spp", str(spp),
            "--camera", *map(str, cam.origin), *map(str, cam.lookat),
            "--vfov", str(cam.vfov_deg), "--stats", "--checkpoint", checkpoint, "-o", out,
            "--device", device]


def run_cli(args):
    """(the --stats dict, wall s) of cli.render.main(args), with its
    launch counts reset just before and read just after."""
    import contextlib
    import io

    import torch

    from aten_tpu_torch.cli import render

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = render.main(args)
    wall = time.time() - t
    launches = nonzero(read_counts())
    assert rc == 0, rc
    stats = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    return stats[-1], wall, launches


def cli_runs(card, dev, obj_path, cam, out_dir):
    """Phase 20a (see phase20); returns the CLI's knot scene (SAH tree)."""
    import numpy as np
    import torch

    from aten_tpu_torch.cli import render
    from aten_tpu_torch.integrator.film import Film
    from aten_tpu_torch.integrator.pathtracer import render_sample
    from aten_tpu_torch.ops import traverse_cuda

    ck = os.path.join(out_dir, "st.npz")
    args = cli_args(obj_path, cam, P20_RES, CLI_SPP, os.path.join(out_dir, "out.hdr"), ck,
                    dev.type)
    # one closest-hit walk a bounce; an OBJ loaded by the CLI registers no
    # light (its emitters shine when hit, and the background lights it),
    # so NEE casts no shadow ray, as in the reference's CLI
    want = {traverse_cuda.KERNELS[0]: 5 * CLI_SPP}
    n_prims = 2 * KNOT_UV[0] * KNOT_UV[1] + 4
    for call in ("first", "resumed"):
        stats, wall, launches = run_cli(args)
        log(f"phase 20a cli.render {call} call, --obj knot.obj ({n_prims} prims) {P20_RES}x"
            f"{P20_RES} {CLI_SPP} spp depth 5 RR 3: --stats {json.dumps(stats)}; wall of the call "
            f"{wall * 1e3:.1f} ms (load, build, render, checkpoint); launches {launches} [{card}]")
        assert launches == want, (call, launches, want)
    # the same 32 samples accumulated directly on the CLI's own scene
    scene, ccam = render.make_scene(render.build_parser().parse_args(args))
    ca = ccam.arrays(dev)
    film = Film(P20_RES, P20_RES, dev)
    for s in range(2 * CLI_SPP):
        film.accumulate(render_sample(scene, ca, P20_RES, P20_RES, s // CLI_SPP, s, CLI_SPP, 5, 3))
    with np.load(ck) as z:
        buf, count, frame = z["film/buf"], int(z["film/count"]), int(z["frame"])
    same = bits_equal(torch.from_numpy(buf), film.image().cpu())
    log(f"phase 20a resumed film: {count} samples, frame {frame}, mean {buf.mean():.5f}; bitwise "
        f"the {2 * CLI_SPP} render_sample calls accumulated directly: {same}")
    assert same and count == 2 * CLI_SPP and frame == 2 and np.isfinite(buf).all()
    del film
    # the CLI at 64x64 on the card against the same call on this machine's CPU
    films = {}
    for d in (dev.type, "cpu"):
        small_ck = os.path.join(out_dir, f"small_{d}.npz")
        _, wall, _ = run_cli(cli_args(obj_path, cam, CLI_SMALL, CLI_SMALL_SPP,
                                      os.path.join(out_dir, f"small_{d}.hdr"), small_ck, d))
        with np.load(small_ck) as z:
            films[d] = z["film/buf"]
        log(f"phase 20a cli.render {CLI_SMALL}x{CLI_SMALL} {CLI_SMALL_SPP} spp --device {d}: "
            f"wall {wall:.2f} s")
    check_image_bounds(f"phase 20a CLI {CLI_SMALL}x{CLI_SMALL} card vs CPU", films[dev.type],
                       films["cpu"])
    torch.cuda.empty_cache()
    return scene


def sbvh_walks(card, dev, knot, obj_path, cam, out_dir):
    """Phase 20b (see phase20); `knot`: the knot OBJ's scene (SAH)."""
    import numpy as np
    import torch

    from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plain
    from aten_tpu_torch.cli import bvh_builder
    from aten_tpu_torch.core.camera import PinholeCamera
    from aten_tpu_torch.io.obj_writer import write_obj
    from aten_tpu_torch.ops import traverse_cuda
    from aten_tpu_torch.scene.objloader import load_obj
    from aten_tpu_torch.scene.scene import SceneBuilder, with_bvh_layout

    rng = np.random.default_rng(SEED)
    tris = sliver_triangles(SLIVERS, SEED)
    sl_obj = os.path.join(out_dir, "slivers.obj")
    write_obj(sl_obj, tris.reshape(-1, 3), np.arange(3 * SLIVERS).reshape(-1, 3))
    scam = PinholeCamera(origin=(1.5, 0.0, 14.0), lookat=(1.5, 0.0, 0.0), vfov_deg=45.0,
                         width=P20_RES, height=P20_RES)
    # the plain version's walk is host-bound and its steps follow the
    # longest ray's: the knot's SBVH (2,328 repeated references) is held to
    # it; the slivers' (~460 node steps a ray, 11 s for 16,384 rays) only
    # to K1 on their SAH tree
    for name, obj, c, kinds in (
            ("knot", obj_path, cam, ((False, 1e-4), (True, 1e-3))),
            ("slivers", sl_obj, scam, ())):
        npz = os.path.join(out_dir, f"{name}.sbvh.npz")
        t = time.time()
        assert bvh_builder.main([obj, "-o", npz, "--spatial-splits"]) == 0
        build_s = time.time() - t
        with np.load(npz) as z:
            tree = {k: z[k] for k in z.files}
        if name == "knot":
            sah = knot
        else:
            b = SceneBuilder()
            load_obj(b, obj)
            sah = b.build(dev)
        if "bvh_nodes" not in sah:
            sah = with_bvh_layout(sah)
        t = time.time()
        sb = sah.replace(**tree)
        torch.cuda.synchronize()
        replace_s = time.time() - t
        n_prims, refs = sah["num_tris"] + sah["num_spheres"], tree["prim_order"].shape[0]
        log(f"phase 20b {name}: bvh_builder --spatial-splits {build_s:.2f} s (OBJ load and "
            f"build, host): {n_prims} prims -> {refs} references (ratio {refs / n_prims:.4f}), "
            f"{tree['nodes_hit'].shape[0]} nodes against the SAH tree's "
            f"{sah['nodes_hit'].shape[0]}; Scene.replace with K1's records {replace_s:.2f} s")
        assert sb["bvh_prims"].shape[0] == refs and "traversal" not in sb
        if name == "slivers":
            assert refs > n_prims, "the slivers' SBVH has no duplicated reference"
        ro, rd = (x.contiguous() for x in camera_rays(c, dev, jitter_rng=rng,
                                                      subsamples=SBVH_SUBSAMPLES))
        n = ro.shape[0]
        t0 = _t0_of(None, n, dev)
        hs = traverse_cuda.bvh_traverse(sah, ro, rd, t0)
        hb = traverse_cuda.bvh_traverse(sb, ro, rd, t0)
        hit = hs[1] >= 0
        same_hit = bool(torch.equal(hit, hb[1] >= 0))
        other = hs[1] != hb[1]
        # a ray through an edge two triangles share meets both at the same
        # t, and each tree keeps the one it tests first: a tie, not a miss
        ties = int((other & (hs[0] == hb[0])).sum())
        t_err = float((torch.abs(hb[0] - hs[0]) / torch.abs(hs[0]))[hit].max()) if bool(
            hit.any()) else 0.0
        log(f"phase 20b {name}: K1 on {n} camera rays, SBVH against the SAH tree: hit masks "
            f"equal {same_hit} ({int(hit.sum())} hits), prims differ on {int(other.sum())} "
            f"rays, {ties} of them ties at a bitwise-equal t; max t rel err {t_err:.3e}")
        assert same_hit and int(other.sum()) == ties <= n * 1e-5 and t_err <= 1e-5
        # K1 on the SBVH records against its plain version, pixel centres
        cro, crd = (x.contiguous() for x in camera_rays(
            dataclasses.replace(c, width=PLAIN20, height=PLAIN20), dev))
        ct0 = _t0_of(None, cro.shape[0], dev)
        t = time.time()
        for any_hit, t_min in kinds:
            k = traverse_cuda.bvh_traverse(sb, cro, crd, ct0, any_hit=any_hit, t_min=t_min)
            p = _traverse_plain(sb, cro, crd, ct0, any_hit, t_min, baked=True)
            same = all(bits_equal(a, p[key]) for a, key in zip(k, ("t", "prim", "u", "v")))
            if any_hit:  # the plain walk keeps testing a leaf after its first hit
                same = bool(torch.equal(k[1] >= 0, p["prim"] >= 0))
            log(f"phase 20b {name}: K1 on the SBVH records, {cro.shape[0]} pixel-centre rays, "
                f"{'any' if any_hit else 'closest'}-hit, {'verdicts' if any_hit else 'bitwise'} "
                f"equal to its plain version: {same} ({time.time() - t:.1f} s)")
            assert same, (name, any_hit)
            t = time.time()
        # times in turns, and each tree's bound from K1's kStats counts
        ms = {"SBVH": [], "SAH": []}
        for _ in range(SBVH_TURNS):
            for tag, sc in (("SBVH", sb), ("SAH", sah)):
                ms[tag].append(cuda_ms(lambda: traverse_cuda.bvh_traverse(sc, ro, rd, t0),
                                       reps=SBVH_REPS))
        for tag, sc in (("SBVH", sb), ("SAH", sah)):
            counts = traverse_cuda.bvh_traverse(sc, ro, rd, t0, stats=True)[4]
            work = {k: int(v.sum()) for k, v in counts.items()}
            bd = bound(n, 16, array_bytes(sc, BVH_ARRAYS), work)
            mean = sum(ms[tag]) / len(ms[tag])
            log(f"phase 20b {name}: K1 closest on the {tag} tree, {n} rays: "
                f"{', '.join(f'{x:.3f}' for x in ms[tag])} ms in turns (mean {mean:.3f}); work "
                f"{work}; bound {bd[0]:.4f} ms by {bd[1]} ({bd[2]} B, {bd[3]} ops), "
                f"{mean / bd[0]:.1f}x [{card}]")
        log(f"phase 20b {name}: SBVH / SAH time {sum(ms['SBVH']) / sum(ms['SAH']):.3f}")
        del sb, sah, ro, rd, t0, hs, hb
        torch.cuda.empty_cache()


def frustum_check(card, dev, scene, cam):
    """Phase 20c (see phase20)."""
    import torch

    from aten_tpu_torch.accel.frustum import frustum_planes_from_camera, visible_prims
    from aten_tpu_torch.accel.traverse import _t0_of
    from aten_tpu_torch.ops import traverse_cuda

    planes = frustum_planes_from_camera(cam)
    nt = scene["num_tris"]
    p0 = scene["tri_v0"][:nt]
    corners = torch.stack([p0, p0 + scene["tri_e1"][:nt], p0 + scene["tri_e2"][:nt]], 1)
    boxes = (corners.amin(1), corners.amax(1))
    tree = ("nodes_bmin", "nodes_bmax", "nodes_prim_start", "nodes_prim_count", "prim_order")
    host = {k: scene[k].cpu() for k in tree}
    got = {}
    for refine, bx in (("leaf", ()), ("prim boxes", boxes)):
        mask, nodes = visible_prims(scene, planes, *bx)
        cmask, cnodes = visible_prims(host, planes, *(b.cpu() for b in bx))
        same = bits_equal(mask, cmask) and bits_equal(nodes, cnodes)
        ms = cuda_ms(lambda: visible_prims(scene, planes, *bx), reps=10)
        log(f"phase 20c visible_prims ({refine}) on the knot ({nt} prims, "
            f"{nodes.shape[0]} nodes): {int(mask.sum())} prims, {int(nodes.sum())} nodes in "
            f"the frustum; card bitwise the CPU's {same}; {ms:.3f} ms [{card}]")
        assert same
        got[refine] = mask
    ro, rd = (x.contiguous() for x in camera_rays(cam, dev))
    prim = traverse_cuda.bvh_traverse(scene, ro, rd, _t0_of(None, ro.shape[0], dev))[1]
    hit = torch.unique(prim[prim >= 0].long())
    inside = {k: bool(m[hit].all()) for k, m in got.items()}
    log(f"phase 20c K1's {ro.shape[0]} pixel-centre rays hit {hit.numel()} distinct prims, all "
        f"in the visible set: {inside}")
    assert all(inside.values()) and hit.numel() > nt // 20


def compaction_check(card, dev):
    """Phase 20d (see phase20)."""
    import numpy as np
    import torch

    from aten_tpu_torch.ops.compaction import compact, scatter_back

    rng = np.random.default_rng(SEED)
    alive = torch.from_numpy(rng.uniform(size=COMPACT_N) < 0.5)
    x = torch.from_numpy(rng.normal(size=(COMPACT_N, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 1 << 30, COMPACT_N).astype(np.int32))
    outs = {}
    for d in (dev, torch.device("cpu")):
        perm, count, g = compact(alive.to(d), x.to(d), ids.to(d))
        outs[d.type] = (perm, count, *g, *scatter_back(perm, *g))
    same = all(bits_equal(a, b) for a, b in zip(outs[dev.type], outs["cpu"]))
    back = bits_equal(outs["cpu"][4], x) and bits_equal(outs["cpu"][5], ids)
    log(f"phase 20d compact + scatter_back, {COMPACT_N} lanes, {int(outs['cpu'][1])} live: "
        f"card bitwise the CPU's {same}; scatter_back(compact) the identity {back}")
    assert same and back


def dispatch_check(card, dev, child, npy):
    """Phase 20e (see phase20): `child` the process of CHILD_PARTITION,
    waiting for its go; it writes its image to `npy`."""
    import numpy as np
    import torch

    from aten_tpu_torch.integrator.pathtracer import render_image
    from aten_tpu_torch.scene.scenedefs import material_test_scene, sky_envmap
    from aten_tpu_torch.shading import dispatch

    assert not dispatch._ENV_PARTITION, "the partition is off by default"
    scene, cam = material_test_scene(P20_RES, P20_RES, envmap=sky_envmap(), device=dev)
    render_image(scene, cam, **ZOO_KW)  # warm-up
    torch.cuda.synchronize()
    t = time.time()
    off = render_image(scene, cam, **ZOO_KW)
    torch.cuda.synchronize()
    wall_off = time.time() - t
    off = off.cpu().numpy()
    del scene
    torch.cuda.empty_cache()
    out, err = child.communicate("go\n", timeout=300)
    if child.returncode != 0:
        log(out[-4000:], err[-4000:])
        raise RuntimeError(f"phase 20e child process exited {child.returncode}")
    got = json.loads(out.strip().splitlines()[-1])
    on = np.load(npy)
    log(f"phase 20e zoo+IBL {P20_RES}x{P20_RES} {ZOO_KW['spp']} spp depth 5 RR 3: partition off "
        f"{wall_off * 1e3:.1f} ms; on (child under ATEN_TPU_PARTITION=1) {got['wall_ms']:.1f} ms, "
        f"{got['partitioned_calls']} partitioned BSDF calls; the images bitwise equal "
        f"{bool(np.array_equal(on, off))} [{card}]")
    assert got["partition"] and got["partitioned_calls"] > 0, got
    assert np.isfinite(on).all()
    check_image_bounds("phase 20e zoo+IBL partition on vs off", on, off)


def entry_check(card, dev):
    """Phase 20f (see phase20)."""
    import torch

    from aten_tpu_torch.entry import entry

    fn, args = entry()  # the card by default
    assert args[0].device == dev, args[0].device
    fn(*args)  # warm-up
    img, ms = timed_ms(lambda: fn(*args))
    cfn, cargs = entry("cpu")
    ref = cfn(*cargs)
    log(f"phase 20f entry(): the Cornell box 64x64, 1 spp, depth 3, RR 2 on the card "
        f"{ms:.2f} ms, mean {float(img.mean()):.5f} (CPU {float(ref.mean()):.5f}) [{card}]")
    assert bool(torch.isfinite(img).all())
    check_image_bounds("phase 20f entry() card vs CPU", img.cpu().numpy(), ref.numpy())


def main():
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "aten_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(aten_tpu_torch/ not found beside this script)")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    import numpy as np

    from aten_tpu_torch.accel.traverse import (
        _t0_of, _traverse_plain, _traverse_plk_plain, traverse)
    from aten_tpu_torch.integrator.pathtracer import render_image
    from aten_tpu_torch.ops import plk_cuda, plk_layout, tlas_cuda, traverse_cuda
    from aten_tpu_torch.scene.scenedefs import (
        cornell_box, instanced_mesh_scene, large_mesh_scene, procedural_mesh_scene)

    # -- phase 0: the card
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- phase 1: build the kernels from the checkout's sources: the
    # traversal library here and, at the same time, the labs' library in a
    # second process (ninja starts one nvcc for each source of a library)
    t = time.time()
    labs = subprocess.Popen([sys.executable, "-c", LAB_BUILD.format(root=ROOT)], cwd=ROOT)
    try:
        traverse_cuda.load_library(verbose=True)
    finally:
        labs_rc = labs.wait(timeout=900)
    log(f"phase 1: built {KERNEL_SOURCE}, {TLAS_SOURCE}, {PLK_SOURCE} and {SMT_SOURCE}, and "
        f"beside them {CHASE_SOURCE}, {LAUNCH_SOURCE} and {LAB_SOURCE}, in "
        f"{time.time() - t:.1f} s")
    if labs_rc != 0:
        raise RuntimeError(f"phase 1: the labs' build exited {labs_rc}")

    t_phase = time.time()
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
        e, same, _, _, _ = compare_traversal(name, scene, torch.cat([cro, sro]),
                                       torch.cat([crd, srd]), dist)
        max_err["closest"] = max(max_err["closest"], e)
        max_err["any"] = max(max_err["any"], 0.0 if same else 1.0)
    # the main path's shape: 512x512 pixels x 16 samples = 4,194,304 rays
    n_main = 512 * 512 * 16
    cro, crd = camera_rays(cam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = surface_rays(big, n_main - cro.shape[0], rng, dev)
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    e, same, work, plain2, walks2 = compare_traversal("mesh102k main-path shape", big, ro,
                                                      rd, dist)
    work2 = work
    max_err["closest"] = max(max_err["closest"], e)
    max_err["any"] = max(max_err["any"], 0.0 if same else 1.0)
    times, bounds = {}, {}
    for name, scene, rs, w in (("102,404 prims", big, (ro, rd), work), ("2,004 prims", mid, None, None)):
        if rs is None:
            # the same kernel over the 2,004-prim scene's uncut tree (the
            # function of the reference's _make_kernel, traverse_pallas.py
            # :102), same shape
            sro, srd = surface_rays(mid, n_main - cro.shape[0], rng, dev)
            rs = (torch.cat([cro, sro]), torch.cat([crd, srd]))
            _, _, w, plain2, _ = compare_traversal("mesh2k main-path shape", mid, *rs, dist)
        pool = array_bytes(scene, BVH_ARRAYS)
        pool_k1 = pool_bytes(scene, traverse_cuda._SCENE_FIELDS)
        log(f"phase 2 {name}: the BVH's arrays {pool} B; K1's packed records "
            f"{scene['bvh_nodes'].shape[0]} nodes x 32 B + {scene['bvh_prims'].shape[0]} "
            f"prims x 48 B = {pool_k1} B")
        for kind, t0k, any_hit, t_min in (("closest", _t0_of(None, n_main, dev), False, 1e-4),
                                          ("any", dist, True, 1e-3)):
            kw = {"t_max": t0k, "any_hit": any_hit, "t_min": t_min}
            times[name, kind] = (
                cuda_ms(lambda: traverse(scene, *rs, impl="cuda", **kw), reps=10),
                plain2[kind],
            )
            b = bounds[name, kind] = bound(n_main, 16, pool, w[kind])
            b_k1 = bound(n_main, 16, pool_k1, w[kind])
            log(f"phase 2 timing {kind}-hit, {n_main} rays, {name}: kernel "
                f"{times[name, kind][0]:.3f} ms, plain torch walk {times[name, kind][1]:.3f} ms, "
                f"bound {b[0]:.4f} ms by {b[1]} ({b[2]} B, {b[3]} fp32 ops), "
                f"{times[name, kind][0] / b[0]:.1f}x the bound; over K1's packed records "
                f"the bound is {b_k1[0]:.4f} ms by {b_k1[1]} ({b_k1[2]} B) [{card}]")
        if scene is mid:
            del rs

    t_phase = phase_clock(2, t_phase)
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

    t_phase = phase_clock(3, t_phase)
    # -- phase 4: the mesh path, 512x512 x 16 spp, depth 5, RR depth 3
    render_image(big, cam, spp=16, max_depth=5, rr_depth=3)  # warm-up
    img, wall, launches, peak, held = timed_render(
        lambda: render_image(big, cam, spp=16, max_depth=5, rr_depth=3))
    img = img.cpu().numpy()
    log(f"phase 4 main path launches: {launches}")
    assert all(launches[k] > 0 for k in traverse_cuda.KERNELS), launches
    assert all(launches[k] == 0 for k in tlas_cuda.KERNELS), launches
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    mpaths = 512 * 512 * 16 / wall / 1e6
    log(f"phase 4 render 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f} "
        f"wall {wall * 1e3:.1f} ms, {mpaths:.3f} Mpaths/s, {peak_text(peak, held)} [{card}]")
    log_profile("phase 4", card, profile_render(
        lambda: render_image(big, cam, spp=16, max_depth=5, rr_depth=3)))
    small = dataclasses.replace(cam, width=128, height=128)
    ik = render_image(big, small, spp=2, max_depth=3, impl="auto").cpu().numpy()
    ip = render_image(big, small, spp=2, max_depth=3, impl="plain").cpu().numpy()
    check_image_bounds("phase 4 128x128 2spp kernel vs plain", ik, ip)
    log_render_work("phase 4", big, cam, {"K1 (the oracle)": _traverse_plain},
                    {"K1 (the oracle)": work}, n_main)
    # the 2,004-prim scene's render: the launches of K2's function
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    img = render_image(mid, cam, spp=16, max_depth=5, rr_depth=3)
    torch.cuda.synchronize()
    wall2 = time.time() - t
    launches2 = read_counts()
    log(f"phase 4 2,004-prim render 512x512 16spp depth 5: launches {launches2}, "
        f"wall {wall2 * 1e3:.1f} ms (first render of the scene) [{card}]")
    assert all(launches2[k] > 0 for k in traverse_cuda.KERNELS), launches2
    assert bool(torch.isfinite(img).all()) and float(img.std()) > 0
    log_profile("phase 4 2,004-prim", card, profile_render(
        lambda: render_image(mid, cam, spp=16, max_depth=5, rr_depth=3)))
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches[name],
         "max_abs_err": max_err[kind], "ms": times["102,404 prims", kind][0],
         "plain_ms": times["102,404 prims", kind][1],
         "bound_ms": bounds["102,404 prims", kind][0],
         "bound_by": bounds["102,404 prims", kind][1], "library_ms": None}
        for name, kind in zip(traverse_cuda.KERNELS, ("closest", "any"))
    ]
    # held for phase 9: the rays and the oracle walk's (hits, work) on them
    rays2 = (ro, rd, dist, {k: (walks2[k], work2[k]) for k in walks2})
    del mid, cro, crd, sro, srd

    t_phase = phase_clock(4, t_phase)
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
    e, same, work, plain5, _ = compare_traversal("instanced main-path shape", inst, ro, rd, dist,
                                      exact=True)
    max_err5 = {"closest": e, "any": 0.0 if same else 1.0}
    times5, bounds5 = {}, {}
    # the bound over the pool's own arrays (the query's least work), and
    # over K5's packed records beside it
    pool = pool_bytes(inst, tlas_cuda._PLAIN_FIELDS)
    pool_k5 = pool_bytes(inst, tlas_cuda._SCENE_FIELDS)
    log(f"phase 5: the pool's arrays {pool} B; K5's packed records "
        f"{inst['tl_nodes'].shape[0]} nodes x 32 B + {inst['tl_insts'].shape[0]} instances "
        f"x 64 B + {inst['tl_prims'].shape[0]} prims x 48 B = {pool_k5} B")
    for kind, kw in (("closest", {}), ("any", {"t_max": dist, "any_hit": True, "t_min": 1e-3})):
        times5[kind] = (
            cuda_ms(lambda: traverse(inst, ro, rd, impl="cuda", **kw), reps=10),
            plain5[kind],
        )
        b = bounds5[kind] = bound(n_main, 20, pool, work[kind])
        b_k5 = bound(n_main, 20, pool_k5, work[kind])
        log(f"phase 5 timing {kind}-hit, {n_main} rays, 19 instances over "
            f"102,405 prims: kernel {times5[kind][0]:.3f} ms, plain torch walk "
            f"{times5[kind][1]:.3f} ms, bound {b[0]:.4f} ms by {b[1]} ({b[2]} B, "
            f"{b[3]} fp32 ops), {times5[kind][0] / b[0]:.1f}x the bound; over K5's packed "
            f"records the bound is {b_k5[0]:.4f} ms by {b_k5[1]} ({b_k5[2]} B) [{card}]")
    del ro, rd, cro, crd, sro, srd, dist

    t_phase = phase_clock(5, t_phase)
    # -- phase 6: the instanced path, 512x512 x 16 spp, depth 5, RR depth 3
    render_image(inst, icam, spp=16, max_depth=5, rr_depth=3)  # warm-up
    img, wall, launches6, peak, held = timed_render(
        lambda: render_image(inst, icam, spp=16, max_depth=5, rr_depth=3))
    img = img.cpu().numpy()
    log(f"phase 6 main path launches: {launches6}")
    assert all(launches6[k] > 0 for k in tlas_cuda.KERNELS), launches6
    assert all(launches6[k] == 0 for k in traverse_cuda.KERNELS), launches6
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    mpaths = 512 * 512 * 16 / wall / 1e6
    log(f"phase 6 render 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f} "
        f"wall {wall * 1e3:.1f} ms, {mpaths:.3f} Mpaths/s, {peak_text(peak, held)} [{card}]")
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

    del inst

    t_phase = phase_clock(6, t_phase)
    # -- phase 7: the Plücker kernel vs its plain version and the oracle
    t = time.time()
    large, lcam = large_mesh_scene(512, 512, device=dev)
    torch.cuda.synchronize()
    n_prims = large["num_tris"] + large["num_spheres"]
    pool_mb = plk_layout.pool_mb(large["plk_hit"].shape[0],
                                 large["plk_slot2prim"].shape[0] // plk_layout.PACK)
    log(f"phase 7: large mesh scene built in {time.time() - t:.1f} s: {n_prims} prims, "
        f"traversal {large.get('traversal')!r}, reference pools {pool_mb:.2f} MB, "
        f"{large['plk_hit'].shape[0]} cut-tree nodes, "
        f"{large['plk_slot2prim'].shape[0]} slots")
    assert n_prims == 512004 and large["traversal"] == "plk"
    cro, crd = camera_rays(lcam, dev, jitter_rng=rng, subsamples=8)
    sro, srd = first_hit_rays(large, cro, crd, n_main - cro.shape[0], rng, impl="plk")
    ro, rd = torch.cat([cro, sro]), torch.cat([crd, srd])
    dist = torch.tensor(rng.uniform(0.0, 20.0, n_main), dtype=torch.float32, device=dev)
    del cro, crd, sro, srd
    e7, work7, oracle7, plain7, walks7 = compare_plk("mesh512k main-path shape", large, ro, rd,
                                                     dist)
    t0 = torch.full((n_main,), 3.4e38, dtype=torch.float32, device=dev)
    pool7 = array_bytes(large, BVH_ARRAYS)
    pool7_k3 = pool_bytes(large, plk_cuda._SCENE_FIELDS)
    log(f"phase 7: the BVH's arrays {pool7} B; K3's pool {pool7_k3} B (packed cut tree "
        f"{large['plk_nodes'].shape[0]} nodes x 32 B, slot records, slot2prim)")
    times7, bounds7 = {}, {}
    for kind, t0k, any_hit, t_min in (("closest", t0, False, 1e-4), ("any", dist, True, 1e-3)):
        times7[kind] = (
            cuda_ms(lambda: plk_cuda.plk_traverse(large, ro, rd, t0k, any_hit=any_hit,
                                                  t_min=t_min), reps=10),
            plain7[kind],
        )
        # the bound: the query's least work on these rays, the oracle
        # walk's over the BVH's arrays; beside it the same work over K3's
        # pool, and K3's own walk's (whole fat leaves) over its pool
        b = bounds7[kind] = bound(n_main, 8, pool7, oracle7[kind])
        b_pool = bound(n_main, 8, pool7_k3, oracle7[kind])
        b_k3 = bound(n_main, 8, pool7_k3, work7[kind], ops_ray=OPS_RAY_PLK)
        ms = times7[kind][0]
        log(f"phase 7 timing {kind}-hit, {n_main} rays, 512,004 prims: kernel "
            f"{ms:.3f} ms, plain torch version {times7[kind][1]:.3f} ms, "
            f"bound (the query's least work, the oracle walk's) {b[0]:.4f} ms "
            f"by {b[1]} ({b[2]} B, {b[3]} ops), {ms / b[0]:.1f}x the bound (over K3's "
            f"pool {b_pool[0]:.4f} ms); K3's own walk's work would take {b_k3[0]:.4f} ms "
            f"by {b_k3[1]} ({b_k3[2]} B, {b_k3[3]} ops), {ms / b_k3[0]:.1f}x [{card}]")
    rays7 = (ro, rd, dist, walks7)  # held for phase 9
    del t0
    torch.cuda.empty_cache()

    t_phase = phase_clock(7, t_phase)
    # -- phase 8: the large mesh path, 512x512 x 16 spp, depth 5, RR depth 3
    render_image(large, lcam, spp=16, max_depth=5, rr_depth=3)  # warm-up
    img, wall, launches8, peak, held = timed_render(
        lambda: render_image(large, lcam, spp=16, max_depth=5, rr_depth=3))
    img = img.cpu().numpy()
    log(f"phase 8 main path launches: {launches8}")
    assert all(launches8[k] > 0 for k in plk_cuda.KERNELS), launches8
    assert all(launches8[k] == 0 for k in traverse_cuda.KERNELS + tlas_cuda.KERNELS), launches8
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    mpaths = 512 * 512 * 16 / wall / 1e6
    log(f"phase 8 render 512x512 16spp depth 5: mean {img.mean():.5f} std {img.std():.5f} "
        f"wall {wall * 1e3:.1f} ms, {mpaths:.3f} Mpaths/s, {peak_text(peak, held)} [{card}]")
    log_profile("phase 8", card, profile_render(
        lambda: render_image(large, lcam, spp=16, max_depth=5, rr_depth=3)))
    small = dataclasses.replace(lcam, width=128, height=128)
    ik = render_image(large, small, spp=2, max_depth=3, impl="auto").cpu().numpy()
    ip = render_image(large, small, spp=2, max_depth=3, impl="plk_plain").cpu().numpy()
    check_image_bounds("phase 8 128x128 2spp kernel vs plain", ik, ip)
    log_render_work("phase 8", large, lcam,
                    {"K3": _traverse_plk_plain, "the oracle": _traverse_plain},
                    {"K3": work7, "the oracle": oracle7}, n_main)
    kernels += [
        {"name": name, "route": "cuda", "source": PLK_SOURCE,
         "replaces": PLK_REPLACES, "launches": launches8[name],
         "max_abs_err": e7, "ms": times7[kind][0],
         "plain_ms": times7[kind][1], "bound_ms": bounds7[kind][0],
         "bound_by": bounds7[kind][1], "library_ms": None}
        for name, kind in zip(plk_cuda.KERNELS, ("closest", "any"))
    ]

    t_phase = phase_clock(8, t_phase)
    # -- phase 9: K4, the multi-chain treelet walk, on both scenes' rays
    from aten_tpu_torch.accel import traverse as trav_mod
    from aten_tpu_torch.accel.traverse import _traverse_trl_plain
    from aten_tpu_torch.ops import smt_cuda
    from aten_tpu_torch.scene.scene import with_trl_layout

    t9 = time.time()
    times9, bounds9, err9, k4_scenes = {}, {}, 0.0, {}
    for name, scene, rays, base in (("mesh102k", big, rays2, "K1"),
                                    ("mesh512k", large, rays7, "K3")):
        ro, rd, dist, oracle = rays
        # the default policy builds no K4 layout: attach it, as a build
        # under ATEN_TPU_KERNEL=smt does
        t = time.time()
        scene = k4_scenes[name] = with_trl_layout(scene)
        torch.cuda.synchronize()
        log(f"phase 9 {name}: {scene['trl_nodes'].shape[0]} cut-tree nodes, "
            f"{scene['trl_recs'].shape[0]} slots, window {scene['trl_window']}; the K4 "
            f"layout takes {time.time() - t:.2f} s to build and upload (host)")
        e, work, oracle_work, plain_ms = compare_smt(f"phase 9 {name}", scene, ro, rd, dist,
                                                     oracle)
        err9 = max(err9, e)
        pool = pool_bytes(scene, smt_cuda._SCENE_FIELDS)
        pool_bvh = array_bytes(scene, BVH_ARRAYS)
        for kind, t0k, any_hit, t_min in (
                ("closest", torch.full((n_main,), 3.4e38, device=dev), False, 1e-4),
                ("any", dist, True, 1e-3)):
            # the bound: the least work of the query on these rays, the
            # oracle walk's node steps and prim tests over the BVH; K4's
            # own walk (its fat leaves drained whole) is logged beside it
            b = bound(n_main, 8, pool_bvh, oracle_work[kind])
            w = {"node_steps": work[kind]["node_steps"], "prim_tests": work[kind]["slot_tests"]}
            b_k4 = bound(n_main, 8, pool, w)
            bounds9[name, kind] = b
            if base == "K1":
                base_ms = cuda_ms(lambda: traverse_cuda.bvh_traverse(
                    scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min), reps=10)
            else:
                base_ms = cuda_ms(lambda: plk_cuda.plk_traverse(
                    scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min), reps=10)
            for c in smt_cuda.CHAIN_COUNTS:
                times9[name, kind, c] = cuda_ms(lambda: smt_cuda.smt_traverse(
                    scene, ro, rd, t0k, any_hit=any_hit, t_min=t_min, chains=c), reps=10)
            per_c = ", ".join(f"C={c} {times9[name, kind, c]:.3f} ms"
                              for c in smt_cuda.CHAIN_COUNTS)
            times9[name, kind, "plain"] = plain_ms[kind]
            times9[name, kind, "base"] = base_ms
            log(f"phase 9 timing {kind}-hit, {n_main} rays, {name}: K4 {per_c}; {base} "
                f"{base_ms:.3f} ms on the same rays; K4's plain version "
                f"{plain_ms[kind]:.1f} ms; bound (the query's least work, the oracle "
                f"walk's) {b[0]:.4f} ms by {b[1]} ({b[2]} B, {b[3]} ops); K4's own "
                f"walk's work would take {b_k4[0]:.4f} ms by {b_k4[1]} ({b_k4[2]} B, "
                f"{b_k4[3]} ops) [{card}]")
    big = k4_scenes["mesh102k"]
    del rays2, rays7, k4_scenes, large, scene
    torch.cuda.empty_cache()
    # sphere slots: the Cornell box (two spheres, below the treelet line)
    # with the K4 layout attached, rays from inside the box
    cb = with_trl_layout(cornell_box(64, 64, device=dev)[0])
    n_cb = 1 << 18
    ro = torch.from_numpy(rng.uniform(-0.95, 0.95, (n_cb, 3)).astype(np.float32)).to(dev)
    d = rng.standard_normal((n_cb, 3))
    rd = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)).to(dev)
    t0 = torch.full((n_cb,), 3.4e38, device=dev)
    hp = _traverse_trl_plain(cb, ro, rd, t0, False, 1e-4)
    n_sph = int((hp["prim"] >= cb["num_tris"]).sum())
    for c in smt_cuda.CHAIN_COUNTS:
        tk, pk = smt_cuda.smt_traverse(cb, ro, rd, t0, chains=c)
        exact = bool(torch.equal(tk, hp["t"]) and torch.equal(pk, hp["prim"]))
        log(f"phase 9 cornell (spheres) K4 C={c}: {n_cb} rays, {n_sph} sphere hits, "
            f"bitwise equal to the plain version {exact}")
        assert exact and n_sph > 1000, (c, n_sph)
    del cb, ro, rd, t0, hp
    # the 102k scene's render with every traversal forced onto K4
    render_image(big, cam, spp=16, max_depth=5, rr_depth=3, impl="smt")  # warm-up
    img, wall, launches9, peak, held = timed_render(
        lambda: render_image(big, cam, spp=16, max_depth=5, rr_depth=3, impl="smt"))
    img = img.cpu().numpy()
    k4_names = [smt_cuda.kernel_name(a, trav_mod.CHAINS) for a in (False, True)]
    log(f"phase 9 impl='smt' render launches: {launches9}")
    assert all(launches9[k] > 0 for k in k4_names), launches9
    assert all(v == 0 for k, v in launches9.items() if k not in k4_names), launches9
    assert np.isfinite(img).all() and (img >= 0).all()
    assert 1e-3 <= img.mean() <= 1e3 and img.std() > 0, (img.mean(), img.std())
    log(f"phase 9 render 512x512 16spp depth 5 on K4 (C={trav_mod.CHAINS}): mean "
        f"{img.mean():.5f} std {img.std():.5f} wall {wall * 1e3:.1f} ms, "
        f"{512 * 512 * 16 / wall / 1e6:.3f} Mpaths/s, {peak_text(peak, held)} [{card}]")
    log_profile("phase 9", card, profile_render(
        lambda: render_image(big, cam, spp=16, max_depth=5, rr_depth=3, impl="smt")))
    small = dataclasses.replace(cam, width=128, height=128)
    ik = render_image(big, small, spp=2, max_depth=3, impl="smt").cpu().numpy()
    ip = render_image(big, small, spp=2, max_depth=3, impl="smt_plain").cpu().numpy()
    i1 = render_image(big, small, spp=2, max_depth=3, impl="cuda").cpu().numpy()
    check_image_bounds("phase 9 128x128 2spp K4 vs its plain version", ik, ip)
    check_image_bounds("phase 9 128x128 2spp K4 vs K1", ik, i1)
    log(f"phase 9 128x128 K4 render identical to its plain version's: {bool((ik == ip).all())}")
    # a process under ATEN_TPU_KERNEL=smt renders the 512k scene on K4 alone
    child = subprocess.run(
        [sys.executable, "-c", CHILD_SMT.format(root=ROOT)], cwd=ROOT,
        env={**os.environ, "ATEN_TPU_KERNEL": "smt"}, capture_output=True, text=True,
        timeout=300)
    if child.returncode != 0:
        log(child.stdout[-4000:], child.stderr[-4000:])
        raise RuntimeError(f"phase 9 child process exited {child.returncode}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"phase 9 child under ATEN_TPU_KERNEL=smt, 512k scene 64x64 4spp: {got}")
    cnt = got["counts"]
    assert got["kernel"] == "smt" and got["traversal"] == "smt" and not got["plk"], got
    assert got["finite"] and cnt[smt_cuda.kernel_name(False, got["chains"])] > 0, got
    assert all(cnt[k] == 0 for k in traverse_cuda.KERNELS + plk_cuda.KERNELS), got
    kernels += [
        {"name": name, "route": "cuda", "source": SMT_SOURCE,
         "replaces": SMT_REPLACES, "launches": launches9[name],
         "max_abs_err": err9, "ms": times9["mesh102k", kind, trav_mod.CHAINS],
         "plain_ms": times9["mesh102k", kind, "plain"],
         "bound_ms": bounds9["mesh102k", kind][0],
         "bound_by": bounds9["mesh102k", kind][1], "library_ms": None}
        for name, kind in zip(k4_names, ("closest", "any"))
    ]
    log(f"phase 9 took {time.time() - t9:.1f} s")

    # -- phase 10: the latency labs L3 (pointer chase) and L2 (launches)
    from aten_tpu_torch.tools import chase_lab, lab_library, launch_lab

    t10 = time.time()
    t = time.time()
    lab_library.load_library()
    log(f"phase 10: loaded the labs' library (built in phase 1) in {time.time() - t:.1f} s")
    rows = torch.from_numpy(chase_lab.build_chain(0)).to(dev)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    steps = chase_lab.STEPS
    reset_counts()
    lab = {v: chase_lab.measure(rows, x, v) for v in chase_lab.VARIANTS}
    tables, table_launches = {}, {}
    for g in (False, True):
        before = counts_of(launch_lab.KERNELS)["launch_lab"]
        tables[g] = launch_lab.tables(x, g)
        table_launches[g] = counts_of(launch_lab.KERNELS)["launch_lab"] - before
    launch_ms = cuda_ms(lambda: launch_lab.run(x, 1, 1, 1), reps=100)
    launches10 = counts_of(chase_lab.KERNELS + launch_lab.KERNELS)
    # each table runs every chain 4 times (a warm-up and 3 timed); the
    # graph table also runs it once eagerly before the capture, and the
    # captured launches count only when a replay runs them
    chain = sum(c[1] for c in launch_lab.CONFIGS)
    log(f"phase 10 lab launches: {launches10}; launch_lab: eager tables "
        f"{table_launches[False]}, graph tables {table_launches[True]} "
        f"({4 * chain} of them replayed from CUDA graphs)")
    assert all(v > 0 for v in launches10.values()), launches10
    assert table_launches[False] == 4 * chain and table_launches[True] == 5 * chain, \
        table_launches
    for v in chase_lab.VARIANTS:
        out = chase_lab.run(rows, x, v)
        plain, plain_ms = timed_ms(lambda: chase_lab.run_plain(rows, x, v))
        same = bool(torch.equal(out, plain))
        per_iter, ms = lab[v]
        log(f"phase 10 chase_lab {v}: {per_iter:.1f} ns/iter "
            f"({per_iter / chase_lab.chases(v):.1f} ns/chase), {ms:.4f} ms per run of "
            f"{steps} steps, bitwise equal to the plain version {same} [{card}]")
        assert same, v
        lanes = {"reduce": 3, "extracts": 6, "vec2scalar": 128, "red_kd": 128,
                 "red_11": 128}.get(v, 1)
        nbytes = 2 * 8 * 128 * 4 + (0 if v == "scalar" else
                                    chase_lab.chases(v) * min(steps, chase_lab.K) * lanes * 4)
        b = lab_bound(nbytes, steps * chase_lab.chases(v) * LAB_THREADS * OPS_LAB_STEP)
        kernels.append(
            {"name": f"chase_lab_{v}", "route": "cuda", "source": CHASE_SOURCE,
             "replaces": CHASE_REPLACES, "launches": launches10[f"chase_lab_{v}"],
             "max_abs_err": float((out - plain).abs().max()), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
    for graph in (False, True):
        log(f"phase 10 launch_lab, {'one CUDA graph replay per chain' if graph else 'eager launches'}"
            f" [{card}]:")
        for line in tables[graph][0]:
            log(f"phase 10   {line}")
    err10 = 0.0
    for cfg in launch_lab.CONFIGS:
        out = launch_lab.run(x, *cfg)
        _, graph_out = launch_lab.timeit(x, *cfg, graph=True, reps=1)
        plain = launch_lab.run_plain(x, *cfg)
        same = bool(torch.equal(out, plain)) and bool(torch.equal(graph_out, plain))
        err10 = max(err10, float((out - plain).abs().max()))
        log(f"phase 10 launch_lab (steps, nlaunch, grid) = {cfg}: eager and graph outputs "
            f"bitwise equal to the plain version {same}")
        assert same, cfg
    _, plain_ms = timed_ms(lambda: launch_lab.run_plain(x, 1, 1, 1))
    b = lab_bound(2 * 8 * 128 * 4, LAB_THREADS * OPS_LAB_STEP)
    kernels.append(
        {"name": "launch_lab", "route": "cuda", "source": LAUNCH_SOURCE,
         "replaces": LAUNCH_REPLACES, "launches": launches10["launch_lab"],
         "max_abs_err": err10, "ms": launch_ms, "plain_ms": plain_ms,
         "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
    log(f"phase 10 took {time.time() - t10:.1f} s")

    kernels += lab_phase(card, big, cam, dev)
    del big
    torch.cuda.empty_cache()

    zoo_phase(card, dev)
    train_phase(card, dev)
    kernels += lod_phase(card, dev)
    kernels += stats_phase(card, dev)
    kernels += window_phase(card, dev)
    phase17(card, dev)
    phase18(card, dev)
    phase19(card, dev)
    phase20(card, dev)

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
