"""Microbenchmark (L3): per-iteration latency of a pointer chase, on the card.

    python -m aten_tpu_torch.tools.chase_lab [variant]     (STEPS=8192)

Counterpart of the reference's tools/chase_lab.py, whose TPU kernel
(`make_kernel` :41, `run` :181) measured what one step of its treelet
walk costs; the reference's multi-chain kernel K4 was decided on its
`smt4` reading (aten_tpu/ops/traverse_pallas.py:1312-1332).  The CUDA
kernel is kernels/chase_lab.cu: one block of 1024 threads stands for the
TPU's (8,128) tile, and the chase index is the same for every thread.

Variants (the reference's names):
  chase      load a row, take the next index from lane 7
  reduce     chase + a compare of two row values against the tile,
             reduced to one flag (`__syncthreads_or`) that feeds acc
  extracts   chase + 10 more lane reads per step
  smt4       four independent chases in one loop body
  scalar     a scalar LCG step, no load
  cond       chase + a data-dependent branch
  smt4cond   smt4 + four branches
  vec2scalar chase + the row against the tile, reduced to one flag
  red_kd     the same reduced per warp (`__any_sync`), then OR-ed through
             shared memory (the TPU's (8,1) reduce plus a scalar OR)
  red_11     the same reduced by `__syncthreads_count`
  fori       chase as a counted loop
  unroll8    chase, eight steps per loop iteration

What they ask of the H100.  smt4 asks whether one thread overlaps four
independent dependent loads, the question K4's chains put to the card;
reduce, vec2scalar, red_kd and red_11 price the block-wide vote that a
tile walk needs and a ray-per-thread walk does not.  Some questions are
the TPU's own: fori against chase and unroll8 asked how Mosaic lowers a
while loop (on the card both are the same loop), extracts priced scalar
lane extracts from a vector row (on the card a lane read is an ordinary
load, and the compiler may drop the never-taken selects), and
cond/smt4cond priced `lax.cond` (on the card a branch that is never
taken).  Their H100 readings say what the same source costs here, not
what it cost there.

Every variant's output is x + last + acc, as the reference computes it;
`run_plain` computes it with torch step by step, and the kernel must
equal it bit for bit.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from aten_tpu_torch.utils import spans

K = 1 << 14
LANES = 128
STEPS = int(os.environ.get("STEPS", 8192))
VARIANTS = ("chase", "reduce", "extracts", "smt4", "scalar", "cond", "smt4cond",
            "vec2scalar", "red_kd", "red_11", "fori", "unroll8")
# A launch adds 1 to the counter "launch.<name>" (utils/spans.py) on the
# line after it succeeds in `run`.
KERNELS = tuple(f"chase_lab_{v}" for v in VARIANTS)


def chases(variant):
    return 4 if variant.startswith("smt4") else 1


def build_chain(seed):
    """The chase table, [K, 128] float32 numpy, as the reference builds
    it: a random permutation of the rows in lane 7 (and lanes 9, 11, 13,
    15, 17), six random floats in lanes 0-5, zero elsewhere."""
    rng = np.random.default_rng(seed)
    nxt = rng.permutation(K).astype(np.int32)
    rows = np.zeros((K, LANES), np.float32)
    rows[:, 7] = nxt.view(np.float32)
    rows[:, 0:6] = rng.random((K, 6), np.float32).astype(np.float32)
    for k in range(1, 6):
        rows[:, 7 + 2 * k] = nxt.view(np.float32)
    return rows


def _check(rows, x, variant, steps):
    if variant not in VARIANTS:
        raise ValueError(f"unknown chase_lab variant {variant!r}; one of {VARIANTS}")
    if rows.dtype != torch.float32 or tuple(rows.shape) != (K, LANES):
        raise ValueError(f"rows: expected float32 [{K}, {LANES}], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if x.dtype != torch.float32 or tuple(x.shape) != (8, LANES):
        raise ValueError(f"x: expected float32 [8, {LANES}], got {x.dtype} {tuple(x.shape)}")
    if x.device != rows.device or not (rows.is_contiguous() and x.is_contiguous()):
        raise ValueError("rows and x must be contiguous and on one device")
    if steps < 0:
        raise ValueError(f"steps={steps} < 0")


def run_plain(rows, x, variant, steps=None):
    """The (8,128) output of `variant` after `steps` steps, in torch: the
    chase walked step by step, then each step's flag or sum over the
    rows it visited."""
    steps = STEPS if steps is None else steps
    _check(rows, x, variant, steps)
    nxt = rows[:, 7].view(torch.int32).tolist()
    acc = 0
    if variant == "scalar":
        cur = 0
        for _ in range(steps):
            cur = (cur * 1103515245 + 12345) & (K - 1)
        visited = []
    else:
        n = -(-steps // 8) * 8 if variant == "unroll8" else steps
        starts = (0, 1, 2, 3) if variant.startswith("smt4") else (0,)
        walks = []
        for c in starts:
            w = [c]
            for _ in range(n):
                w.append(nxt[w[-1]])
            walks.append(w)
        cur = walks[0][-1]
        visited = walks[0][:-1]
        if variant == "smt4cond":
            acc = sum(sum(1 for c in w[1:] if c > K) for w in walks)
    if variant in ("reduce", "extracts", "cond", "vec2scalar", "red_kd", "red_11"):
        idx = torch.tensor(visited, dtype=torch.long, device=rows.device)
        r = rows[idx]
        if variant == "reduce":
            v = (r[:, 0, None, None] - x) * (r[:, 3, None, None] - x)
            acc = int((v > torch.tensor(0.2, dtype=torch.float32)).flatten(1).any(1).sum())
        elif variant == "extracts":
            ints = r.view(torch.int32)[:, 8:18:2].to(torch.int64)
            acc = int(ints.sum())
        elif variant == "cond":
            acc = int((r.view(torch.int32)[:, 7] > K).sum())
        else:
            v = (r[:, None, :] - x) > torch.tensor(0.5, dtype=torch.float32)
            acc = int(v.flatten(1).any(1).sum())
    acc = (acc + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wraparound
    f32 = torch.float32
    return (x + torch.tensor(float(cur), dtype=f32)) + torch.tensor(float(acc), dtype=f32)


def run(rows, x, variant, steps=None):
    """The kernel's (8,128) output of `variant` after `steps` steps on
    rows [K,128] and x [8,128] (float32).  For CPU tensors it runs
    `run_plain`; on a CUDA tensor it launches the kernel or raises."""
    steps = STEPS if steps is None else steps
    _check(rows, x, variant, steps)
    if rows.device.type == "cpu":
        return run_plain(rows, x, variant, steps)
    if rows.device.type != "cuda":
        raise ValueError(f"chase_lab: unsupported device {rows.device}")
    from aten_tpu_torch.tools.lab_library import check, load_library

    lib = load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.aten_chase_lab(rows.data_ptr(), x.data_ptr(), out.data_ptr(),
                                steps, VARIANTS.index(variant), stream)
    check(lib, rc, f"chase_lab {variant}")
    spans.count(f"launch.chase_lab_{variant}")
    return out


def measure(rows, x, variant, steps=None, reps=3):
    """The reference's timing: four chained runs, each on x plus the
    running sum of the previous outputs' first element, timed with CUDA
    events; the best of `reps`.  Returns (ns per step, ms per run)."""
    steps = STEPS if steps is None else steps

    def chained():
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(4):
            o = run(rows, x + acc, variant, steps)
            acc = acc + o[0, 0]
        return acc

    chained()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        chained()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best * 1e6 / 4 / max(steps, 1), best / 4


def main(argv):
    variant = argv[1] if len(argv) > 1 else "chase"
    if not torch.cuda.is_available():
        raise SystemExit("chase_lab: no CUDA card is available")
    from aten_tpu_torch.tools.lab_library import load_library

    t0 = time.perf_counter()
    load_library()
    dev = torch.device("cuda", 0)
    rows = torch.from_numpy(build_chain(0)).to(dev)
    x = torch.ones((8, LANES), dtype=torch.float32, device=dev)
    run(rows, x, variant)
    torch.cuda.synchronize()
    print(f"build and first run: {time.perf_counter() - t0:.1f}s "
          f"[{torch.cuda.get_device_name(0)}]")
    per_iter, _ = measure(rows, x, variant)
    print(f"{variant}: {per_iter:.0f} ns/iter ({per_iter / chases(variant):.0f} ns/chase)")


if __name__ == "__main__":
    main(sys.argv)
