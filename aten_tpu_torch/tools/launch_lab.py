"""Microbenchmark (L2): fixed overhead of a launch, a block and a loop step.

    python -m aten_tpu_torch.tools.launch_lab

Counterpart of the reference's tools/launch_lab.py (`make_kernel` :18,
`run` :32), which priced a jitted dispatch, a pallas launch, a grid step
and a loop iteration on the TPU.  The CUDA kernel is
kernels/launch_lab.cu: `grid` blocks of 1024 threads each add the result
of `steps` LCG iterations to an (8,128) block and write the same output
block.  `run` chains `nlaunch` launches, each on the previous output.
The reference's single jitted dispatch of the chain has its counterpart
in one replay of a CUDA graph captured from `run`, so the kernel is
launched on torch.cuda.current_stream(); eager launches from Python are
the other reading.  On the card the blocks of a grid run in parallel,
not one after another as the TPU's grid steps do.

It prints the reference's four tables (one launch; 2, 4 and 8 launches;
grids of 64, 256 and 1024; 1024 and 8192 loop steps), eager and graph,
on the card named in the first line.
"""
from __future__ import annotations

import time

import torch

from aten_tpu_torch.utils import spans

LANES = 128
# Launches, in the counter "launch.launch_lab" (utils/spans.py): `run`
# adds one after each launch it makes outside a graph capture (a captured
# launch runs only when the graph is replayed), and `timeit` adds the
# chain's `nlaunch` at each replay.
KERNELS = ("launch_lab",)
# (steps, nlaunch, grid) of the reference's tables, base first
CONFIGS = ((1, 1, 1), (1, 2, 1), (1, 4, 1), (1, 8, 1), (1, 1, 64), (1, 1, 256),
           (1, 1, 1024), (1024, 1, 1), (8192, 1, 1))


def lcg(steps):
    """The LCG's value after `steps` iterations from 0."""
    cur = 0
    for _ in range(steps):
        cur = (cur * 1103515245 + 12345) & 1023
    return cur


def _check(x, steps, nlaunch, grid):
    if x.dtype != torch.float32 or tuple(x.shape) != (8, LANES) or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 [8, {LANES}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if steps < 0 or nlaunch < 1 or grid < 1:
        raise ValueError(f"steps={steps}, nlaunch={nlaunch}, grid={grid}: need "
                         "steps >= 0 and nlaunch, grid >= 1")


def run_plain(x, steps, nlaunch, grid):
    """x plus the LCG's value, added once per launch, in torch float32."""
    _check(x, steps, nlaunch, grid)
    add = torch.tensor(float(lcg(steps)), dtype=torch.float32)
    for _ in range(nlaunch):
        x = x + add
    return x


def run(x, steps, nlaunch, grid):
    """`nlaunch` chained launches of `grid` blocks on x [8,128] float32.
    For a CPU tensor it runs `run_plain`; on a CUDA tensor it launches the
    kernel on the current stream or raises."""
    _check(x, steps, nlaunch, grid)
    if x.device.type == "cpu":
        return run_plain(x, steps, nlaunch, grid)
    if x.device.type != "cuda":
        raise ValueError(f"launch_lab: unsupported device {x.device}")
    from aten_tpu_torch.tools.lab_library import check, load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        captured = torch.cuda.is_current_stream_capturing()
        for _ in range(nlaunch):
            out = torch.empty_like(x)
            check(lib, lib.aten_launch_lab(x.data_ptr(), out.data_ptr(), steps, grid,
                                           stream), "launch_lab")
            if not captured:
                spans.count("launch.launch_lab")
            x = out
    return x


def timeit(x, steps, nlaunch, grid, graph, reps=3):
    """Best of `reps` host wall times (s) of the chain, ended by a
    synchronize: eager launches, or one replay of a CUDA graph captured
    from them.  Returns (seconds, output)."""
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(x, steps, nlaunch, grid)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = run(x, steps, nlaunch, grid)

        def fn():
            g.replay()
            spans.count("launch.launch_lab", nlaunch)
    else:
        def fn():
            return run(x, steps, nlaunch, grid)
    res = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, (out if graph else res)


def tables(x, graph):
    """The reference's four tables as lines, and {config: seconds}."""
    times = {c: timeit(x, *c, graph=graph)[0] for c in CONFIGS}
    base = times[CONFIGS[0]]
    lines = [f"1 launch, 1 block, 1 iter: {base * 1e3:.4f} ms"]
    for nl in (2, 4, 8):
        t = times[(1, nl, 1)]
        lines.append(f"{nl} launches: {t * 1e3:.4f} ms  (delta/launch "
                     f"{(t - base) / (nl - 1) * 1e3:.4f} ms)")
    for g in (64, 256, 1024):
        t = times[(1, 1, g)]
        lines.append(f"grid={g}: {t * 1e3:.4f} ms (delta/block {(t - base) / (g - 1) * 1e6:.4f} us)")
    for s in (1024, 8192):
        t = times[(s, 1, 1)]
        lines.append(f"steps={s}: {t * 1e3:.4f} ms (delta/iter {(t - base) / s * 1e9:.2f} ns)")
    return lines, times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("launch_lab: no CUDA card is available")
    x = torch.ones((8, LANES), dtype=torch.float32, device="cuda")
    print(torch.cuda.get_device_name(0))
    for graph in (False, True):
        print("one CUDA graph replay per chain:" if graph else "eager launches:")
        for line in tables(x, graph)[0]:
            print("  " + line)


if __name__ == "__main__":
    main()
