"""Entry points for a compile check and a multi-process dry run: the
counterparts of the repository's `__graft_entry__.py`.

    python -m aten_tpu_torch.entry            # entry() on the card
    python -m aten_tpu_torch.entry --device cpu
    python -c "from aten_tpu_torch.entry import dryrun_multichip; dryrun_multichip(2)"
"""
from __future__ import annotations

import socket
import sys
import traceback

import torch

WIDTH = HEIGHT = 64
DRY_WIDTH = 32
DRY_ROWS = 4  # rows a rank traces in the dry run
DRY_WAIT_S = 300


def entry(device="cuda"):
    """(fn, example_args): one sample of the flagship pipeline, the
    Cornell box's NEE path trace at 64x64, depth 3, RR depth 2, through
    `_trace_paths`, on `device` (the card unless the caller names the
    CPU).  fn(scene, cam_arrays, frame, sample) -> [64, 64, 3]."""
    from aten_tpu_torch.integrator.pathtracer import _trace_paths
    from aten_tpu_torch.scene.scenedefs import cornell_box

    scene, cam = cornell_box(WIDTH, HEIGHT, device=device)

    def fn(scene, cam_arrays, frame, sample):
        rad = _trace_paths(scene, cam_arrays, WIDTH, HEIGHT, frame, sample,
                           spp=1, max_depth=3, rr_depth=2)
        return rad.reshape(HEIGHT, WIDTH, 3)

    return fn, (scene, cam.arrays(scene.device), 0, 0)


def _dry_step(group, height):
    """The tiled render and one train step of the dry run, on the CPU."""
    from aten_tpu_torch.parallel import mesh
    from aten_tpu_torch.scene.scenedefs import cornell_box

    scene, cam = cornell_box(DRY_WIDTH, height, device="cpu")
    ca = cam.arrays("cpu")
    img = mesh.render_tiled(scene, ca, DRY_WIDTH, height, 0, 0, spp=1, max_depth=2,
                            rr_depth=1, group=group)
    step = mesh.make_train_step(DRY_WIDTH, height, spp=1, max_depth=2, rr_depth=1,
                                group=group)
    loss, _ = step(scene, ca, torch.zeros((height, DRY_WIDTH, 3)), 0)
    return img, float(loss)


def _dry_worker(rank, n, port, queue):
    import torch.distributed as dist

    from aten_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    try:
        group = mesh.distributed_init(f"tcp://127.0.0.1:{port}", n, rank, "gloo")
        img, loss = _dry_step(group, DRY_ROWS * n)
        queue.put((rank, (img, loss)))
    except Exception:  # reported to the parent, which raises
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """The multi-device path as a dry run on the CPU, explicitly: n_devices
    processes join a gloo group on a loopback port, render a 32 x 4n
    Cornell box tiled by rows and take one train step (render, loss,
    gradients all-reduced, update).  Asserts that each rank's loss is
    finite and that each rank's tiled image is bitwise the one-process
    image.  A run across cards goes through the same functions with an
    NCCL group (parallel/mesh.py)."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_dry_worker, args=(r, n_devices, port, queue))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=DRY_WAIT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    img1, _ = _dry_step(None, DRY_ROWS * n_devices)
    for rank in range(n_devices):
        out = got[rank]
        assert not isinstance(out, str), f"rank {rank} failed:\n{out}"
        img, loss = out
        assert img.shape == (DRY_ROWS * n_devices, DRY_WIDTH, 3)
        assert torch.isfinite(torch.tensor(loss)), (rank, loss)
        assert torch.equal(img, img1), f"rank {rank}'s tiled image differs"


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="aten_tpu_torch.entry")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry ok:", tuple(out.shape), float(out.mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
