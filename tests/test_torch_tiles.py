"""The process group of aten_tpu_torch.parallel.mesh on the CPU.

* Two processes in a gloo group on this machine's CPU, the counterpart
  of tests/test_multihost.py (32x32 Cornell, 1 spp, depth 2, RR depth 1,
  two train steps toward a black target): `render_tiled` is bitwise the
  one-process render, and each step's loss and new fields are within
  rtol 1e-6 of the one-process step (only the all-reduce's summation
  order differs).  The workers also check `replicate_global`,
  `shard_rows_global`, the refusal of a group whose backend cannot
  serve the tensors' device, and of a height the group cannot split.
* One process needs no group.  (The bands themselves are held against
  the reference in tests/test_torch_bands.py.)

The workers are spawned processes that import this module, so it
imports no JAX at module level.  Each joins the group with a 60 s
timeout, and the test waits at most 120 s for them, so a hang fails the
test instead of eating the suite's time.
"""
import socket
import traceback

import numpy as np
import pytest
import torch

from aten_tpu_torch.integrator.pathtracer import _trace_paths
from aten_tpu_torch.parallel import mesh
from aten_tpu_torch.scene import scenedefs as tdefs

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

W = H = 32
WORLD = 2
WAIT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- two processes in a gloo group -----------------------------------------


def _run(group):
    """What each process computes: the tiled render and two train steps
    (the one-process run passes group=None)."""
    scene, cam = tdefs.cornell_box(W, H, device="cpu")
    ca = cam.arrays("cpu")
    img = mesh.render_tiled(scene, ca, W, H, 0, 0, spp=1, max_depth=2, rr_depth=1, group=group)
    step = mesh.make_train_step(W, H, spp=1, max_depth=2, rr_depth=1, group=group)
    target = torch.zeros((H, W, 3))
    loss, s2 = step(scene, ca, target, 0)
    loss2, s3 = step(s2, ca, target, 1)
    out = {"img": img.numpy(), "loss": float(loss), "loss2": float(loss2)}
    for i, s in ((1, s2), (2, s3)):
        for k in mesh.TRAINABLE_FIELDS:
            if mesh._has_param(s, k):
                out[f"{k}@{i}"] = mesh._get_param(s, k).numpy()
    return out


def _worker(rank, port, queue):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        group = mesh.distributed_init(f"tcp://127.0.0.1:{port}", WORLD, rank, "gloo")
        assert mesh.make_group() is group
        out = _run(group)
        # replicate_global hands every rank rank 0's tensors
        mine = torch.full((3, 2), float(rank + 1))
        out["replicated"] = mesh.replicate_global({"a": {"b": mine}}, group)["a"]["b"].numpy()
        out["mine_kept"] = float(mine[0, 0])
        out["rows"] = mesh.shard_rows_global(torch.full((2, 4), float(rank)), group).numpy()
        try:
            mesh.group_shape(group, torch.device("cuda", 0))
            out["refused_cuda"] = False
        except ValueError:
            out["refused_cuda"] = True
        scene, cam = tdefs.cornell_box(W, H + 1, device="cpu")
        try:
            mesh.render_tiled(scene, cam.arrays("cpu"), W, H + 1, 0, 0, group=group)
            out["refused_odd"] = False
        except AssertionError:
            out["refused_odd"] = True
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks():
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, queue)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=WAIT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    for rank, out in sorted(got.items()):
        assert isinstance(out, dict), f"rank {rank} failed:\n{out}"
    return [got[r] for r in range(WORLD)], _run(None)


def test_two_rank_render_is_the_one_process_render(two_ranks):
    ranks, single = two_ranks
    for out in ranks:
        np.testing.assert_array_equal(out["img"], single["img"])
    scene, cam = tdefs.cornell_box(W, H, device="cpu")
    whole = _trace_paths(scene, cam.arrays("cpu"), W, H, 0, 0, 1, 2, 1).reshape(H, W, 3)
    np.testing.assert_array_equal(single["img"], whole.numpy())


def test_two_rank_train_step_matches_one_process(two_ranks):
    ranks, single = two_ranks
    fields = [k for k in single if "@" in k]
    assert sorted(fields) == ["base_color@1", "base_color@2", "lights.le@1", "lights.le@2"]
    for out in ranks:
        assert set(out) >= set(single)
        for k in ("loss", "loss2"):
            np.testing.assert_allclose(out[k], single[k], rtol=1e-6, err_msg=k)
        for k in fields:
            np.testing.assert_allclose(out[k], single[k], rtol=1e-6, atol=1e-7, err_msg=k)
    # both ranks hold the same scene after the all-reduce
    for k in fields + ["loss", "loss2"]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    assert single["loss2"] < single["loss"]


def test_two_rank_collectives(two_ranks):
    ranks, _ = two_ranks
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out["replicated"], np.full((3, 2), 1.0, np.float32))
        assert out["mine_kept"] == rank + 1
        np.testing.assert_array_equal(out["rows"], np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((1, 4), np.float32))
        assert out["refused_cuda"] and out["refused_odd"]


def test_one_process_needs_no_group():
    assert mesh.make_group() is None
    assert mesh.group_shape(None, torch.device("cpu")) == (1, 0)
    x = torch.ones(2, 3)
    assert mesh.shard_rows_global(x, None) is x and mesh.replicate_global(x, None) is x
