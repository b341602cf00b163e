"""Row-band data parallelism and the inverse-rendering train step.

Counterpart of aten_tpu/parallel/mesh.py.  The reference shards the
image's rows over a `jax.sharding.Mesh` with `shard_map` and reduces with
`pmean`; the port runs one process per card in a `torch.distributed`
process group (gloo for CPU tensors, NCCL for CUDA ones) and reduces
with collectives.  A process's rank is its flat tile index: rank r traces
rows [r*H/n, (r+1)*H/n), as the reference's `_flat_device_index` orders
its (hosts, chips) devices.  Seeds use global pixel ids, so an n-process
render is bitwise the one-process render.

Where each reference function maps:
  * `distributed_init` (:47): `distributed_init`, which joins a group;
  * `make_mesh` (:35) and `make_global_mesh` (:70): `make_group`;
  * `replicate_global` (:94): `replicate_global`, a broadcast from rank 0;
  * `shard_rows_global` (:113): `shard_rows_global`, an all-gather of the
    ranks' row blocks;
  * `render_tiled` (:122), `TRAINABLE_FIELDS`, `_has_param`, `_get_param`,
    `_set_params` (:163-206) and `make_train_step` (:209) keep their names.

A group must serve the scene's device: gloo on a card, or NCCL on the
CPU, raises.  A failed collective is never caught.  Scenes with alpha or
stencil materials render and train through the same `_trace_paths`,
which detaches a punch-through ray's origin as the reference stops it.
"""
from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from aten_tpu_torch.integrator.pathtracer import _trace_paths, check_scene
from aten_tpu_torch.scene.scene import Scene
from aten_tpu_torch.utils import spans

# the backend a group needs for tensors of each device type
BACKEND_OF = {"cpu": "gloo", "cuda": "nccl"}
# seconds a process waits for the others to join, or for a collective
TIMEOUT_S = 60


def distributed_init(init_method, world_size, rank, backend):
    """Join the process group of `world_size` processes as `rank`, e.g.
    init_method "tcp://127.0.0.1:<port>" and backend "gloo" or "nccl".
    Returns the group."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
    return dist.group.WORLD


def make_group():
    """The group over which rows shard: every joined process, or None
    when no group was joined (one process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def group_shape(group, device):
    """(processes, this process's rank) of `group` (None: one process),
    after checking that its backend serves `device`."""
    if group is None:
        return 1, 0
    backend = dist.get_backend(group)
    if BACKEND_OF.get(device.type) != backend:
        raise ValueError(f"a {backend} group cannot reduce {device.type} tensors "
                         f"(use {BACKEND_OF.get(device.type)})")
    return dist.get_world_size(group), dist.get_rank(group)


def _map_tensors(fn, tree):
    if isinstance(tree, Scene):
        return Scene(_map_tensors(fn, tree.arrays), tree.static, tree.device)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


def replicate_global(tree, group):
    """`tree` (a Scene, a dict of tensors or a tensor) with every tensor
    replaced by rank 0's copy; the caller's tensors are left as they are."""
    if group is None:
        return tree

    def bcast(x):
        group_shape(group, x.device)
        x = x.clone()
        dist.broadcast(x, dist.get_global_rank(group, 0), group=group)
        return x

    return _map_tensors(bcast, tree)


def shard_rows_global(x, group):
    """The ranks' row blocks `x` [rows, ...], concatenated in rank order."""
    if group is None:
        return x
    n, _ = group_shape(group, x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _band(height, group, device):
    n, rank = group_shape(group, device)
    assert height % n == 0, f"height {height} must divide into {n} row bands"
    tile_h = height // n
    return rank * tile_h, tile_h


def render_tiled(scene, cam_arrays, width, height, frame, sample, spp=1, max_depth=5,
                 rr_depth=3, group=None):
    """One sample of the image [height, width, 3], each process of
    `group` tracing its own band of rows; every process gets the whole
    image."""
    check_scene(scene)
    y0, tile_h = _band(height, group, scene.device)
    rad = _trace_paths(scene, cam_arrays, width, height, frame, sample, spp, max_depth,
                       rr_depth, y0=y0, tile_h=tile_h)
    return shard_rows_global(rad.reshape(tile_h, width, 3), group)


# Parameters trained by default, "<group>.<field>" over the scene: a
# material-table field (bare names), a light-table field (le, pos) or the
# texture stack ("textures.tex_stack").  Fields a scene lacks are skipped.
TRAINABLE_FIELDS = ("base_color", "textures.tex_stack", "lights.le")


def _split(spec):
    group, _, field = spec.partition(".")
    return ("materials", group) if not field else (group, field)


def _has_param(scene, spec):
    group, field = _split(spec)
    if group == "textures":
        return field in scene
    return group in scene and field in scene[group]


def _get_param(scene, spec):
    group, field = _split(spec)
    return scene[field] if group == "textures" else scene[group][field]


def _set_params(scene, params):
    """A new Scene with the fields `params` ({spec: tensor}) replaced; the
    other arrays, the packed kernel records among them, are shared."""
    arrays = dict(scene.arrays)
    for spec, v in params.items():
        group, field = _split(spec)
        if group == "textures":
            arrays[field] = v
        else:
            if arrays[group] is scene.arrays[group]:
                arrays[group] = dict(arrays[group])
            arrays[group][field] = v
    return Scene(arrays, scene.static, scene.device)


def band_loss_and_grads(scene, cam_arrays, target, frame, width, height, spp, max_depth,
                        rr_depth, fields=TRAINABLE_FIELDS, group=None):
    """The train step's forward and backward pass: this process's band of
    sample 0 against the same rows of `target` [height, width, 3], L2
    loss, gradients of the scene's live `fields`, each averaged over the
    group.  Returns (loss, {spec: grad}), detached.  The render and the
    loss are the "forward" span, `torch.autograd.grad` the "backward"
    span (utils/spans.py)."""
    y0, tile_h = _band(height, group, scene.device)
    live = [k for k in fields if _has_param(scene, k)]
    params = {k: _get_param(scene, k).detach().requires_grad_(True) for k in live}
    with spans.span("forward"):
        rad = _trace_paths(_set_params(scene, params), cam_arrays, width, height, frame, 0,
                           spp, max_depth, rr_depth, y0=y0, tile_h=tile_h)
        img = rad.reshape(tile_h, width, 3)
        loss = torch.mean((img - target[y0:y0 + tile_h]) ** 2)
    with spans.span("backward"):
        grads = torch.autograd.grad(loss, [params[k] for k in live], allow_unused=True)
    grads = [torch.zeros_like(params[k]) if g is None else g for k, g in zip(live, grads)]
    loss = loss.detach()
    if group is not None:
        # one all-reduce of the loss and every gradient, then the mean
        n = dist.get_world_size(group)
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / n
        loss = flat[0]
        at, grads = 1, []
        for k in live:
            size = params[k].numel()
            grads.append(flat[at:at + size].reshape(params[k].shape))
            at += size
    return loss, dict(zip(live, grads))


def rms_update(scene, grads, lr):
    """The scene after one RMS-normalised step p - lr * g / rms(g) on each
    field of `grads`, albedos and texels clipped at 0."""
    new = {}
    for k, g in grads.items():
        rms = torch.sqrt(torch.mean(g * g) + 1e-12)
        p = _get_param(scene, k).detach() - lr * g / rms
        if k.endswith("base_color") or k == "textures.tex_stack":
            p = torch.clamp(p, min=0.0)
        new[k] = p
    return _set_params(scene, new)


def make_train_step(width, height, spp=1, max_depth=3, rr_depth=2, group=None, lr=0.05,
                    fields=TRAINABLE_FIELDS):
    """The inverse-rendering step: render each process's band of rows,
    L2 loss against `target`, gradients of the trainable fields averaged
    over `group`, then an RMS-normalised update (no optimizer state, as in
    the reference).  Returns step(scene, cam_arrays, target, frame) ->
    (loss, new scene), both detached; target is the whole [height, width,
    3] image on the scene's device.  A step is the "step" root span
    (utils/spans.py)."""
    fields = tuple(fields)

    def step(scene, cam_arrays, target, frame):
        with spans.span("step", scene.device):
            check_scene(scene)
            loss, grads = band_loss_and_grads(scene, cam_arrays, target, frame, width,
                                              height, spp, max_depth, rr_depth, fields, group)
            return loss, rms_update(scene, grads, lr)

    return step
