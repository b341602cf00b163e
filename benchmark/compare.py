"""How `correct` is decided: the plain reference's answers, and the numbers
compared with them.

Renders: the reference traces a sample of pixels of every image the
window rendered (drawn from the seed, the same count from each image)
with all of that image's samples, and the program's pixels there are
compared with it: `bad_px_frac`, the share of sampled pixels whose
largest channel error exceeds `pixel_rel_tol` of the pixel's largest
channel (at least 1e-2), and `mean_rel_err`, the summed absolute error
over the summed reference.

Train steps: the reference follows the window's first steps from the
same start, target and frames, and `loss_gap` (each step's loss), `grad1_gap` (the
first step's update over lr, which is the gradient as the RMS-normalised
update applies it) and `change_gap` (each trained field's change after
the checked steps, by its norm) compare them.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import scenes
from benchmark.reference import bsdf, pathtrace
from benchmark.reference.scene import Builder
from benchmark.reference.vecmath import precision


def sample_pixels(seed, image, n_pix, count):
    """`count` distinct flat pixel ids of image number `image` of a run
    with seed `seed`, out of n_pix."""
    s = seed % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, image, 0x5EED])
    return np.sort(rng.choice(n_pix, size=min(count, n_pix), replace=False))


def reference_scene(config, device, dtype):
    with precision(dtype):
        b = Builder()
        scenes.populate(b, config["scene"], bsdf.MATERIAL_TYPES)
        return b.build(device)


def reference_pixels(config, workload, pix, frames, device, dtype=torch.float32,
                     counts=None):
    """The reference's mean radiance [M, 3] (float32) of flat pixels `pix`
    of the images of CMJ frames `frames` (int64 [M] each)."""
    cam = scenes.camera(config["scene"], workload["width"], workload["height"])
    scene = reference_scene(config, device, dtype)
    with precision(dtype):
        rad = pathtrace.render_pixels(scene, cam, pix.to(device), frames.to(device),
                                      workload["spp"], workload["max_depth"],
                                      workload["rr_depth"],
                                      lanes=workload["check"]["ref_lanes"], counts=counts)
    return rad.float()


def render_numbers(prog, ref, images, tol):
    """[(name, value)] of the program's sampled pixels `prog` against the
    reference's `ref` (both [M, 3]); images: the image number of each
    pixel, for the per-image verdicts.  Returns (numbers, per-image bad
    shares)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    err = (prog - ref).abs().amax(dim=-1)
    scale = torch.clamp(ref.abs().amax(dim=-1), min=1e-2)
    bad = ~(err <= tol * scale)  # NaN counts as bad
    diff = (prog - ref).abs()
    diff = torch.where(torch.isfinite(diff), diff, torch.full_like(diff, float("inf")))
    mean_rel = float(diff.sum() / torch.clamp(ref.abs().sum(), min=1e-30))
    per_image = {}
    for i in torch.unique(images).tolist():
        sel = images == i
        per_image[i] = float(bad[sel].double().mean())
    return [("bad_px_frac", float(bad.double().mean())), ("mean_rel_err", mean_rel)], per_image


def train_numbers(prog, ref, lr):
    """[(name, value)] of the program's first steps in the window against
    the reference's.  prog, ref: {"loss": [K floats], "params": [K + 1 dicts
    {field: tensor}], the start first}."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    fields = list(ref["params"][0])
    g1 = 0.0
    for k in fields:
        dp = (prog["params"][0][k] - prog["params"][1][k]).double().cpu() / lr
        dr = (ref["params"][0][k] - ref["params"][1][k]).double().cpu() / lr
        g1 = max(g1, float((dp - dr).abs().max()))
    norms_p, norms_r = {}, {}
    for k in fields:
        norms_p[k] = float((prog["params"][-1][k] - prog["params"][0][k]).double().norm())
        norms_r[k] = float((ref["params"][-1][k] - ref["params"][0][k]).double().norm())
    median = float(np.median(list(norms_r.values())))
    change = max(abs(norms_p[k] - norms_r[k]) / max(norms_r[k], median, 1e-30) for k in fields)
    return [("loss_gap", loss_gap), ("grad1_gap", g1), ("change_gap", change)]


def with_limits(numbers, limits):
    return [(n, v, float(limits[n])) for n, v in numbers]
