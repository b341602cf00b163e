"""Entry "train": the program's inverse-rendering step from
`parallel.mesh.make_train_step`, in a closed loop.

Set-up builds the scene, loads the traversal kernels' library where the
scene walks a BVH, renders the target from the true fields, scales the
true base colours by a factor drawn from the seed (the start), and warms
up with one step from the start at a frame the window does not take (the
target's frame + 1), whose result it drops.
The window then steps from the start, step k taking frame seed + k.  It
keeps the loss and the trained fields of its first `checked_steps` steps,
which the reference follows from the same start, and of its last step
with the fields before it, from which the reference takes that one step:
so a step that drifts later in the window is checked too.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import compare, scenes
from benchmark.entries import render as render_entry
from benchmark.reference import pathtrace
from benchmark.reference import train as ref_train
from benchmark.reference.vecmath import precision

UNIT = "step"


def start_scale(seed, lo_hi):
    """The factor in [lo, hi) the seed scales the true base colours by."""
    lo, hi = lo_hi
    s = seed % (1 << 64)
    u = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, 0x57A7]).random()
    return lo + (hi - lo) * float(u)


class Cell:
    def __init__(self, ctx):
        from aten_tpu_torch.integrator import pathtracer
        from aten_tpu_torch.parallel import mesh

        self.ctx = ctx
        w = ctx.workload
        with ctx.span("scene_build"):
            scene, _ = render_entry.program_scene(ctx.config, ctx.device)
            ctx.sync()
        render_entry.load_kernels(ctx, scene)
        self.cam = render_entry.program_camera(ctx.config, w["width"], w["height"])
        self.cam_arrays = self.cam.arrays(ctx.device)
        tg = w["target"]
        with ctx.span("warmup"):
            self.target = pathtracer.render_image(scene, self.cam, spp=tg["spp"],
                                                  max_depth=tg["max_depth"],
                                                  rr_depth=tg["rr_depth"],
                                                  frame=ctx.seed + tg["frame_offset"])
            self.factor = start_scale(ctx.seed, w["start_scale"])
            mats = dict(scene["materials"])
            mats["base_color"] = mats["base_color"] * self.factor
            self.scene = scene.replace(materials=mats)
            self.step = mesh.make_train_step(w["width"], w["height"], spp=w["spp"],
                                             max_depth=w["max_depth"], rr_depth=w["rr_depth"],
                                             lr=w["lr"], fields=tuple(w["fields"]))
            self.step(self.scene, self.cam_arrays, self.target,
                      ctx.seed + tg["frame_offset"] + 1)
            ctx.sync()
        self.before = self.fields(self.scene)
        self.window = {"loss": [], "params": [self.before]}
        self.last = None  # the window's last step past the checked ones

    def fields(self, scene):
        return {k: scene[ref_train.FIELDS[k][0]][ref_train.FIELDS[k][1]].detach().clone()
                for k in self.ctx.workload["fields"]}

    def run_unit(self, i):
        loss, self.scene = self.step(self.scene, self.cam_arrays, self.target, self.ctx.seed + i)
        after = self.fields(self.scene)
        if i < self.ctx.workload["check"]["checked_steps"]:
            self.window["loss"].append(loss)
            self.window["params"].append(after)
        else:
            self.last = {"frame": self.ctx.seed + i, "loss": [loss],
                         "params": [self.before, after]}
        self.before = after

    def end_to_end(self, units, seconds):
        return {"train_step_ms": seconds * 1e3 / units}

    def check(self):
        """Free the program's state; the reference follows the window's
        first steps from the same start, target fields and frames, and its
        last step from the program's fields before it."""
        ctx, w = self.ctx, self.ctx.workload
        self.scene = self.target = self.step = None
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        self.window["loss"] = [float(x) for x in self.window["loss"]]
        last = None
        if self.last is not None:
            self.last["loss"] = [float(x) for x in self.last["loss"]]
            last = (self.last["frame"], self.last["params"][0])
        self.ref = reference_steps(ctx.config, w, ctx.seed, ctx.device, self.factor,
                                   n_steps=len(self.window["loss"]), last=last)
        numbers = compare.train_numbers(self.window, self.ref, w["lr"])
        if last is not None:
            at_last = compare.train_numbers(self.last, self.ref["last"], w["lr"])
            numbers = [(n, max(a, b) if math.isfinite(a) and math.isfinite(b) else math.nan)
                       for (n, a), (_, b) in zip(numbers, at_last)]
        return compare.with_limits(numbers, w["check"]["limits"])

    def failed(self):
        lim = self.ctx.workload["check"]["limits"]["loss_gap"]
        pairs = list(zip(self.window["loss"], self.ref["loss"]))
        if self.last is not None:
            pairs += list(zip(self.last["loss"], self.ref["last"]["loss"]))
        return sum(1 for a, b in pairs if not abs(a - b) <= lim * abs(b))


def reference_steps(config, w, seed, device, factor, dtype=torch.float32, fault=None,
                    n_steps=None, last=None):
    """The reference's target render and its first `n_steps` steps (by
    default the checked steps; fault: see reference/train.py's `steps`).
    last: (frame, {field: tensor}), one more step from those fields at that
    frame, under the key "last"."""
    scene = compare.reference_scene(config, device, dtype)
    cam = scenes.camera(config["scene"], w["width"], w["height"])
    tg = w["target"]
    n = w["width"] * w["height"]
    with precision(dtype):
        target = pathtrace.render_pixels(
            scene, cam, torch.arange(n, device=device),
            torch.full((n,), seed + tg["frame_offset"], dtype=torch.int64, device=device),
            tg["spp"], tg["max_depth"], tg["rr_depth"], lanes=n)
        target = target.reshape(w["height"], w["width"], 3)
        start = ref_train.get_params(scene, w["fields"])
        start["base_color"] = start["base_color"] * factor
        n_steps = w["check"]["checked_steps"] if n_steps is None else n_steps
        frames = [seed + k for k in range(n_steps)]
        out = ref_train.steps(scene, cam, target, frames, w["spp"], w["max_depth"],
                              w["rr_depth"], w["lr"], start, fault=fault)
        if last is not None:
            frame, before = last
            before = {k: v.to(device=device, dtype=dtype) for k, v in before.items()}
            out["last"] = ref_train.steps(scene, cam, target, [frame], w["spp"], w["max_depth"],
                                          w["rr_depth"], w["lr"], before, fault=fault)
    for o in (out, out.get("last")):
        if o is not None:
            o["params"] = [{k: v.float() for k, v in p.items()} for p in o["params"]]
    return out
