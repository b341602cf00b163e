"""Entry "render": offline renders through the program's `render_image`.

Set-up builds the configuration's scene with the program's SceneBuilder,
loads the traversal kernels' library where the scene walks a BVH, and
warms up with one render at the cell's own shapes (frame seed - 1, not
checked).  Render i of the window takes CMJ frame seed + i; after each,
the pixels the check samples from it are gathered on the card.
"""
from __future__ import annotations

import torch

from benchmark import compare, scenes

UNIT = "render"


def program_scene(config, device):
    """(scene, prims) of the configuration, built by the program."""
    from aten_tpu_torch.scene.materials import MaterialType
    from aten_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    prims = scenes.populate(b, config["scene"], MaterialType.__members__)
    return b.build(device), prims


def program_camera(config, width, height):
    from aten_tpu_torch.core.camera import PinholeCamera

    c = scenes.camera(config["scene"], width, height)
    return PinholeCamera(origin=tuple(c["origin"]), lookat=tuple(c["lookat"]),
                         up=tuple(c.get("up", (0.0, 1.0, 0.0))), vfov_deg=c["vfov_deg"],
                         width=width, height=height)


def load_kernels(ctx, scene):
    """Load the traversal kernels' library, in its own span, where the
    program will walk the scene's BVH (more prims than its dense test
    takes)."""
    from aten_tpu_torch.accel import traverse
    from aten_tpu_torch.ops import traverse_cuda

    if scene["num_tris"] + scene["num_spheres"] > traverse.DENSE_MAX_PRIMS:
        with ctx.span("kernel_load"):
            if ctx.device.type == "cuda":
                traverse_cuda.load_library()


class Cell:
    def __init__(self, ctx):
        from aten_tpu_torch.integrator import pathtracer

        self.ctx = ctx
        w = ctx.workload
        self.pathtracer = pathtracer
        with ctx.span("scene_build"):
            self.scene, self.prims = program_scene(ctx.config, ctx.device)
            ctx.sync()
        load_kernels(ctx, self.scene)
        self.cam = program_camera(ctx.config, w["width"], w["height"])
        chk = w["check"]
        n_pix = w["width"] * w["height"]
        self.pixels = [torch.from_numpy(compare.sample_pixels(ctx.seed, i, n_pix,
                                                              chk["pixels_per_image"]))
                       .to(ctx.device) for i in range(chk["max_images"])]
        self.samples = []
        with ctx.span("warmup"):
            self.render(ctx.seed - 1)
            ctx.sync()

    def render(self, frame):
        w = self.ctx.workload
        return self.pathtracer.render_image(self.scene, self.cam, spp=w["spp"],
                                            max_depth=w["max_depth"], rr_depth=w["rr_depth"],
                                            frame=frame)

    def run_unit(self, i):
        img = self.render(self.ctx.seed + i)
        if i < len(self.pixels):
            self.samples.append(img.reshape(-1, 3)[self.pixels[i]])

    def end_to_end(self, units, seconds):
        w = self.ctx.workload
        return {"mpaths_per_s": units * w["width"] * w["height"] * w["spp"] / seconds / 1e6}

    def check(self):
        """Free the program's scene, trace the sampled pixels with the
        reference, and compare.  Also counts the reference's rays for
        the traversal roofline (counters "rays.closest", "rays.shadow",
        per render)."""
        ctx, w = self.ctx, self.ctx.workload
        prog = torch.cat(self.samples).float()
        n_img = len(self.samples)
        pix = torch.cat(self.pixels[:n_img])
        images = torch.repeat_interleave(torch.arange(n_img), self.pixels[0].numel())
        frames = ctx.seed + images.to(torch.int64)
        self.scene = self.samples = None
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        counts = {}
        ref = compare.reference_pixels(ctx.config, w, pix, frames, ctx.device, counts=counts)
        scale = w["width"] * w["height"] / pix.numel()
        ctx.counters["rays.closest"] = sum(counts["closest"]) * scale
        ctx.counters["rays.shadow"] = sum(counts.get("shadow", [0])) * scale
        ctx.counters["bounces"] = w["max_depth"]
        ctx.counters["num_tris"] = self.prims
        numbers, self.per_image = compare.render_numbers(prog, ref, images,
                                                         w["check"]["pixel_rel_tol"])
        return compare.with_limits(numbers, w["check"]["limits"])

    def failed(self):
        lim = self.ctx.workload["check"]["limits"]["bad_px_frac"]
        return sum(1 for v in self.per_image.values() if not v <= lim)
