"""Renderer CLI: the counterpart of aten_tpu/cli/render.py (the
reference's renderer apps, with a runtime --scene in place of their
compile-time scene selection), on the card unless --device cpu.

    python -m aten_tpu_torch.cli.render --scene cornell --spp 100 -o out.hdr
    python -m aten_tpu_torch.cli.render --obj model.obj --integrator ao ...
    python -m aten_tpu_torch.cli.render --scene cornell --checkpoint st.npz \
        --spp 8   # resumes if the checkpoint exists, saves on exit

The path tracer (`pt`) renders one `render_sample` call a sample with
frame and sample = the film's count, so a run resumed from a checkpoint
continues the same sample sequence.  --stats prints Mrays/s, ms a frame
and the seconds of the render, timed to a synchronize on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCENES = {
    "cornell": "cornell_box",
    "mtrl_test": "material_test_scene",
    "obj_cornell": "obj_cornell_box",
    "dragon": "dragon_scene",
    "sponza": "sponza_scene",
    "volume": "homogeneous_volume_scene",
    "volume_grid": "hetero_volume_scene",
    "many_light": "many_light_scene",
    "crytek": "crytek_class_scene",
    "toon": "toon_scene",
}


def build_parser():
    p = argparse.ArgumentParser(
        prog="aten_tpu_torch.cli.render", description=__doc__.split("\n")[0]
    )
    p.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    p.add_argument("--obj", help=".obj file to render instead of --scene")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--rr-depth", type=int, default=3)
    p.add_argument(
        "--integrator",
        choices=["pt", "svgf", "restir", "ao", "npr", "volume"],
        default="pt",
    )
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--tonemap", choices=["gamma", "gt", "srgb", "none"],
                   default="gamma")
    p.add_argument("--checkpoint", help="progressive-state file (.npz)")
    p.add_argument("--camera", nargs=6, type=float, metavar="V",
                   help="origin xyz + lookat xyz (obj scenes)")
    p.add_argument("--camera-type", choices=["pinhole", "thinlens", "equirect"],
                   default="pinhole",
                   help="thinlens adds depth of field (--lens-radius/"
                        "--focus-dist); equirect renders a 360 lat-long")
    p.add_argument("--lens-radius", type=float, default=0.05)
    p.add_argument("--focus-dist", type=float, default=0.0,
                   help="0 = focus at the lookat point")
    p.add_argument("--vfov", type=float, default=45.0)
    p.add_argument("--sampler", choices=["cmj", "bluenoise"], default="cmj",
                   help="bluenoise uses void-and-cluster masks for the "
                        "pixel jitter + BSDF dims")
    p.add_argument("--restir-direct-only", action="store_true",
                   help="ReSTIR without the PT bounce composition "
                        "(reservoir direct lighting debug view)")
    p.add_argument("--stats", action="store_true",
                   help="print Mrays/s + ms/frame")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the scene and the render live (default: the card)")
    return p


def make_scene(args):
    """(scene on args.device, camera) of --obj or --scene."""
    from aten_tpu_torch.scene import scenedefs

    if args.obj:
        import numpy as np

        from aten_tpu_torch.core.camera import PinholeCamera
        from aten_tpu_torch.scene.objloader import load_obj
        from aten_tpu_torch.scene.scene import SceneBuilder

        sb = SceneBuilder()
        load_obj(sb, args.obj)
        sb.set_background((1.0, 1.0, 1.0))
        scene = sb.build(args.device)
        if args.camera:
            o, la = args.camera[:3], args.camera[3:]
        else:
            # frame the model: eye back along +z from the bbox
            v0 = scene["tri_v0"].cpu().numpy()
            lo, hi = v0.min(0), v0.max(0)
            c = (lo + hi) / 2
            r = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
            o, la = (c[0], c[1], c[2] + 3 * r), tuple(c)
        cam = PinholeCamera(origin=tuple(o), lookat=tuple(la), vfov_deg=args.vfov,
                            width=args.width, height=args.height)
        return scene, _convert_camera(cam, args)
    fn = getattr(scenedefs, SCENES[args.scene])
    scene, cam = fn(args.width, args.height, device=args.device)
    return scene, _convert_camera(cam, args)


def _convert_camera(cam, args):
    """Re-seat the scene's pinhole camera as the requested type."""
    import numpy as np

    from aten_tpu_torch.core.camera import EquirectCamera, PinholeCamera, ThinLensCamera

    if args.camera_type == "pinhole" or not isinstance(cam, PinholeCamera):
        return cam
    if args.camera_type == "equirect":
        return EquirectCamera(origin=cam.origin, lookat=cam.lookat,
                              width=args.width, height=args.height)
    focus = args.focus_dist or float(
        np.linalg.norm(np.asarray(cam.lookat) - np.asarray(cam.origin))
    )
    return ThinLensCamera(
        origin=cam.origin, lookat=cam.lookat, vfov_deg=cam.vfov_deg,
        width=args.width, height=args.height,
        lens_radius=args.lens_radius, focus_dist=focus,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from aten_tpu_torch.integrator.film import Film
    from aten_tpu_torch.io.image import save_image
    from aten_tpu_torch.utils.checkpoint import (
        load_checkpoint, render_state, restore_render_state, save_checkpoint)

    scene, cam = make_scene(args)
    dev = scene.device
    W, H = cam.width, cam.height
    film = Film(H, W, dev)
    frame = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        frame, _ = restore_render_state(load_checkpoint(args.checkpoint, dev), film)
        print(f"resumed: {film.count} samples, frame {frame}", file=sys.stderr)

    def synchronize():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    synchronize()
    t0 = time.perf_counter()
    if args.integrator == "pt":
        from aten_tpu_torch.core.camera import camera_type_of
        from aten_tpu_torch.integrator.pathtracer import render_sample

        ca = cam.arrays(dev)
        for _ in range(args.spp):
            film.accumulate(
                render_sample(scene, ca, W, H, frame, film.count, args.spp,
                              args.max_depth, args.rr_depth,
                              cam_type=camera_type_of(cam), sampler=args.sampler))
        img = film.image()
    elif args.integrator == "svgf":
        from aten_tpu_torch.denoise.svgf import SVGFDenoiser
        from aten_tpu_torch.integrator.pathtracer import render_sample_with_aovs

        den = SVGFDenoiser(W, H, device=dev)
        ca = cam.arrays(dev)
        img = None
        for f in range(args.spp):  # spp frames at 1 spp, denoised
            rad, aovs = render_sample_with_aovs(scene, ca, W, H, f, 0, 1,
                                                args.max_depth, args.rr_depth)
            img = den.step(rad, aovs, cam)
    elif args.integrator == "restir":
        from aten_tpu_torch.integrator.restir import ReSTIRRenderer

        r = ReSTIRRenderer(scene, cam, gi=not args.restir_direct_only,
                           max_depth=args.max_depth, rr_depth=args.rr_depth)
        for _ in range(args.spp):
            img = r.render_frame()
    elif args.integrator == "ao":
        from aten_tpu_torch.integrator.ao import render_ao

        img = render_ao(scene, cam, spp=args.spp)
    elif args.integrator == "npr":
        from aten_tpu_torch.integrator.npr import render_npr

        img = render_npr(scene, cam)
    else:
        from aten_tpu_torch.integrator.volpt import render_volpt

        img = render_volpt(scene, cam, spp=args.spp, max_depth=args.max_depth)
    synchronize()
    dt = time.perf_counter() - t0

    if args.stats:
        rays = W * H * args.spp
        print(json.dumps({
            "mrays_per_sec": rays / dt / 1e6,
            "ms_per_frame": dt * 1000.0 / max(args.spp, 1),
            "elapsed_s": dt,
        }))

    if args.checkpoint and args.integrator == "pt":
        save_checkpoint(args.checkpoint, render_state(film, frame + 1))

    np_img = img.detach().cpu().numpy()
    if args.tonemap == "gt":
        from aten_tpu_torch.display.tonemap import gt_tonemap, srgb_oetf

        np_img = srgb_oetf(gt_tonemap(torch.from_numpy(np_img))).numpy()
        save_image(args.output, _delinearize(np_img))
    else:  # gamma, srgb, none: save_image applies sRGB for LDR
        save_image(args.output, np_img)
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def _delinearize(display_referred):
    """Invert save_image's sRGB encode for already-display-referred data."""
    import numpy as np

    x = np.clip(display_referred, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


if __name__ == "__main__":
    sys.exit(main())
