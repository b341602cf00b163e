"""Height (bump) map to tangent-space normal map: the counterpart of
aten_tpu/cli/bump2normal.py (the reference's Bump2Normal): central
differences of the height packed into [0, 1] RGB, with torch on --device
(the card unless --device cpu).

    python -m aten_tpu_torch.cli.bump2normal height.png -o normal.png --scale 2
"""
from __future__ import annotations

import argparse
import sys

import torch


def bump_to_normal(height, scale=1.0):
    """height [H, W] (0..1) -> normal map [H, W, 3] in [0, 1], float32 on
    the height's device."""
    h = torch.as_tensor(height, dtype=torch.float32)
    dx = (torch.roll(h, -1, dims=1) - torch.roll(h, 1, dims=1)) * 0.5 * scale
    dy = (torch.roll(h, -1, dims=0) - torch.roll(h, 1, dims=0)) * 0.5 * scale
    n = torch.stack([-dx, dy, torch.ones_like(h)], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n * 0.5 + 0.5


def main(argv=None):
    p = argparse.ArgumentParser(prog="aten_tpu_torch.cli.bump2normal")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from aten_tpu_torch.device import resolve_device
    from aten_tpu_torch.io.image import load_image, save_image

    dev = resolve_device(args.device)
    img = torch.from_numpy(load_image(args.input, srgb_to_linear=False)).to(dev)
    n = bump_to_normal(img.mean(dim=-1), args.scale)
    # normal maps are data: undo save_image's sRGB encode
    x = torch.clamp(n, 0.0, 1.0)
    lin = torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    save_image(args.output, lin.cpu().numpy())
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
