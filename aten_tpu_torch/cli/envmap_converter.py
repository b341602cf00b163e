"""Environment-map projection converter: the counterpart of
aten_tpu/cli/envmap_converter.py (the reference's EnvmapConverter):
resamples equirectangular or mirror-ball images into equirectangular or
vertical-cross cubemap layouts, with torch on --device (the card unless
--device cpu), in float64 as the reference's numpy.

    python -m aten_tpu_torch.cli.envmap_converter in.hdr -o out.hdr \
        --from mirrorball --to equirect --width 1024
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

F64 = torch.float64


def _dirs_equirect(W, H, device):
    """[H, W, 3] float64 directions of an equirect image's pixel centres."""
    u = (torch.arange(W, dtype=F64, device=device) + 0.5) / W
    v = (torch.arange(H, dtype=F64, device=device) + 0.5) / H
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    phi = (uu - 0.5) * 2 * np.pi
    theta = vv * np.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], -1)


def _pick(img, x, y, W, H):
    x = torch.clamp(x.to(torch.int64), 0, W - 1)
    y = torch.clamp(y.to(torch.int64), 0, H - 1)
    return img[y, x]


def _sample_equirect(img, d):
    H, W = img.shape[:2]
    phi = torch.atan2(d[..., 0], -d[..., 2])
    theta = torch.acos(torch.clamp(d[..., 1], -1, 1))
    return _pick(img, (phi / (2 * np.pi) + 0.5) * W, theta / np.pi * H, W, H)


def _sample_mirrorball(img, d):
    """Mirror-ball photo: the ball at the origin seen from +z; direction d
    maps to the ball normal h = normalize(d + z)."""
    H, W = img.shape[:2]
    h = d + torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=d.device)
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-9)
    return _pick(img, (h[..., 0] * 0.5 + 0.5) * W, (-h[..., 1] * 0.5 + 0.5) * H, W, H)


_FACES = {  # vertical cross layout: (col, row), forward/right/up per face
    "+x": ((2, 1), [1, 0, 0], [0, 0, -1], [0, 1, 0]),
    "-x": ((0, 1), [-1, 0, 0], [0, 0, 1], [0, 1, 0]),
    "+y": ((1, 0), [0, 1, 0], [1, 0, 0], [0, 0, 1]),
    "-y": ((1, 2), [0, -1, 0], [1, 0, 0], [0, 0, -1]),
    "+z": ((1, 1), [0, 0, 1], [1, 0, 0], [0, 1, 0]),
    "-z": ((1, 3), [0, 0, -1], [-1, 0, 0], [0, 1, 0]),
}


def _cross_to_dirs(face_size, device):
    """(direction field [4s, 3s, 3] float32, face mask) of a 3x4 vertical
    cross."""
    s = face_size
    d = torch.zeros((4 * s, 3 * s, 3), dtype=torch.float32, device=device)
    mask = torch.zeros((4 * s, 3 * s), dtype=torch.bool, device=device)
    uv = (torch.arange(s, dtype=F64, device=device) + 0.5) / s * 2 - 1
    vv, uu = torch.meshgrid(uv, uv, indexing="ij")
    for (c, r), f, rt, up in _FACES.values():
        f, rt, up = (torch.tensor(x, dtype=torch.int64, device=device) for x in (f, rt, up))
        dirs = f[None, None] + uu[..., None] * rt + -vv[..., None] * up
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        d[r * s : (r + 1) * s, c * s : (c + 1) * s] = dirs.to(torch.float32)
        mask[r * s : (r + 1) * s, c * s : (c + 1) * s] = True
    return d, mask


def main(argv=None):
    p = argparse.ArgumentParser(prog="aten_tpu_torch.cli.envmap_converter")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--from", dest="src", default="equirect",
                   choices=["equirect", "mirrorball"])
    p.add_argument("--to", dest="dst", default="equirect",
                   choices=["equirect", "cross"])
    p.add_argument("--width", type=int, default=1024,
                   help="output width (equirect) or face size (cross)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from aten_tpu_torch.device import resolve_device
    from aten_tpu_torch.io.image import load_image, save_image

    dev = resolve_device(args.device)
    img = torch.from_numpy(
        load_image(args.input, srgb_to_linear=not args.input.endswith(".hdr"))).to(dev)
    sample = {"equirect": _sample_equirect, "mirrorball": _sample_mirrorball}[args.src]
    if args.dst == "equirect":
        out = sample(img, _dirs_equirect(args.width, args.width // 2, dev))
    else:
        d, mask = _cross_to_dirs(args.width, dev)
        out = torch.where(mask[..., None], sample(img, d), 0.0)
    out = out.to(torch.float32).cpu().numpy()
    save_image(args.output, out)
    print(f"wrote {args.output} {out.shape}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
