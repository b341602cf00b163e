"""Radiance RGBE (.hdr) reader and writer in plain NumPy.

Counterpart of aten_tpu/io/hdr.py (a copy: the port imports nothing of
aten_tpu): the `32-bit_rle_rgbe` format with new-style per-scanline RLE
and flat scanlines, the same bytes written and the same values read,
as float32 (the reference's reader returns them as float64).
"""
from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe):
    """[...,4] uint8 RGBE -> [...,3] float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128-8)
    # the product is float64 under NumPy's promotion, and exact in float32
    # (a 9-bit mantissa times a power of two)
    return ((rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]).astype(np.float32)


def _float_to_rgbe(rgb):
    """[...,3] float32 -> [...,4] uint8 RGBE."""
    rgb = np.maximum(rgb, 0.0).astype(np.float32)
    m = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = m >= 1e-32
    mant, expo = np.frexp(np.where(nz, m, 1.0))
    scale = mant * 256.0 / np.where(nz, m, 1.0)
    out[..., 0] = np.where(nz, np.minimum(rgb[..., 0] * scale, 255), 0).astype(np.uint8)
    out[..., 1] = np.where(nz, np.minimum(rgb[..., 1] * scale, 255), 0).astype(np.uint8)
    out[..., 2] = np.where(nz, np.minimum(rgb[..., 2] * scale, 255), 0).astype(np.uint8)
    out[..., 3] = np.where(nz, expo + 128, 0).astype(np.uint8)
    return out


def read_hdr(path):
    """Load a Radiance .hdr file -> [H,W,3] float32 (linear)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # header ends at blank line; next line is the resolution string
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported orientation {res}")
    H, W = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)
    img = np.empty((H, W, 4), np.uint8)
    i = 0
    for y in range(H):
        if W >= 8 and W < 32768 and buf[i] == 2 and buf[i + 1] == 2:
            # new-style RLE: per-channel runs
            assert (int(buf[i + 2]) << 8 | int(buf[i + 3])) == W
            i += 4
            for c in range(4):
                x = 0
                while x < W:
                    n = int(buf[i])
                    if n > 128:  # run
                        img[y, x : x + n - 128, c] = buf[i + 1]
                        x += n - 128
                        i += 2
                    else:  # literal
                        img[y, x : x + n, c] = buf[i + 1 : i + 1 + n]
                        x += n
                        i += 1 + n
        else:
            # flat scanline
            img[y] = buf[i : i + 4 * W].reshape(W, 4)
            i += 4 * W
    return _rgbe_to_float(img)


def _rle_encode_channel(ch):
    """New-style RLE of one scanline channel (runs >= 4, literals <= 128)."""
    out = bytearray()
    W = len(ch)
    x = 0
    while x < W:
        # find run length at x
        run = 1
        while x + run < W and run < 127 and ch[x + run] == ch[x]:
            run += 1
        if run >= 4:
            out.append(128 + run)
            out.append(int(ch[x]))
            x += run
        else:
            # literal: up to 128, stop early at a worthwhile run
            start = x
            while x < W and x - start < 128:
                r = 1
                while x + r < W and r < 4 and ch[x + r] == ch[x]:
                    r += 1
                if r >= 4:
                    break
                x += 1
            n = x - start
            out.append(n)
            out.extend(int(v) for v in ch[start:x])
    return bytes(out)


def write_hdr(path, img, rle=True):
    """Save [H,W,3] float32 -> Radiance .hdr (new-style RLE scanlines by
    default; rle=False emits flat RGBE)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    rgbe = _float_to_rgbe(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        if not rle or W < 8 or W >= 32768:
            f.write(rgbe.tobytes())
            return
        for y in range(H):
            f.write(bytes([2, 2, (W >> 8) & 0xFF, W & 0xFF]))
            for c in range(4):
                f.write(_rle_encode_channel(rgbe[y, :, c]))
