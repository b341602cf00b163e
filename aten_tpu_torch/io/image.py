"""Image loading and saving, and textures from image files.

Counterpart of aten_tpu/io/image.py.  Radiance .hdr goes through
io/hdr.py; LDR formats (png, jpg, tga, bmp, ...) through Pillow, which
is imported only when an LDR file is read or written: a machine without
Pillow loads and saves .hdr files, and an LDR file there raises an
ImportError that names it.  Loaded images are linear float32 RGB arrays,
ready for `SceneBuilder.add_texture`.
"""
from __future__ import annotations

import os

import numpy as np

from aten_tpu_torch.io.hdr import read_hdr, write_hdr


def _pil(path):
    """Pillow's Image module, or an ImportError naming `path`."""
    try:
        import PIL.Image
    except ImportError as e:
        raise ImportError(
            f"{path}: LDR images need Pillow (PIL), which is not installed; "
            "Radiance .hdr files need nothing") from e
    return PIL.Image


def load_image(path, srgb_to_linear=True):
    """Load an image file -> [H, W, 3] float32.

    LDR files are converted from sRGB to linear unless srgb_to_linear is
    False (for data maps: normals, roughness)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    image = _pil(path)
    with image.open(path) as im:
        img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    if srgb_to_linear:
        img = np.where(
            img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
        ).astype(np.float32)
    return img


def save_image(path, img):
    """Save [H, W, 3] float32: .hdr keeps linear radiance; LDR formats get
    the sRGB transfer function."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".hdr":
        write_hdr(path, img)
        return
    image = _pil(path)
    x = np.clip(img, 0.0, 1.0)
    x = np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)
    image.fromarray((x * 255.0 + 0.5).astype(np.uint8)).save(path)


def load_texture(builder, path, srgb_to_linear=True):
    """Load an image file and register it with the builder's texture
    table; returns the texture id."""
    return builder.add_texture(load_image(path, srgb_to_linear))
