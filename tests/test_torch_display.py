"""The display passes (`aten_tpu_torch/display/`) against aten_tpu's.

* tonemap: gamma, srgb_oetf, exposure, gt_tonemap and magnifier on the
  same seeded images (HDR values in [0, 8), a few exact zeros and
  values on the sRGB knee) within rtol 1e-6 (atol 1e-7); the
  magnifier's lookup exactly.  gt_tonemap's output is at most about 1
  and its last 3x3 product (XYZ to sRGB, terms up to 3.24x) cancels:
  the port sums each row in float32 where XLA fuses the multiply-adds,
  and an ulp of the largest term, or of the curve's pow or exp, moves a
  channel near zero by up to 2.1e-6 (measured, 9.9e-7 beyond rtol 1e-6
  at worst): it holds within rtol 1e-6 and atol 1e-6, an ulp-scale
  bound on the output's own scale.
* atrous and taa_step against the reference run op by op
  (`jax.disable_jit()`; the jitted reference contracts multiply-adds)
  on seeded 32x32 images and G-buffers, within rtol 1e-5 (atol 1e-6) at
  every pixel; TAA over four frames of an orbiting camera, each frame's
  output and history.
* The reference's own display tests (gt_tonemap's properties, sRGB and
  gamma, the magnifier's ring and zoom, TAA on a static camera, a-trous
  keeping an edge), run on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import camera as jcam
from aten_tpu.display import atrous as jatrous
from aten_tpu.display import taa as jtaa
from aten_tpu.display import tonemap as jtone
from aten_tpu_torch.core import camera as tcam
from aten_tpu_torch.display import atrous as tatrous
from aten_tpu_torch.display import taa as ttaa
from aten_tpu_torch.display import tonemap as ttone

torch.set_num_threads(1)

H = W = 32
RTOL, ATOL = 1e-5, 1e-6
GT_ATOL = 1e-6  # gt_tonemap: an ulp-scale bound on its output's scale (about 1)


def _hdr(seed, shape=(H, W, 3)):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) ** 3 * 8.0).astype(np.float32)
    img.reshape(-1)[:16] = 0.0
    img.reshape(-1)[16:32] = np.float32(0.0031308)  # the sRGB knee
    return img


def _gbuffer(seed):
    """A G-buffer of two planes meeting at a depth edge, noisy colour."""
    rng = np.random.default_rng(seed)
    normal = np.zeros((H, W, 3), np.float32)
    normal[..., 2] = 1.0
    normal[:, W // 2:] = [0.0, 0.6, 0.8]
    normal += rng.normal(0, 0.02, normal.shape).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = np.full((H, W), 3.0, np.float32)
    depth[:, W // 2:] = 5.0 + np.linspace(0, 1, W // 2, dtype=np.float32)
    color = (0.4 + rng.normal(0, 0.15, (H, W, 3))).astype(np.float32)
    return color, normal, depth


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("op", ["gamma", "srgb_oetf", "exposure", "gt_tonemap"])
def test_tonemap_matches_reference(op):
    img = _hdr(1)
    kw = {"exposure": {"ev": 1.5}}.get(op, {})
    ref = getattr(jtone, op)(jnp.asarray(img), **kw)
    got = getattr(ttone, op)(torch.from_numpy(img), **kw)
    _close(got, ref, rtol=1e-6, atol=GT_ATOL if op == "gt_tonemap" else 1e-7)


@pytest.mark.parametrize("kw", [{"contrast": 1.2, "max_luminance": 2.0},
                                {"end_of_toe": 0.1, "range_of_linear": 0.6}])
def test_gt_tonemap_parameters_match_reference(kw):
    img = _hdr(2)
    _close(ttone.gt_tonemap(torch.from_numpy(img), **kw), jtone.gt_tonemap(jnp.asarray(img), **kw),
           rtol=1e-6, atol=GT_ATOL)


def test_magnifier_matches_reference():
    img = _hdr(3)
    kw = {"center_px": (12.5, 20.0), "magnification": 0.4, "radius": 9.0}
    np.testing.assert_array_equal(ttone.magnifier(torch.from_numpy(img), **kw).numpy(),
                                  np.asarray(jtone.magnifier(jnp.asarray(img), **kw)))


@pytest.mark.parametrize("iters", [1, 5])
def test_atrous_matches_reference(iters):
    color, normal, depth = _gbuffer(4)
    with jax.disable_jit():
        ref = jatrous.atrous(jnp.asarray(color), jnp.asarray(normal), jnp.asarray(depth),
                             iters=iters)
    got = tatrous.atrous(torch.from_numpy(color), torch.from_numpy(normal),
                         torch.from_numpy(depth), iters=iters)
    _close(got, ref)


def test_taa_matches_reference():
    """Four frames of an orbiting camera: the world positions are each
    pixel's ray at a seeded depth, the previous frame's matrices those of
    the camera before the step."""
    rng = np.random.default_rng(5)
    kw = {"origin": (0.5, 1.0, 5.0), "lookat": (0.0, 0.0, 0.0), "vfov_deg": 45.0,
          "width": W, "height": H}
    jc = jcam.PinholeCamera(**kw)
    jh = jtaa.init_history(H, W)
    th = ttaa.init_history(H, W, "cpu")
    prev = None
    params = ttaa.TAAParams(blend=0.25, clip_gamma=1.5)
    jparams = jtaa.TAAParams(blend=0.25, clip_gamma=1.5)
    for f in range(4):
        ca = jc.arrays()
        ys, xs = np.mgrid[0:H, 0:W]
        s = (xs + 0.5) / W
        t = (H - 1 - ys + 0.5) / H
        ro, rd = jcam.generate_ray(ca, jnp.asarray(s.reshape(-1), jnp.float32),
                                   jnp.asarray(t.reshape(-1), jnp.float32))
        depth = rng.uniform(3.0, 6.0, H * W).astype(np.float32)
        depth[:20] = -1.0  # no hit
        pos = (np.asarray(ro) + np.asarray(rd) * depth[:, None]).reshape(H, W, 3)
        depth = depth.reshape(H, W)
        cur = _hdr(10 + f)
        tc = tcam.PinholeCamera(**dataclasses.asdict(prev or jc))
        jw2v, jv2c = jcam.camera_matrices(prev or jc)
        tw2v, tv2c = tcam.camera_matrices(tc, device="cpu")
        with jax.disable_jit():
            jo, jh = jtaa.taa_step(jnp.asarray(cur), jnp.asarray(pos), jnp.asarray(depth), jh,
                                   jw2v, jv2c, jparams)
        to, th = ttaa.taa_step(torch.from_numpy(cur), torch.from_numpy(pos),
                               torch.from_numpy(depth), th, tw2v, tv2c, params)
        _close(to, jo)
        _close(th["color"], jh["color"])
        np.testing.assert_array_equal(th["valid"].numpy(), np.asarray(jh["valid"]))
        prev = jc
        jc = jcam.CameraOperator.orbit(jc, 0.03, 0.01)


# -- the reference's display tests (tests/test_display_io.py), on the port


def test_gt_tonemap_properties():
    x = torch.linspace(0.0, 8.0, 256).reshape(16, 16, 1)
    y = ttone.gt_tonemap(x.repeat(1, 1, 3)).numpy()
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y[..., 0], y[..., 1], atol=1e-4)
    lum = y[..., 1].ravel()
    assert (np.diff(lum) > -1e-4).all()
    assert lum.max() <= 1.0 + 1e-3
    mid = ttone.gt_tonemap(torch.full((1, 1, 3), 0.3)).numpy()[0, 0, 1]
    np.testing.assert_allclose(mid, 0.3, atol=0.02)


def test_srgb_and_gamma():
    img = torch.tensor([[[0.0, 0.5, 1.0]]])
    s = ttone.srgb_oetf(img).numpy()
    assert s[0, 0, 0] == 0.0
    np.testing.assert_allclose(s[0, 0, 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(ttone.gamma(img).numpy()[0, 0, 1], 0.5 ** (1 / 2.2), atol=1e-6)
    np.testing.assert_allclose(ttone.exposure(img, ev=1.0).numpy(), img.numpy() * 2.0)


def test_magnifier_ring_and_zoom():
    img = torch.zeros((64, 64, 3))
    img[32, 40] = torch.tensor([0.0, 1.0, 0.0])
    out = ttone.magnifier(img, center_px=(32.0, 32.0), magnification=0.5, radius=20.0).numpy()
    assert out.shape == (64, 64, 3)
    assert (out[..., 0] == 1.0).any()
    assert out[32, 48, 1] == 1.0


def test_taa_reduces_noise_static_camera():
    cam = tcam.PinholeCamera(origin=(0, 0, 5), lookat=(0, 0, 0), width=W, height=H)
    w2v, v2c = tcam.camera_matrices(cam, device="cpu")
    rng = np.random.default_rng(0)
    clean = np.full((H, W, 3), 0.5, np.float32)
    pos = torch.zeros((H, W, 3))
    depth = torch.ones((H, W))
    hist = ttaa.init_history(H, W, "cpu")
    var0 = out = None
    for frame in range(6):
        noisy = clean + rng.normal(0, 0.2, clean.shape).astype(np.float32)
        out, hist = ttaa.taa_step(torch.from_numpy(noisy), pos, depth, hist, w2v, v2c,
                                  ttaa.TAAParams(blend=0.2, clip_gamma=10.0))
        if frame == 0:
            var0 = float(np.var(out.numpy() - clean))
    assert float(np.var(out.numpy() - clean)) < var0 * 0.7


def test_atrous_smooths_but_keeps_edges():
    rng = np.random.default_rng(1)
    img = np.full((64, 64, 3), 0.2, np.float32)
    img[:, 32:] = 1.0
    noisy = img + rng.normal(0, 0.1, img.shape).astype(np.float32)
    normal = torch.zeros((64, 64, 3))
    normal[..., 2] = 1.0
    depth = torch.zeros((64, 64))
    depth[:, 32:] = 5.0
    out = tatrous.atrous(torch.from_numpy(noisy), normal, depth, iters=3).numpy()
    assert np.std(out[:, :28]) < np.std(noisy[:, :28]) * 0.6
    assert abs(out[:, 36].mean() - out[:, 28].mean()) > 0.6
