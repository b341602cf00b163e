"""aten_tpu_torch's blue-noise masks and sampler against aten_tpu.

* `make_blue_noise` and `get_masks` bitwise equal (numpy in both), each
  package caching in its own file: the port's default cache lies in its
  build directory, its environment variable is its own.
* `BlueNoiseSampler.sample` within 1 ulp on seeded pixels, frames and
  dimensions (float32 arithmetic in both).
* `render_sample(sampler="bluenoise")` against the reference's at 32x32,
  8 spp in one chunk, depth 3, within the full-image radiance bounds
  (frac(rel > 2e-2) < 5e-3, mean rel < 3e-3), and unlike the CMJ render.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core import bluenoise as jbn
from aten_tpu.integrator.pathtracer import render_sample as jax_render_sample
from aten_tpu.scene import scenedefs as jdefs
from aten_tpu_torch import native
from aten_tpu_torch.core import bluenoise as tbn
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.pathtracer import render_sample
from aten_tpu_torch.scene import bridge

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)


def test_blue_noise_rank_matrix_bitwise():
    for size, seed in ((16, 0), (32, 1)):
        np.testing.assert_array_equal(tbn.make_blue_noise(size, seed),
                                      jbn.make_blue_noise(size, seed))


def test_masks_bitwise_and_cached_apart(tmp_path):
    want = jbn.get_masks(32, 2, cache=str(tmp_path / "ref_{size}x{layers}.npz"))
    path = tmp_path / "port_{size}x{layers}.npz"
    got = tbn.get_masks(32, 2, cache=str(path))
    assert got.dtype == np.float32 and got.shape == (2, 32, 32)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port_32x2.npz").exists()
    np.testing.assert_array_equal(tbn.get_masks(32, 2, cache=str(path)), want)  # from the file
    assert tbn._CACHE != jbn._CACHE and tbn._CACHE.startswith(native.BUILD_DIR)


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("frame,dim", [(0, 0), (1, 0), (7, 3), (130, 17), (70000, 9)])
def test_sample_within_one_ulp(frame, dim, tmp_path):
    masks = jbn.get_masks(32, 2, cache=str(tmp_path / "m_{size}x{layers}.npz"))
    js = jbn.BlueNoiseSampler.__new__(jbn.BlueNoiseSampler)
    js.size, js.layers, js.masks = 32, 2, jnp.asarray(masks)
    ts = tbn.BlueNoiseSampler.__new__(tbn.BlueNoiseSampler)
    ts.size, ts.layers, ts.masks = 32, 2, torch.tensor(masks)
    rng = np.random.default_rng(frame + 31 * dim)
    px = rng.integers(0, 512, 4096).astype(np.float32)
    py = rng.integers(0, 512, 4096).astype(np.float32)
    # the path tracer's key: frame * 64 + each lane's sample index
    fkey = (frame * 64 + rng.integers(0, 64, 4096)).astype(np.uint32)
    want = np.asarray(js.sample(jnp.asarray(px), jnp.asarray(py), jnp.asarray(fkey),
                                jnp.uint32(dim)))
    got = ts.sample(torch.tensor(px), torch.tensor(py), torch.tensor(fkey.astype(np.int64)),
                    dim).numpy()
    assert got.dtype == np.float32 and ((got >= 0) & (got < 1)).all()
    assert _ulps(got, want).max() <= 1
    a, b = ts.sample2d(torch.tensor(px), torch.tensor(py), torch.tensor(fkey.astype(np.int64)),
                       dim)
    assert torch.equal(a, ts.sample(torch.tensor(px), torch.tensor(py),
                                    torch.tensor(fkey.astype(np.int64)), dim))
    assert not torch.equal(a, b)


def test_bluenoise_render_matches_reference():
    js, jcam = jdefs.cornell_box(32, 32)
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    cam = PinholeCamera(origin=jcam.origin, lookat=jcam.lookat, vfov_deg=jcam.vfov_deg,
                        width=32, height=32)
    ref = np.asarray(jax_render_sample(js, jcam.arrays(), 32, 32, jnp.uint32(0), jnp.uint32(0),
                                       8, 3, 2, spp_chunk=8, sampler="bluenoise"))
    img = render_sample(ts, cam.arrays("cpu"), 32, 32, 0, 0, 8, 3, 2, spp_chunk=8,
                        sampler="bluenoise").numpy()
    assert np.isfinite(img).all()
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3, (rel > 2e-2).mean()
    assert rel.mean() < 3e-3, rel.mean()
    cmj = render_sample(ts, cam.arrays("cpu"), 32, 32, 0, 0, 8, 3, 2, spp_chunk=8).numpy()
    assert not np.allclose(img, cmj)
    with pytest.raises(ValueError, match="sampler"):
        render_sample(ts, cam.arrays("cpu"), 32, 32, 0, 0, 8, 3, 2, sampler="sobol")
