"""Row bands of the port's `_trace_paths` against aten_tpu's.

`_trace_paths` with `y0`/`tile_h` traces rows [y0, y0 + tile_h), seeded
by the global pixel id (aten_tpu/integrator/pathtracer.py:238-300):

* against the reference's `_trace_paths` with the same band, run op by
  op (`jax.disable_jit()`), on the Cornell box (the dense test) and on a
  1,536-triangle mesh scene (the plain walk), 1 spp, depth 3, RR depth
  2: rtol 1e-5 / atol 1e-6 on at least 99.5% of pixels.  Measured: every
  pixel within it (max relative difference 5.5e-6, 96-99% of pixels
  bitwise).  The jitted reference is farther off: XLA contracts
  multiply-adds in its compiled bounce loop, and 7 of the Cornell box's
  1,024 pixels then differ by up to 9e-5 relative, in the whole image as
  in every band (ROADMAP.md queue 3);
* the port's bands, put together, are bitwise its whole image, with
  bands of equal and unequal heights and two samples per dispatch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import _trace_paths as jax_trace_paths
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.pathtracer import _trace_paths
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

W = H = 32
POPULATE = {
    "cornell": lambda b: tdefs.populate_cornell_box(b, W, H),
    "mesh1536": lambda b: tdefs.populate_procedural_mesh_scene(b, W, H, 48, 16),
}


@pytest.fixture(scope="module")
def scenes(reference_native):  # noqa: F811
    out = {}
    for name, populate in POPULATE.items():
        jb = JaxSceneBuilder()
        cam = populate(jb)
        js = jb.build()
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        out[name] = (js, ts, cam)
    return out


@pytest.mark.parametrize("name,y0,tile_h", [
    ("cornell", 0, 8), ("cornell", 16, 16), ("cornell", 24, 8), ("mesh1536", 24, 8)])
def test_band_matches_reference(scenes, name, y0, tile_h):
    js, ts, cam = scenes[name]
    with jax.disable_jit():
        ref = np.asarray(jax_trace_paths(
            js, JaxPinholeCamera(**dataclasses.asdict(cam)).arrays(), W, H, jnp.uint32(0),
            jnp.uint32(0), 1, 3, 2, y0=y0, tile_h=tile_h))
    got = _trace_paths(ts, PinholeCamera(**dataclasses.asdict(cam)).arrays("cpu"), W, H, 0, 0,
                       1, 3, 2, y0=y0, tile_h=tile_h).numpy()
    assert got.shape == ref.shape == (tile_h * W, 3) and np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref)).all(axis=1)
    assert ok.mean() >= 0.995, int((~ok).sum())
    assert got.max() > 0.05


@pytest.mark.parametrize("bands", [[(0, 8), (8, 8), (16, 8), (24, 8)],
                                   [(0, 5), (5, 20), (25, 7)]], ids=["equal", "unequal"])
def test_bands_make_the_whole_image(bands):
    scene, cam = tdefs.procedural_mesh_scene(W, H, 48, 16, device="cpu")
    ca = cam.arrays("cpu")
    whole = _trace_paths(scene, ca, W, H, 3, 1, 4, 3, 2, spp_chunk=2)
    parts = [_trace_paths(scene, ca, W, H, 3, 1, 4, 3, 2, spp_chunk=2, y0=y0, tile_h=th)
             for y0, th in bands]
    assert torch.equal(torch.cat(parts), whole)
