"""ReSTIR GI (`aten_tpu_torch/integrator/restir.py::restir_gi_sample`)
on a mesh walk, against aten_tpu.

* On the 2,004-prim knot (the reference's `procedural_mesh_scene` at
  n_u 40, n_v 25, bridged), two GI frames at 32x32, depth 3, RR 2, the
  port through K1's plain version (`impl="cuda"` on CPU tensors) against
  the jitted reference's render through its batched walk (the CPU's
  `traverse(impl="jax")`), within the full-image bounds (frac(rel >
  2e-2) < 5e-3, mean rel < 3e-3; measured: 0 and 3.5e-7); and the port's
  oracle walk (`impl="plain"`) equal to K1's plain version.
* The reference's GI consistency test (tests/test_restir.py): on a
  diffuse Cornell box the GI renderer converges to the path tracer's
  image, on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator import restir as jrestir
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator import restir
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

torch.set_num_threads(1)

W = H = 32
KW = {"max_depth": 3, "rr_depth": 2}


def _bounds(img, ref):
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    return float((rel > 2e-2).mean()), float(rel.mean())


@pytest.fixture(scope="module")
def knot(reference_native):  # noqa: F811
    jb = JaxSceneBuilder()
    cam = tdefs.populate_procedural_mesh_scene(jb, W, H, 40, 25)
    js = jb.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    return js, ts, cam


def _port_frames(ts, cam, impl):
    st = restir.init_state(H, W, "cpu")
    ca = PinholeCamera(**dataclasses.asdict(cam)).arrays("cpu")
    for f in range(2):
        img, st = restir.restir_gi_sample(ts, ca, W, H, f, st, impl=impl, **KW)
    return img.numpy(), st


def test_restir_gi_knot_matches_reference(knot):
    js, ts, cam = knot
    st = jrestir.init_state(H, W)
    ca = JaxPinholeCamera(**dataclasses.asdict(cam)).arrays()
    for f in range(2):
        ref, st = jrestir.restir_gi_sample(js, ca, W, H, jnp.uint32(f), st, **KW)
    ref = np.asarray(ref)
    got, tst = _port_frames(ts, cam, "cuda")
    assert np.isfinite(got).all() and got.mean() > 0.01
    frac, mean_rel = _bounds(got, ref)
    assert frac < 5e-3 and mean_rel < 3e-3, (frac, mean_rel)
    assert (tst["valid"].numpy() == np.asarray(st["valid"])).mean() >= 0.999
    plain, _ = _port_frames(ts, cam, "plain")
    frac, mean_rel = _bounds(got, plain)
    assert frac < 5e-3 and mean_rel < 3e-3, (frac, mean_rel)


def test_restir_gi_matches_pt_on_diffuse_scene():
    """GI consistency: the full ReSTIR renderer (reservoir direct light at
    bounce 0, path tracing beyond) converges to the path tracer's image
    on a diffuse scene as its reservoirs accumulate."""
    w = h = 24
    scene, cam = tdefs.cornell_box(w, h, use_spheres=False, device="cpu")
    ca = cam.arrays("cpu")
    pt = render_image(scene, cam, spp=64, max_depth=3).numpy()
    st = restir.init_state(h, w, "cpu")
    acc = np.zeros((h, w, 3), np.float32)
    F = 24
    for f in range(F):
        img, st = restir.restir_gi_sample(scene, ca, w, h, f, st, max_depth=3, rr_depth=2)
        acc += img.numpy()
    gi = acc / F
    assert abs(gi.mean() - pt.mean()) / max(pt.mean(), 1e-6) < 0.1, (gi.mean(), pt.mean())
    lit = pt.mean(axis=-1) > np.percentile(pt.mean(axis=-1), 60)
    assert abs(gi.mean(axis=-1)[lit].mean() - pt.mean(axis=-1)[lit].mean()) \
        / pt.mean(axis=-1)[lit].mean() < 0.12
