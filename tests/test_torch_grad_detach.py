"""Gradients through the port's bounce loop against aten_tpu's.

The reference stops gradients in four places of its bounce loop
(aten_tpu/integrator/pathtracer.py): the Russian-roulette survival
probability, the sampled direction's pdf in the throughput weight, the
next ray's origin and its direction.  The port detaches the same four.
Without them a gradient taken through the port is another estimator.

The check: d mean(radiance) / d materials["base_color"] of the 16x16
Cornell box at 1 spp, by `torch.autograd.grad` through the port's
`_trace_paths` on the CPU and by `jax.grad` through the reference's, on
the same scene arrays: at depth 3, RR depth 2 (tests/test_grad.py::_loss
itself), and at depth 3, RR depth 1 and depth 4, RR depth 2.  In the
first the roulette runs only at the last bounce, after its radiance is
summed, so its term is dead there; in the other two it is live, and
without the detach the port's gradient is off by up to 47% (measured:
max |diff| 0.0174 and 0.129 against entries of at most 0.254 and
0.435).  In this scene no material's pdf or sampled direction depends on
base_color, so the other three detaches change none of these gradients.
Tolerance rtol 1e-4 with atol 1e-6: the two differ only by float32
rounding (XLA on the CPU contracts multiply-adds, torch rounds every op;
measured max relative difference 6.9e-7, max abs 2.1e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.integrator.pathtracer import _trace_paths as jax_trace_paths
from aten_tpu.scene.scenedefs import cornell_box as jax_cornell_box
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.pathtracer import _trace_paths
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene.scene import Scene
from test_grad import _loss

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

SIZE, SPP = 16, 1
RTOL, ATOL = 1e-4, 1e-6


def _reference_loss(depth, rr_depth):
    """tests/test_grad.py::_loss at (depth, rr_depth)."""
    if (depth, rr_depth) == (3, 2):
        return _loss

    def loss(base_color, scene, ca):
        mats = dict(scene["materials"])
        mats["base_color"] = base_color
        rad = jax_trace_paths(scene.replace(materials=mats), ca, SIZE, SIZE, jnp.uint32(0),
                              jnp.uint32(0), SPP, depth, rr_depth)
        return jnp.mean(rad)

    return loss


def _port_grad(js, cam, depth, rr_depth):
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    base = ts["materials"]["base_color"].clone().requires_grad_(True)
    arrays = {**ts.arrays, "materials": {**ts["materials"], "base_color": base}}
    scene = Scene(arrays, ts.static, ts.device)
    rad = _trace_paths(scene, cam.arrays("cpu"), SIZE, SIZE, 0, 0, SPP, depth, rr_depth)
    (g,) = torch.autograd.grad(rad.mean(), base)
    return g.numpy()


@pytest.mark.parametrize("depth,rr_depth", [(3, 2), (3, 1), (4, 2)])
def test_grad_matches_reference(depth, rr_depth):
    js, jcam = jax_cornell_box(SIZE, SIZE)
    ref = np.asarray(jax.jit(jax.grad(_reference_loss(depth, rr_depth)))(
        js["materials"]["base_color"], js, jcam.arrays()))
    got = _port_grad(js, PinholeCamera(**dataclasses.asdict(jcam)), depth, rr_depth)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(ref).max() > 1e-3  # the loss does depend on the albedos
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
