"""ReSTIR (`aten_tpu_torch/integrator/restir.py`) and `many_light_scene`
against aten_tpu: the fixture and the goldens.

* `many_light_scene`'s arrays (the lights drawn from
  np.random.default_rng(seed)) bitwise the reference's, and bitwise the
  bridged reference scene's.
* Both samplers at the goldens' configuration (64x64, 32 lights, two
  frames; GI at depth 3, RR 2) against `tests/golden/restir_lights.npz`
  and `restir_gi.npz` with tests/test_golden.py's bounds (max < 5e-3,
  mean < 5e-4), and against the reference run op by op
  (`jax.disable_jit()`) with the same bounds.  The goldens were made by
  the jitted reference, which contracts multiply-adds: an ulp moves a
  reservoir's pick (`u * w_sum < w`), and spatial reuse spreads it.  The
  reference's own op-by-op run misses its goldens' max bound at two
  pixels (0.0376; measured); so the max bound holds at every pixel
  where the reference's op-by-op run meets it, the mean bound and the
  full-image bounds (frac(rel > 2e-2) < 5e-3, mean rel < 3e-3) over
  the whole image.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.integrator import restir as jrestir
from aten_tpu.scene.scenedefs import many_light_scene as jax_many_light_scene
from aten_tpu_torch.integrator import restir
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from test_torch_bvh_scene import _assert_tables_equal

torch.set_num_threads(1)

G = 64  # the goldens' width and height
GOLDEN = {"direct": "restir_lights", "gi": "restir_gi"}
GI_KW = {"max_depth": 3, "rr_depth": 2}


def _frames(fn, scene, ca, n=2, **kw):
    st = restir.init_state(G, G, "cpu")
    img = None
    for f in range(n):
        img, st = fn(scene, ca, G, G, f, st, **kw)
    return img.numpy()


@pytest.fixture(scope="module")
def eager_reference():
    """The reference's two frames of each sampler, op by op."""
    js, cam = jax_many_light_scene(G, G, num_lights=32)
    out = {}
    with jax.disable_jit():
        for kind, fn, kw in (("direct", jrestir.restir_direct_sample, {}),
                             ("gi", jrestir.restir_gi_sample, GI_KW)):
            st = jrestir.init_state(G, G)
            for f in range(2):
                img, st = fn(js, cam.arrays(), G, G, jnp.uint32(f), st, **kw)
            out[kind] = np.asarray(img)
    return out


@pytest.mark.parametrize("num_lights,seed", [(126, 0), (32, 3)])
def test_many_light_scene_matches_reference(num_lights, seed):
    ref, jcam = jax_many_light_scene(48, 32, num_lights=num_lights, seed=seed)
    port, cam = tdefs.many_light_scene(48, 32, num_lights=num_lights, seed=seed, device="cpu")
    assert port["num_lights"] == num_lights and port["num_spheres"] == 25
    _assert_tables_equal(ref.arrays, port.arrays)
    for k, v in port.static.items():
        assert ref.static[k] == v, k
    via_bridge = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, ref.arrays), ref.static,
                                   "cpu")
    _assert_tables_equal(ref.arrays, via_bridge.arrays)
    assert cam == type(cam)(**{f: getattr(jcam, f) for f in cam.__dataclass_fields__})


@pytest.mark.parametrize("kind", ["direct", "gi"])
def test_restir_meets_golden(kind, eager_reference):
    scene, cam = tdefs.many_light_scene(G, G, num_lights=32, device="cpu")
    fn = restir.restir_direct_sample if kind == "direct" else restir.restir_gi_sample
    img = _frames(fn, scene, cam.arrays("cpu"), **({} if kind == "direct" else GI_KW))
    with np.load(os.path.join(os.path.dirname(__file__), "golden", f"{GOLDEN[kind]}.npz")) as z:
        gold = z["img"]
    ref = eager_reference[kind]
    assert img.shape == gold.shape and np.isfinite(img).all()
    e_ref = np.abs(img - ref)
    assert e_ref.max() < 5e-3 and e_ref.mean() < 5e-4, (e_ref.max(), e_ref.mean())
    err = np.abs(img - gold)
    assert err.mean() < 5e-4, err.mean()
    rel = err / (np.abs(gold) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3 and rel.mean() < 3e-3
    over = err.max(-1) >= 5e-3
    over_ref = np.abs(ref - gold).max(-1) >= 5e-3
    assert not (over & ~over_ref).any(), np.argwhere(over & ~over_ref)


def test_reproject_prev_pixel_matches_reference():
    """tests/test_restir.py's round trip on the port (a point on pixel
    (x, y)'s ray reprojects to (x, y) under the same camera), and the
    reference's pixel for the points of another camera."""
    from aten_tpu.core import camera as jcam
    from aten_tpu_torch.core.camera import PinholeCamera, generate_ray

    W = H = 32
    kw = {"origin": (1.0, 2.0, 5.0), "lookat": (0.0, 0.5, 0.0), "vfov_deg": 45,
          "width": W, "height": H}
    ca = PinholeCamera(**kw).arrays("cpu")
    pix = torch.arange(W * H)
    s = ((pix % W).float() + 0.5) / W
    t = (float(H - 1) - (pix // W).float() + 0.5) / H
    ro, rd = generate_ray(ca, s, t)
    p = ro + 3.7 * rd
    prev_cam = {k: ca[k] for k in ("origin", "right", "up", "forward")}
    idx, ok = restir._reproject_prev_pixel(prev_cam, p, W, H)
    assert bool(ok.all())
    np.testing.assert_array_equal(idx.numpy(), pix.numpy())
    # the points seen from a moved camera
    rng = np.random.default_rng(2)
    q = rng.uniform(-3, 3, (W * H, 3)).astype(np.float32)
    jca = jcam.PinholeCamera(**dict(kw, origin=(1.5, 2.5, 4.0))).arrays()
    tca = PinholeCamera(**dict(kw, origin=(1.5, 2.5, 4.0))).arrays("cpu")
    with jax.disable_jit():
        jidx, jok = jrestir._reproject_prev_pixel(
            {k: jca[k] for k in prev_cam}, jnp.asarray(q), W, H)
    tidx, tok = restir._reproject_prev_pixel({k: tca[k] for k in prev_cam},
                                             torch.from_numpy(q), W, H)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tidx.numpy()[tok.numpy()], np.asarray(jidx)[np.asarray(jok)])


def test_temporal_acceptance_rejects_mismatched_history():
    """tests/test_restir.py's test on the port: history from another
    surface (mesh ids corrupted) does not merge."""
    W = H = 32
    scene, cam = tdefs.many_light_scene(W, H, num_lights=8, device="cpu")
    ca = cam.arrays("cpu")
    st = restir.init_state(H, W, "cpu")
    _, st = restir.restir_direct_sample(scene, ca, W, H, 0, st)
    _, st2 = restir.restir_direct_sample(scene, ca, W, H, 1, st)
    bad = dict(st, mesh=torch.full_like(st["mesh"], 999999))
    _, st3 = restir.restir_direct_sample(scene, ca, W, H, 1, bad)
    sh = st2["valid"].numpy()
    m_with = st2["reservoir"]["m"].numpy()
    m_without = st3["reservoir"]["m"].numpy()
    assert m_with[sh].mean() > 1.5 * m_without[sh].mean()


def test_restir_runs_and_accumulates():
    """tests/test_restir.py's renderer test on the port (24x24, 32
    lights, three GI frames)."""
    scene, cam = tdefs.many_light_scene(24, 24, num_lights=32, device="cpu")
    r = restir.ReSTIRRenderer(scene, cam)
    imgs = [r.render_frame().numpy() for _ in range(3)]
    for im in imgs:
        assert im.shape == (24, 24, 3) and np.isfinite(im).all() and (im >= 0).all()
    assert imgs[0].mean() > 0.001
    assert r.frame == 3 and r.state["valid"].any()
