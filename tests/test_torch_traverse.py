"""aten_tpu_torch traversal against the aten_tpu oracle.

The plain walk, the dense all-prims test and `occluded` are held to the
reference's `traverse(impl="jax"/"dense")` on camera rays and on random
rays from surface points, with the `_check_parity` bounds
(tests/test_pallas_tpu.py:29-42): prim agreement >= 0.999 and t within
rtol = atol = 1e-4 where prims agree; any-hit verdicts equal.

u/v: XLA's CPU backend contracts multiply-adds into FMAs, the port (and
its CUDA kernel, built with --fmad=false) rounds every op.  Held to the
oracle's own formula (accel/traverse.py:304-319) evaluated in numpy
float32, which rounds every op as the port does, u/v agree within 1e-5.
Against XLA's values they agree within 1e-5 on all but ~0.1% of hits:
the cancelling dot products of a ray from 14 units away amplify the
FMA rounding to at most a few 1e-5, so that comparison takes the t
bound of 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.accel.traverse import occluded as jax_occluded
from aten_tpu.accel.traverse import traverse as jax_traverse
from aten_tpu.core import camera as jcam
from aten_tpu.scene import scenedefs as jdefs
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.ops import traverse_cuda
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.utils import spans
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

_SCENES = {}


def _scenes(name):
    """(reference SceneData, port Scene via the bridge, camera) per name."""
    if name not in _SCENES:
        if name == "cornell":
            js, cam = jdefs.cornell_box(64, 64)
        else:
            b = JaxSceneBuilder()
            tcam = tdefs.populate_procedural_mesh_scene(b, 64, 64, n_u=48, n_v=16)
            js, cam = b.build(), jcam.PinholeCamera(**dataclasses.asdict(tcam))
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays),
                               js.static, "cpu")
        _SCENES[name] = (js, ts, cam)
    return _SCENES[name]


def _rays(js, cam, kind, seed=0):
    """Camera rays through 64x64 pixel centres, or 4096 rays from random
    surface points in random directions."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        n = 64
        lp = np.arange(n * n)
        s = ((lp % n) + 0.5) / n
        t = ((lp // n) + 0.5) / n
        ro, rd = jcam.generate_ray(cam.arrays(), jnp.asarray(s, jnp.float32),
                                   jnp.asarray(t, jnp.float32))
        return np.asarray(ro), np.asarray(rd)
    n = 4096
    T = js["num_tris"]
    tid = rng.integers(0, T, n)
    b = rng.random((n, 2))
    b[b.sum(1) > 1] = 1.0 - b[b.sum(1) > 1]
    v0, e1, e2 = (np.asarray(js[k])[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
    ro = (v0 + b[:, :1] * e1 + b[:, 1:] * e2).astype(np.float32)
    d = rng.standard_normal((n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def _uv_f32(js, ro, rd, prim):
    """The oracle's u/v formula in numpy float32 (every op rounded)."""
    T = js["tri_v0"].shape[0]
    tid = np.clip(prim, 0, T - 1)
    v0, e1, e2 = (np.asarray(js[k])[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    px = rdy * e2[:, 2] - rdz * e2[:, 1]
    py = rdz * e2[:, 0] - rdx * e2[:, 2]
    pz = rdx * e2[:, 1] - rdy * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(det) > np.float32(1e-12), np.float32(1.0) / det, np.float32(0.0))
    dx, dy, dz = (ro[:, a] - v0[:, a] for a in range(3))
    u = (dx * px + dy * py + dz * pz) * inv
    qx = dy * e1[:, 2] - dz * e1[:, 1]
    qy = dz * e1[:, 0] - dx * e1[:, 2]
    qz = dx * e1[:, 1] - dy * e1[:, 0]
    v = (rdx * qx + rdy * qy + rdz * qz) * inv
    return u, v


def _np(h):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in h.items()}


def _check_parity(ref, got):
    m0, m1 = ref["prim"], got["prim"]
    assert (m0 == m1).mean() >= 0.999, (m0 == m1).mean()
    np.testing.assert_array_equal(got["hit"], m1 >= 0)
    mask = (m0 >= 0) & (m0 == m1)
    np.testing.assert_allclose(got["t"][mask], ref["t"][mask], rtol=1e-4, atol=1e-4)
    return mask


def _edge_ties(js, ro, rd, ref, got):
    """Lanes where the prims differ and the reference's winner, in the
    port's float32 arithmetic, lies on a triangle edge: u, v or u + v
    within 2 ulp of the [0, 1] bounds, so the FMA decides the side."""
    diff = ref["prim"] != got["prim"]
    u, v = _uv_f32(js, ro, rd, ref["prim"])
    eps = np.float32(2.4e-7)
    on_edge = (np.abs(u) <= eps) | (np.abs(v) <= eps) | (np.abs(u + v - 1) <= eps)
    return diff & (ref["prim"] >= 0) & (ref["prim"] < js["num_tris"]) & on_edge


@pytest.mark.parametrize("kind", ["camera", "random"])
@pytest.mark.parametrize("name,ref_impl,port_impl", [
    ("mesh1536", "jax", "plain"),
    ("mesh1536", "jax", "auto"),
    ("cornell", "jax", "plain"),
    ("cornell", "dense", "dense"),
    ("cornell", "dense", "auto"),
])
def test_closest_hit_matches_oracle(name, ref_impl, port_impl, kind):
    """_check_parity bounds.  One case differs: the Cornell box's camera
    rays through pixel centres run exactly along the quad diagonals and
    shared wall edges, where the reference's walk and its own dense test
    already pick different (equal-t) prims; there every mismatch must be
    such an edge tie, and they stay under 0.5% of the rays."""
    js, ts, cam = _scenes(name)
    ro, rd = _rays(js, cam, kind)
    ref = _np(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl=ref_impl))
    got = _np(ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd), impl=port_impl))
    if name == "cornell" and ref_impl == "jax" and kind == "camera":
        diff = ref["prim"] != got["prim"]
        ties = _edge_ties(js, ro, rd, ref, got)
        np.testing.assert_array_equal(diff, ties)
        assert diff.mean() < 5e-3
        mask = (ref["prim"] >= 0) & ~diff
        np.testing.assert_allclose(got["t"][mask], ref["t"][mask], rtol=1e-4, atol=1e-4)
    else:
        mask = _check_parity(ref, got)
    assert mask.sum() > 0.3 * len(mask)
    tri = mask & (got["prim"] < js["num_tris"])
    u32, v32 = _uv_f32(js, ro, rd, got["prim"])
    np.testing.assert_allclose(got["u"][tri], u32[tri], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["v"][tri], v32[tri], rtol=0, atol=1e-5)
    for k in ("u", "v"):
        d = np.abs(got[k][mask] - ref[k][mask])
        assert (d <= 1e-5).mean() >= 0.998, (k, (d > 1e-5).sum())
        assert d.max() <= 1e-4, (k, d.max())


@pytest.mark.parametrize("kind", ["camera", "random"])
@pytest.mark.parametrize("name,port_impl", [
    ("mesh1536", "plain"), ("mesh1536", "cuda"), ("cornell", "auto"),
])
def test_any_hit_and_occluded_match_oracle(name, port_impl, kind):
    js, ts, cam = _scenes(name)
    ro, rd = _rays(js, cam, kind, seed=1)
    dist = np.random.default_rng(2).uniform(0.0, 20.0, ro.shape[0]).astype(np.float32)
    ref_impl = "jax" if name == "mesh1536" else "auto"
    ref = np.asarray(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd),
                                    t_max=jnp.asarray(dist), any_hit=True,
                                    impl=ref_impl)["hit"])
    got = ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd),
                         t_max=torch.tensor(dist), any_hit=True,
                         impl=port_impl)["hit"].numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.05 < ref.mean() < 0.95
    occ_ref = np.asarray(jax_occluded(js, jnp.asarray(ro), jnp.asarray(rd),
                                        jnp.asarray(dist), impl=ref_impl))
    occ = ttrav.occluded(ts, torch.tensor(ro), torch.tensor(rd),
                         torch.tensor(dist), impl=port_impl).numpy()
    np.testing.assert_array_equal(occ, occ_ref)


def test_dead_lanes_never_hit():
    """Lanes whose t_max is at most t_min keep (t_max, -1, 0, 0), as in
    the oracle; the walk skips them."""
    js, ts, cam = _scenes("mesh1536")
    ro, rd = _rays(js, cam, "camera")
    t_max = np.where(np.arange(ro.shape[0]) % 2 == 0, 0.0, 1e30).astype(np.float32)
    ref = _np(jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd),
                             t_max=jnp.asarray(t_max), impl="jax"))
    got = _np(ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd),
                             t_max=torch.tensor(t_max), impl="plain"))
    dead = t_max == 0.0
    assert (got["prim"][dead] == -1).all() and (got["t"][dead] == 0.0).all()
    np.testing.assert_array_equal(got["prim"], ref["prim"])


def test_cuda_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the kernel wrapper returns the plain walk's result
    bit for bit and counts no launch."""
    spans.reset()
    js, ts, cam = _scenes("mesh1536")
    ro, rd = (torch.tensor(a) for a in _rays(js, cam, "random", seed=3))
    for any_hit in (False, True):
        t0 = torch.full((ro.shape[0],), 7.5)
        a = traverse_cuda.bvh_traverse(ts, ro, rd, t0, any_hit=any_hit)
        b = ttrav._traverse_plain(ts, ro, rd, t0, any_hit, 1e-4)
        for x, k in zip(a, ("t", "prim", "u", "v")):
            assert torch.equal(x, b[k]), k
    assert not [k for k in spans.counters() if k.startswith("launch.")]


def test_unknown_impl_raises():
    js, ts, cam = _scenes("cornell")
    with pytest.raises(ValueError):
        ttrav.traverse(ts, torch.zeros(1, 3), torch.ones(1, 3), impl="pallas")
