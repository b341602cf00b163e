"""The traversal statistics of aten_tpu_torch against aten_tpu.

* The oracle walk's per-ray `steps` (`traverse(impl="plain")`) against
  the reference's `traverse(impl="jax")["steps"]` on the 2,004-prim
  knot, camera and surface rays, closest and any-hit: equal, ray for ray.
* Each plain walk's per-ray counts (K1's `_traverse_plain`, also on the
  baked tree of a voxel-LOD scene, K3's `_traverse_plk_plain`, K4's
  `_traverse_trl_plain`, with stats=True) sum to its totals, except K1's
  any-hit prim tests, which count a leaf's prims only up to its first
  accepted hit, as the kernel stops the leaf; that rule has a case of its
  own on a one-leaf scene.
* `utils/debug.py` against aten_tpu/utils/debug.py: `traversal_heatmap`
  on the reference test's 600 random triangles within rtol 1e-6, and
  `temperature`, `_id_colors`, `aov_debug_image` and `pick_pixel` on
  seeded inputs.
* The tool `aten_tpu_torch/tools/trav_stats.py` end to end on the CPU at
  64x64 on small knots, through K1, K3-lod and K4-lod.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.accel.traverse import traverse as jax_traverse
from aten_tpu.core import camera as jcam
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu.utils import debug as jdebug
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.accel.voxel import enable_voxel_lod
from aten_tpu_torch.core.camera import generate_ray
from aten_tpu_torch.ops.traverse_cuda import bvh_traverse
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder, with_plk_layout, with_trl_layout
from aten_tpu_torch.tools import trav_stats
from aten_tpu_torch.utils import debug as tdebug
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

KNOT = {"n_u": 40, "n_v": 25}  # 2,000 knot triangles + 4: 2,004 prims
_SETUP = {}


def _knot():
    """(reference scene, the port's via the bridge, camera rays, surface
    rays), each rays (ro, rd) as numpy."""
    if "knot" not in _SETUP:
        jb = JaxSceneBuilder()
        cam = tdefs.populate_procedural_mesh_scene(jb, 32, 32, **KNOT)
        js = jb.build()
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        rng = np.random.default_rng(11)
        s = torch.tensor(rng.random(2048), dtype=torch.float32)
        t = torch.tensor(rng.random(2048), dtype=torch.float32)
        cro, crd = generate_ray(cam.arrays("cpu"), s, t)
        tid = rng.integers(0, ts["num_tris"], 2048)
        b = rng.random((2048, 2)) * 0.5
        v0, e1, e2 = (ts[k].numpy()[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
        sro = (v0 + b[:, :1] * e1 + b[:, 1:] * e2).astype(np.float32)
        d = rng.standard_normal((2048, 3))
        srd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        ro = np.concatenate([cro.contiguous().numpy(), sro])
        rd = np.concatenate([crd.numpy(), srd])
        dist = rng.uniform(0.5, 20.0, ro.shape[0]).astype(np.float32)
        _SETUP["knot"] = (js, ts, ro, rd, dist)
    return _SETUP["knot"]


@pytest.mark.parametrize("any_hit", [False, True])
def test_oracle_steps_equal_the_reference(any_hit):
    js, ts, ro, rd, dist = _knot()
    kw = {"t_max": dist, "any_hit": True, "t_min": 1e-3} if any_hit else {}
    want = jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax",
                        **{k: jnp.asarray(v) if k == "t_max" else v for k, v in kw.items()})
    got = ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd), impl="plain",
                         **{k: torch.tensor(v) if k == "t_max" else v for k, v in kw.items()})
    np.testing.assert_array_equal(got["steps"].numpy(), np.asarray(want["steps"]))
    assert got["steps"].dtype == torch.int32 and int(got["steps"].min()) >= 1
    # K1's counts on the uncut tree are the oracle's steps
    t0 = torch.tensor(dist) if any_hit else ttrav._t0_of(None, ro.shape[0], "cpu")
    _, _, _, _, counts = bvh_traverse(ts, torch.tensor(ro), torch.tensor(rd), t0,
                                      any_hit=any_hit, t_min=kw.get("t_min", 1e-4), stats=True)
    np.testing.assert_array_equal(counts["node_steps"].numpy(), np.asarray(want["steps"]))


@pytest.mark.parametrize("lod_depth", [3, 9])
def test_lod_oracle_steps_equal_k1_lod_counts_on_camera_rays(lod_depth):
    """With voxel LOD, K1 walks the tree baked at lod_depth and the oracle
    the scene's own tree, testing each voxel's depth: a voxel hit takes
    the miss link in both, so on camera rays, which start outside every
    voxel's box, the node steps are equal ray for ray (a ray starting
    inside a voxel's box enters its subtree in the oracle only)."""
    _, ts, ro, rd, _ = _knot()
    lod = enable_voxel_lod(ts, lod_depth=lod_depth)
    ro, rd = torch.tensor(ro[:2048]), torch.tensor(rd[:2048])
    steps = ttrav.traverse(lod, ro, rd, impl="plain")["steps"]
    counts = bvh_traverse(lod, ro, rd, ttrav._t0_of(None, 2048, "cpu"), stats=True)[4]
    assert torch.equal(counts["node_steps"], steps)


def test_dead_lanes_take_no_steps():
    """A lane with t_max <= t_min never walks (the kernels' rule); the
    reference walks it without a possible hit."""
    _, ts, ro, rd, dist = _knot()
    t_max = torch.tensor(np.where(np.arange(ro.shape[0]) % 3 == 0, 0.0, dist))
    got = ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd), t_max=t_max, impl="plain")
    dead = (t_max <= 1e-4).numpy()
    assert (got["steps"].numpy()[dead] == 0).all() and (got["steps"].numpy()[~dead] > 0).all()
    assert (got["prim"].numpy()[dead] == -1).all()


def _walks():
    _, ts, ro, rd, dist = _knot()
    lod = enable_voxel_lod(ts, lod_depth=6)
    return {
        "k1": (ts, lambda s, *a: ttrav._traverse_plain(s, *a, stats=True)),
        "k1_baked_lod": (lod, lambda s, *a: ttrav._traverse_plain(s, *a, stats=True, baked=True)),
        "k3": (with_plk_layout(ts), lambda s, *a: ttrav._traverse_plk_plain(s, *a, stats=True)),
        "k3_lod": (with_plk_layout(lod),
                   lambda s, *a: ttrav._traverse_plk_plain(s, *a, stats=True)),
        "k4": (with_trl_layout(ts), lambda s, *a: ttrav._traverse_trl_plain(s, *a, stats=True)),
    }, ro, rd, dist


@pytest.mark.parametrize("walk", ["k1", "k1_baked_lod", "k3", "k3_lod", "k4"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_per_ray_counts_sum_to_the_totals(walk, any_hit):
    walks, ro, rd, dist = _walks()
    scene, fn = walks[walk]
    t0 = torch.tensor(dist) if any_hit else ttrav._t0_of(None, ro.shape[0], "cpu")
    t_min = 1e-3 if any_hit else 1e-4
    h, work = fn(scene, torch.tensor(ro), torch.tensor(rd), t0, any_hit, t_min)
    plain = fn(scene, torch.tensor(ro), torch.tensor(rd), t0, any_hit, t_min)[0]
    for k in ("t", "prim"):
        assert torch.equal(h[k], plain[k]), k
    counts = h["counts"]
    assert set(counts) == ({"node_steps", "prim_tests"} if walk.startswith("k1")
                           else set(ttrav.TREELET_COUNTS))
    for k, c in counts.items():
        assert c.dtype == torch.int32 and c.shape == (ro.shape[0],) and int(c.min()) >= 0
        if walk.startswith("k1") and any_hit and k == "prim_tests":
            assert 0 < int(c.sum()) < work[k], (int(c.sum()), work[k])
        else:
            assert int(c.sum()) == work[k], (k, int(c.sum()), work[k])
    if walk.startswith("k1"):
        assert torch.equal(counts["node_steps"], h["steps"])


def test_any_hit_prim_tests_stop_at_the_first_accepted_hit():
    """Two stacked quads, four triangles in one leaf: an any-hit ray down
    the stack hits one triangle of each quad; its prim tests stop at the
    first of them in leaf order (the kernel's `if (kAnyHit) break;`),
    while the walk tests all four, and a closest-hit ray tests four."""
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE)
    for z in (0.0, -1.0):
        b.add_quad([-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z], m)
    scene = b.build("cpu")
    assert scene["nodes_prim_count"].tolist() == [4]
    order = scene["prim_order"].tolist()
    # (x, y) below the diagonal hit triangles 0 and 2, above it 1 and 3
    xy = np.array([[0.5, -0.5], [-0.5, 0.5], [0.3, -0.2], [-0.7, 0.1]], np.float32)
    ro = torch.tensor(np.concatenate([xy, np.full((4, 1), 5.0, np.float32)], 1))
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    t0 = torch.full((4,), 100.0)
    hit_tris = [(0, 2) if x > y else (1, 3) for x, y in xy]
    want = [min(order.index(p) for p in tris) + 1 for tris in hit_tris]
    h, work = ttrav._traverse_plain(scene, ro, rd, t0, True, 1e-4, stats=True)
    assert h["counts"]["prim_tests"].tolist() == want
    assert work["prim_tests"] == 16 and h["counts"]["node_steps"].tolist() == [1] * 4
    assert sorted(want) != [4] * 4  # the rule shows: some ray stops early
    h, work = ttrav._traverse_plain(scene, ro, rd, t0, False, 1e-4, stats=True)
    assert h["counts"]["prim_tests"].tolist() == [4] * 4 and work["prim_tests"] == 16
    # K1's wrapper gives these counts on CPU tensors
    _, _, _, _, counts = bvh_traverse(scene, ro, rd, t0, any_hit=True, stats=True)
    assert counts["prim_tests"].tolist() == want


def _heatmap_rays():
    rng = np.random.default_rng(0)
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    pts = rng.uniform(-3, 3, (600 * 3, 3)).astype(np.float32)
    for b in (jb, tb):
        m = b.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
        b.add_mesh(pts, np.arange(600 * 3).reshape(-1, 3), m)
    cam = jcam.PinholeCamera(origin=(0, 0, 10), lookat=(0, 0, 0), width=16, height=16)
    lpix = np.arange(16 * 16)
    s = ((lpix % 16).astype(np.float32) + 0.5) / 16
    t = ((lpix // 16).astype(np.float32) + 0.5) / 16
    ro, rd = jcam.generate_ray(cam.arrays(), jnp.asarray(s), jnp.asarray(t))
    return jb.build(), tb.build("cpu"), np.asarray(ro), np.asarray(rd)


def test_traversal_heatmap_matches_reference():
    """tests/test_debug_bluenoise.py::test_traversal_heatmap's scene."""
    js, ts, ro, rd = _heatmap_rays()
    want = np.asarray(jdebug.traversal_heatmap(js, jnp.asarray(ro), jnp.asarray(rd), 16, 16))
    got = tdebug.traversal_heatmap(ts, torch.tensor(ro), torch.tensor(rd), 16, 16).numpy()
    assert got.shape == (16, 16, 3) and want.std() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # K1's kStats counts (its plain version here) give the same map
    k1 = tdebug.traversal_heatmap(ts, torch.tensor(ro), torch.tensor(rd), 16, 16, impl="cuda")
    np.testing.assert_array_equal(k1.numpy(), got)


def test_debug_views_match_reference():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, 257).astype(np.float32)
    np.testing.assert_allclose(tdebug.temperature(torch.tensor(x)).numpy(),
                               np.asarray(jdebug.temperature(jnp.asarray(x))), rtol=1e-6, atol=0)
    ids = rng.integers(-3, 1 << 20, 500).astype(np.int32)
    np.testing.assert_array_equal(tdebug._id_colors(torch.tensor(ids)).numpy(),
                                  np.asarray(jdebug._id_colors(jnp.asarray(ids))))
    aovs = {"normal": rng.uniform(-1, 1, (8, 8, 3)), "albedo": rng.uniform(-0.5, 1.5, (8, 8, 3)),
            "depth": np.where(rng.random((8, 8)) < 0.2, -1.0, rng.uniform(0, 9, (8, 8))),
            "pos": rng.normal(size=(8, 8, 3)), "prim": rng.integers(-1, 99, (8, 8)),
            "mtl": rng.integers(-1, 5, (8, 8))}
    aovs = {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32) for k, v in aovs.items()}
    taovs = {k: torch.tensor(v) for k, v in aovs.items()}
    for mode in ("normal", "depth", "albedo", "prim_id", "mtl_id", "position"):
        np.testing.assert_allclose(
            tdebug.aov_debug_image(taovs, mode).numpy(),
            np.asarray(jdebug.aov_debug_image({k: jnp.asarray(v) for k, v in aovs.items()}, mode)),
            rtol=1e-6, atol=1e-7, err_msg=mode)
    with pytest.raises(ValueError):
        tdebug.aov_debug_image(taovs, "nope")
    img = rng.random((8, 8, 3)).astype(np.float32)
    got = tdebug.pick_pixel(torch.tensor(img), taovs, 3, 5)
    want = jdebug.pick_pixel(jnp.asarray(img), {k: jnp.asarray(v) for k, v in aovs.items()}, 3, 5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name,kernel", [("mesh", None), ("large@6", None), ("mesh@9", "k4")])
def test_tool_runs_on_the_cpu(name, kernel):
    lines = []
    out = trav_stats.run(name, torch.device("cpu"), 64, kernel=kernel, knot=(40, 25),
                         log=lines.append)
    want = {"k1": ("node_steps", "prim_tests")}.get(
        kernel or trav_stats.default_kernel(name), ttrav.TREELET_COUNTS)
    assert set(out) == {"closest", "any"}
    for kind, rows in out.items():
        assert tuple(rows) == tuple(want)
        for k, s in rows.items():
            r = s["per_ray"]
            assert s["rays"] > 0 and 0 <= r["p50"] <= r["p90"] <= r["max"]
            assert r["total"] == pytest.approx(r["mean"] * s["rays"])
            assert s["per_tile"]["sum"]["max"] <= r["total"]
            assert s["per_warp"]["max_over_mean"] >= 1.0 or r["total"] == 0
    assert out["closest"]["node_steps"]["rays"] == 64 * 64
    assert any("closest node_steps" in line for line in lines)
    if name == "mesh":
        # K1 on the uncut tree: the tool's node steps are the oracle's
        scene, cam, _ = trav_stats.build_scene(name, 64, "cpu", knot=(40, 25))
        ro, rd = trav_stats.primary_rays(cam, 64, "cpu")
        steps = ttrav.traverse(scene, ro, rd, impl="plain")["steps"]
        assert out["closest"]["node_steps"]["per_ray"]["total"] == int(steps.sum())
