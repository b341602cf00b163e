"""aten_tpu_torch instancing (TLAS/BLAS) against aten_tpu.

* `build_two_level` and the instanced `SceneBuilder` give the
  reference's arrays bit for bit.
* The two-level walk (plain, and impl="cuda", which on the CPU is the
  plain walk) is held to the reference's `traverse_two_level` with the
  bounds of test_pallas_tpu.py::test_tlas_treelet_kernel_parity_instanced:
  hits equal, prim agreement >= 0.999, instances equal where prims
  agree, t within rtol = atol = 1e-4; any-hit verdicts equal.
* u/v: object-space rays come from a 3x4 transform that XLA on the CPU
  may sum and contract differently from the port, which rounds every op
  in the order ((m0*x + m1*y) + m2*z) + m3.  Held to the oracle's
  formulas evaluated in numpy float32 in that order, u/v agree within
  1e-5; against XLA's values, within 1e-5 on all but 1-2% of hits
  (rays from up to 20 units away onto small triangles amplify the
  rounding of the transform) and within 1e-4 on all.
* `eval_hit` on instanced hits within 1e-5; the instanced slice render
  within the full-image radiance bounds.
* The counterparts of tests/test_tlas.py, and the kernel wrapper's
  argument checks.
* The reference's own K5 Pallas kernel (`traverse_pallas_tlas`, run in
  TPU interpret mode) against the port's two-level walk on the blob
  scene of test_pallas_tpu.py: closest-hit at that test's bounds;
  any-hit verdicts equal (the TPU kernel walks tile by tile and may stop
  on another leaf, as test_pallas_tpu.py's any-hit gate allows).
* K5's packed records (ops/tlas_layout.py): they unpack bit for bit to
  the pool they pack, the packer refuses broken links and wrong BLAS
  roots, and every instanced scene carries them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aten_tpu.accel import tlas as jtlas
from aten_tpu.accel.traverse import occluded as jax_occluded
from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import eval_hit as jax_eval_hit
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.ops import traverse_pallas as jtp
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel import tlas as ttlas
from aten_tpu_torch.accel import traverse as ttrav
from aten_tpu_torch.integrator.pathtracer import eval_hit, render_image
from aten_tpu_torch.ops import bvh_layout, tlas_cuda, tlas_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import Scene, SceneBuilder
from aten_tpu_torch.utils import spans
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)

SMALL = {"n_u": 48, "n_v": 16}  # 1,536 knot triangles: native BLAS build



def _bridged(js):
    return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays),
                             js.static, "cpu")


_FIXTURE = {}


def _fixture():
    """(reference SceneData, port Scene via the bridge, camera) of the
    small instanced fixture."""
    if not _FIXTURE:
        b = JaxSceneBuilder()
        cam = tdefs.populate_instanced_mesh_scene(b, 64, 64, **SMALL)
        js = b.build()
        _FIXTURE["v"] = (js, _bridged(js), cam)
    return _FIXTURE["v"]


def _blob_scenes(builder_cls):
    """test_tlas_treelet_kernel_parity_instanced's scene: a 400-triangle
    blob (object-local) instanced 16 times on a 4x4 grid."""
    rng = np.random.default_rng(0)
    sb = builder_cls()
    m = sb.add_material(MaterialType.DIFFUSE, base_color=(0.6, 0.6, 0.6))
    o = sb.create_object()
    centers = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    tris = centers[:, None, :] + rng.uniform(-0.15, 0.15, (400, 3, 3)).astype(np.float32)
    sb.add_mesh(tris.reshape(-1, 3), np.arange(1200).reshape(-1, 3), m, obj=o)
    for i in range(4):
        for j in range(4):
            mtx = np.eye(4, dtype=np.float32)
            mtx[:3, 3] = (i * 3.0 - 4.5, 0.0, j * 3.0 - 4.5)
            sb.add_instance(o, mtx)
    return sb


def _rays(kind, js=None):
    if kind == "blob_grid":  # the 96x96 grid of the TPU kernel's gate
        n = 96
        gx, gy = np.meshgrid(np.linspace(-6, 6, n, dtype=np.float32),
                             np.linspace(-2, 2, n, dtype=np.float32))
        ro = np.stack([gx, gy, np.full((n, n), 8.0, np.float32)], -1).reshape(-1, 3)
        rd = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n * n, 1))
        return ro, rd
    rng = np.random.default_rng(7)
    n = 4096
    if kind == "fixture_random":  # origins in the field, any direction
        ro = np.stack([rng.uniform(-9, 9, n), rng.uniform(-0.5, 5, n),
                       rng.uniform(-9, 11, n)], -1).astype(np.float32)
    else:  # "fixture_surface": from points on world and object triangles
        T = js["num_tris"]
        tid = rng.integers(0, T, n)
        b = rng.random((n, 2))
        b[b.sum(1) > 1] = 1.0 - b[b.sum(1) > 1]
        v0, e1, e2 = (np.asarray(js[k])[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
        ro = (v0 + b[:, :1] * e1 + b[:, 1:] * e2).astype(np.float32)
    d = rng.standard_normal((n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def _uv_f32(js, ro, rd, prim, inst):
    """The oracle's u/v of `prim` for the object-space ray of `inst`,
    in numpy float32 with every op rounded, the transform summed
    ((m0*x + m1*y) + m2*z) + m3."""
    T = js["tri_v0"].shape[0]
    w2l = np.asarray(js["inst_w2l"])[np.where(inst >= 0, inst, js["num_instances"])]
    o = [w2l[:, i, 0] * ro[:, 0] + w2l[:, i, 1] * ro[:, 1] + w2l[:, i, 2] * ro[:, 2]
         + w2l[:, i, 3] for i in range(3)]
    d = [w2l[:, i, 0] * rd[:, 0] + w2l[:, i, 1] * rd[:, 1] + w2l[:, i, 2] * rd[:, 2]
         for i in range(3)]
    tid = np.clip(prim, 0, T - 1)
    v0, e1, e2 = (np.asarray(js[k])[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
    px = d[1] * e2[:, 2] - d[2] * e2[:, 1]
    py = d[2] * e2[:, 0] - d[0] * e2[:, 2]
    pz = d[0] * e2[:, 1] - d[1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(det) > np.float32(1e-12), np.float32(1.0) / det,
                       np.float32(0.0))
    sx, sy, sz = (o[a] - v0[:, a] for a in range(3))
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1[:, 2] - sz * e1[:, 1]
    qy = sz * e1[:, 0] - sx * e1[:, 2]
    qz = sx * e1[:, 1] - sy * e1[:, 0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    return u, v


def _np(h):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in h.items()}


def _check_parity(js, ro, rd, ref, got):
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["hit"], got["prim"] >= 0)
    m0, m1 = ref["prim"], got["prim"]
    assert (m0 == m1).mean() >= 0.999, (m0 == m1).mean()
    mask = (m0 >= 0) & (m0 == m1)
    np.testing.assert_array_equal(got["inst"][mask], ref["inst"][mask])
    np.testing.assert_array_equal(got["inst"][~got["hit"]], -1)
    np.testing.assert_allclose(got["t"][mask], ref["t"][mask], rtol=1e-4, atol=1e-4)
    tri = mask & (m1 < js["num_tris"])
    u32, v32 = _uv_f32(js, ro, rd, m1, got["inst"])
    np.testing.assert_allclose(got["u"][tri], u32[tri], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["v"][tri], v32[tri], rtol=0, atol=1e-5)
    for k in ("u", "v"):
        d = np.abs(got[k][mask] - ref[k][mask])
        assert (d <= 1e-5).mean() >= 0.98, (k, (d > 1e-5).sum())
        assert d.max() <= 1e-4, (k, d.max())
    return mask


# -- build ------------------------------------------------------------------

def _rot_scale(angle, scale, translate):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * np.asarray(
        scale, np.float32)
    m[:3, 3] = translate
    return m


@pytest.mark.parametrize("n_big", [300, 900])
def test_build_two_level_matches_reference(reference_native, n_big):
    """Object boxes under and over the native builder's 512-prim line,
    translated, rotated and (non-uniformly) scaled instances."""
    rng = np.random.default_rng(n_big)
    objs = []
    start = 0
    for n in (n_big, 7, 40):
        c = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        h = rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32)
        objs.append((c - h, c + h, np.arange(start, start + n, dtype=np.int32)))
        start += n
    inst_obj = [0, 1, 0, 2, 0, 1]
    l2w = [np.eye(4, dtype=np.float32),
           _rot_scale(0.3, (1, 1, 1), (3, 0, 0)),
           _rot_scale(1.1, (0.5, 0.5, 0.5), (-4, 1, 2)),
           _rot_scale(-0.7, (1.5, 0.6, 0.9), (0, -2, 5)),
           _rot_scale(2.0, (2, 2, 2), (6, 6, -6)),
           _rot_scale(0.0, (1, 1, 1), (0, 9, 0))]
    ref = jtlas.build_two_level(objs, inst_obj, np.stack(l2w))
    got = ttlas.build_two_level(objs, inst_obj, np.stack(l2w))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    b = ttlas._transform_box(l2w[3], objs[2][0].min(0), objs[2][1].max(0))
    np.testing.assert_array_equal(
        b, jtlas._transform_box(l2w[3], objs[2][0].min(0), objs[2][1].max(0)))


def test_builders_match_reference(reference_native):
    """The port's SceneBuilder and aten_tpu's, filled by the same
    populate function, hold the same pool, geometry and statics."""
    js, ts, cam = _fixture()
    own, _ = tdefs.instanced_mesh_scene(64, 64, **SMALL, device="cpu")
    assert own.static == ts.static
    assert own["num_instances"] == 19 and own["num_tris"] == 2 * 48 * 16 + 4
    for k in bridge.TWO_LEVEL_KEYS + bridge.PORT_KEYS:
        if isinstance(own[k], dict):
            continue
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(js[k]), err_msg=k)
        np.testing.assert_array_equal(own[k].numpy(), ts[k].numpy(), err_msg=k)
    assert "nodes_bmin" not in own and "prim_order" not in own


def test_full_size_fixture_is_on_the_tlas_kernel_path(reference_native):
    """At full size aten_tpu's build of the fixture carries the tt_*
    layout, so on a TPU its traversal launches _make_tlas_treelet_kernel
    (aten_tpu/accel/tlas.py:198-203); the port's pool is the same."""
    b = JaxSceneBuilder()
    tdefs.populate_instanced_mesh_scene(b, 512, 512)
    js = b.build()
    assert "tt_nodes" in js and js["tt_nodes"].shape[0] < 8192
    assert js["num_instances"] == 19
    assert js["num_tris"] + js["num_spheres"] == 102405
    own, _ = tdefs.instanced_mesh_scene(512, 512, device="cpu")
    for k in bridge.TWO_LEVEL_KEYS:
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(js[k]), err_msg=k)


def test_area_light_on_an_instanced_object_raises():
    b = SceneBuilder()
    m = b.add_material(MaterialType.EMISSIVE, base_color=(1.0, 1.0, 1.0))
    o = b.create_object()
    ts, tc = b.add_quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], m, obj=o)
    with pytest.raises(ValueError):
        b.add_area_light_tris(ts, tc, le=(1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        b.add_instance(o + 1, np.eye(4))


# -- traversal --------------------------------------------------------------

_SETUPS = {}


def _setup(name):
    if name not in _SETUPS:
        if name == "blob_grid":
            js = _blob_scenes(JaxSceneBuilder).build()
            assert "tt_nodes" in js
            ts = _bridged(js)
            own = _blob_scenes(SceneBuilder).build("cpu")
            np.testing.assert_array_equal(own["tl_bmin"].numpy(), ts["tl_bmin"].numpy())
            ro, rd = _rays(name)
        else:
            js, ts, _ = _fixture()
            ro, rd = _rays(name, js)
        _SETUPS[name] = (js, ts, ro, rd)
    return _SETUPS[name]


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("name", ["blob_grid", "fixture_random", "fixture_surface"])
def test_two_level_traversal_matches_oracle(reference_native, name, impl):
    js, ts, ro, rd = _setup(name)
    ref = _np(jtlas.traverse_two_level(js.drop("tt_nodes", "tt_prims", "tt_mats"),
                                       jnp.asarray(ro), jnp.asarray(rd)))
    got = _np(ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd), impl=impl))
    mask = _check_parity(js, ro, rd, ref, got)
    assert mask.sum() > 0.1 * len(mask)
    if name != "blob_grid":  # rays reach several instances and the world
        assert len(np.unique(got["inst"][mask])) >= 10

    dist = np.random.default_rng(2).uniform(0.0, 20.0, ro.shape[0]).astype(np.float32)
    ref_a = np.asarray(jtlas.traverse_two_level(
        js, jnp.asarray(ro), jnp.asarray(rd), t_max=jnp.asarray(dist),
        any_hit=True, t_min=1e-3)["hit"])
    got_a = ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd),
                           t_max=torch.tensor(dist), any_hit=True, t_min=1e-3,
                           impl=impl)["hit"].numpy()
    np.testing.assert_array_equal(got_a, ref_a)
    assert 0.05 < ref_a.mean() < 0.95
    occ_ref = np.asarray(jax_occluded(js, jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(dist)))
    occ = ttrav.occluded(ts, torch.tensor(ro), torch.tensor(rd), torch.tensor(dist),
                         impl=impl).numpy()
    np.testing.assert_array_equal(occ, occ_ref)


def test_dead_lanes_never_hit(reference_native):
    """Lanes whose t_max is at most t_min return (t_max, -1, -1, 0, 0),
    as the oracle gives."""
    js, ts, ro, rd = _setup("fixture_random")
    t_max = np.where(np.arange(ro.shape[0]) % 2 == 0, 0.0, 1e30).astype(np.float32)
    ref = _np(jtlas.traverse_two_level(js, jnp.asarray(ro), jnp.asarray(rd),
                                       t_max=jnp.asarray(t_max)))
    got = _np(ttlas.traverse_two_level(ts, torch.tensor(ro), torch.tensor(rd),
                                       t_max=torch.tensor(t_max), impl="plain"))
    dead = t_max == 0.0
    assert (got["prim"][dead] == -1).all() and (got["inst"][dead] == -1).all()
    assert (got["t"][dead] == 0.0).all() and (got["u"][dead] == 0.0).all()
    np.testing.assert_array_equal(got["prim"], ref["prim"])
    np.testing.assert_array_equal(got["inst"], ref["inst"])


def test_instanced_scene_skips_the_dense_test():
    """A two-level scene under DENSE_MAX_PRIMS still takes the two-level
    walk (the dense test knows nothing of instances); forcing the dense
    test raises."""
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE)
    o = b.create_object()
    b.add_sphere((0, 0, 0), 1.0, m, obj=o)
    b.add_instance(o, _rot_scale(0.0, (1, 1, 1), (5, 0, 0)))
    sc = b.build("cpu")
    ro = torch.tensor([[5.0, 0.0, 4.0], [0.0, 0.0, 4.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    h = ttrav.traverse(sc, ro, rd)
    assert h["hit"].tolist() == [True, False] and h["inst"].tolist() == [0, -1]
    np.testing.assert_allclose(h["t"][0].item(), 3.0, rtol=1e-6)
    with pytest.raises(ValueError):
        ttrav.traverse(sc, ro, rd, impl="dense")


def test_plain_walk_stats_count_the_work(reference_native):
    """stats=True changes no result and counts the work: every lane
    takes at least one node step; every instance entry is a step."""
    js, ts, ro, rd = _setup("fixture_random")
    ro, rd = torch.tensor(ro), torch.tensor(rd)
    t0 = torch.full((ro.shape[0],), 3.4e38)
    plain = ttlas._traverse_two_level_plain(ts, ro, rd, t0, False, 1e-4)
    got, st = ttlas._traverse_two_level_plain(ts, ro, rd, t0, False, 1e-4, stats=True)
    for k in plain:
        assert torch.equal(plain[k], got[k]), k
    assert st["node_steps"] >= ro.shape[0] + st["inst_entries"]
    assert st["inst_entries"] >= int((got["inst"] >= 0).sum())
    assert 0 < st["prim_tests"] <= 4 * st["node_steps"]

    _, single, _ = _single_level()
    h, st1 = ttrav._traverse_plain(single, ro, rd, t0, False, 1e-4, stats=True)
    h0 = ttrav._traverse_plain(single, ro, rd, t0, False, 1e-4)
    for k in h0:
        assert torch.equal(h0[k], h[k]), k
    assert st1["node_steps"] >= ro.shape[0] and st1["prim_tests"] > 0


def _single_level():
    b = SceneBuilder()
    cam = tdefs.populate_procedural_mesh_scene(b, 16, 16, n_u=24, n_v=12)
    return b, b.build("cpu"), cam


# -- the counterparts of tests/test_tlas.py ----------------------------------

def _sphere_mesh(n=6):
    th = np.linspace(0, np.pi, n + 1)
    ph = np.linspace(0, 2 * np.pi, 2 * n + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                   axis=-1).reshape(-1, 3)
    faces = []
    W = 2 * n + 1
    for i in range(n):
        for j in range(2 * n):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            faces += [[a, b, c], [b, d, c]]
    return pos.astype(np.float32), np.asarray(faces, np.int64)


def _ray_grid(n=24, z=5.0, span=3.0):
    xs = np.linspace(-span, span, n, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs)
    ro = np.stack([X.ravel(), Y.ravel(), np.full(n * n, z, np.float32)], -1)
    rd = np.tile(np.array([[0, 0, -1]], np.float32), (n * n, 1))
    return torch.tensor(ro), torch.tensor(rd)


def _translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def test_identity_instance_matches_plain():
    pos, faces = _sphere_mesh()
    sb = SceneBuilder()
    m = sb.add_material(MaterialType.DIFFUSE, base_color=(0.7, 0.7, 0.7))
    sb.add_mesh(pos, faces, m)
    plain = sb.build("cpu")
    sb2 = SceneBuilder()
    m2 = sb2.add_material(MaterialType.DIFFUSE, base_color=(0.7, 0.7, 0.7))
    o = sb2.create_object()
    sb2.add_mesh(pos, faces, m2, obj=o)
    sb2.add_instance(o, np.eye(4))
    inst = sb2.build("cpu")
    assert inst["num_instances"] == 1
    ro, rd = _ray_grid()
    h0 = ttrav.traverse(plain, ro, rd, impl="plain")
    h1 = ttrav.traverse(inst, ro, rd)
    assert torch.equal(h0["hit"], h1["hit"]) and torch.equal(h0["prim"], h1["prim"])
    np.testing.assert_allclose(h1["t"][h1["hit"]], h0["t"][h0["hit"]], rtol=1e-5)


def test_instances_match_baked_transforms():
    pos, faces = _sphere_mesh()
    offsets = [(-2.0, 0.0, 0.0), (2.0, 0.5, -1.0), (0.0, -1.5, 1.0)]
    sb = SceneBuilder()
    m = sb.add_material(MaterialType.DIFFUSE, base_color=(0.7, 0.7, 0.7))
    for off in offsets:
        sb.add_mesh(pos + np.asarray(off, np.float32), faces, m)
    baked = sb.build("cpu")
    sb2 = SceneBuilder()
    m2 = sb2.add_material(MaterialType.DIFFUSE, base_color=(0.7, 0.7, 0.7))
    o = sb2.create_object()
    sb2.add_mesh(pos, faces, m2, obj=o)
    for off in offsets:
        sb2.add_instance(o, _translate(off))
    inst = sb2.build("cpu")
    assert inst["num_instances"] == 3
    ro, rd = _ray_grid()
    h0 = ttrav.traverse(baked, ro, rd, impl="plain")
    h1 = ttrav.traverse(inst, ro, rd)
    mask = h0["hit"]
    assert torch.equal(mask, h1["hit"]) and bool(mask.any())
    np.testing.assert_allclose(h1["t"][mask], h0["t"][mask], rtol=1e-4, atol=1e-5)
    F = len(faces)
    # baked prim ids are instance-major; instanced ids are object-local
    assert torch.equal(h0["prim"][mask] % F, h1["prim"][mask])
    assert torch.equal(h0["prim"][mask] // F, h1["inst"][mask])


def test_rotated_instance_normals():
    """An instanced analytic sphere under rotation and translation:
    eval_hit's world normal is the geometric sphere normal."""
    sb = SceneBuilder()
    m = sb.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    o = sb.create_object()
    sb.add_sphere((0, 0, 0), 1.0, m, obj=o)
    sb.add_instance(o, _translate((1.0, 2.0, 0.0)) @ _rot_scale(0.7, (1, 1, 1), (0, 0, 0)))
    sc = sb.build("cpu")
    ro, rd = _ray_grid(n=16, z=5.0, span=0.8)
    ro = ro + torch.tensor([1.0, 2.0, 0.0])
    h = ttrav.traverse(sc, ro, rd)
    mask = h["hit"]
    assert bool(mask.any())
    res = eval_hit(sc, ro, rd, h)
    p = res["p"][mask].numpy()
    expect = p - np.array([1.0, 2.0, 0.0], np.float32)
    expect /= np.linalg.norm(expect, axis=1, keepdims=True)
    np.testing.assert_allclose(res["ns"][mask].numpy(), expect, atol=1e-4)
    np.testing.assert_allclose(res["ng"][mask].numpy(), expect, atol=1e-4)


def test_occlusion_through_instance():
    pos, faces = _sphere_mesh()
    sb = SceneBuilder()
    m = sb.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    o = sb.create_object()
    sb.add_mesh(pos, faces, m, obj=o)
    sb.add_instance(o, _translate((0.0, 0.0, 0.0)))
    sc = sb.build("cpu")
    ro = torch.tensor([[0.0, 0.0, 4.0], [3.0, 0.0, 4.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    occ = ttrav.occluded(sc, ro, rd, torch.tensor([8.0, 8.0]))
    assert occ.tolist() == [True, False]


# -- shading and the slice ----------------------------------------------------

def test_eval_hit_matches_reference_on_instanced_hits(reference_native):
    """The reference's hits fed to both eval_hits: p, ns, ng within 1e-5,
    mtl and light equal.  The rays reach knot, world and both spheres,
    the ellipsoid among them."""
    js, ts, ro, rd = _setup("fixture_random")
    hit = jtlas.traverse_two_level(js, jnp.asarray(ro), jnp.asarray(rd))
    ref = _np(jax_eval_hit(js, jnp.asarray(ro), jnp.asarray(rd), hit))
    th = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in hit.items()}
    got = _np(eval_hit(ts, torch.tensor(ro), torch.tensor(rd), th))
    m = np.asarray(hit["hit"])
    prim = np.asarray(hit["prim"])
    inst = np.asarray(hit["inst"])
    assert set(inst[prim == js["num_tris"]]) == {16, 17}  # both spheres hit
    for k in ("p", "ns", "ng"):
        np.testing.assert_allclose(got[k][m], ref[k][m], rtol=0, atol=1e-5, err_msg=k)
    for k in ("mtl", "light"):
        np.testing.assert_array_equal(got[k][m], ref[k][m], err_msg=k)
    n = np.linalg.norm(got["ns"][m], axis=1)
    np.testing.assert_allclose(n, 1.0, atol=1e-6)


def _image_bounds(img, ref):
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    return (rel > 2e-2).mean(), rel.mean()


def test_instanced_scene_matches_reference_render(reference_native):
    """The slice: the small fixture at 64x64, 4 spp, depth 3 against
    aten_tpu's render_image, within the full-image radiance bounds; the
    port's own builder's scene renders identically to the bridged one."""
    js, ts, cam = _fixture()
    ref = np.asarray(jax_render_image(
        js, JaxPinholeCamera(**dataclasses.asdict(cam)), spp=4, max_depth=3))
    img = render_image(ts, cam, spp=4, max_depth=3).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    frac, mean_rel = _image_bounds(img, ref)
    assert frac < 5e-3, frac
    assert mean_rel < 3e-3, mean_rel
    own, _ = tdefs.instanced_mesh_scene(64, 64, **SMALL, device="cpu")
    np.testing.assert_array_equal(render_image(own, cam, spp=4, max_depth=3).numpy(), img)


def test_instanced_render_plain_and_cuda_impls_agree(reference_native):
    """impl "plain" and "cuda" (whose CPU path is the plain walk) render
    the same image and the wrapper counts no launch on the CPU."""
    spans.reset()
    _, ts, cam = _fixture()
    small = dataclasses.replace(cam, width=24, height=24)
    a = render_image(ts, small, spp=2, max_depth=3, impl="plain").numpy()
    b = render_image(ts, small, spp=2, max_depth=3, impl="cuda").numpy()
    np.testing.assert_array_equal(a, b)
    assert not [k for k in spans.counters() if k.startswith("launch.")]


# -- the kernel wrapper --------------------------------------------------------

def test_wrapper_runs_plain_version_on_cpu(reference_native):
    _, ts, ro, rd = _setup("fixture_random")
    ro, rd = torch.tensor(ro), torch.tensor(rd)
    for any_hit in (False, True):
        t0 = torch.full((ro.shape[0],), 7.5)
        a = tlas_cuda.tlas_traverse(ts, ro, rd, t0, any_hit=any_hit)
        b = ttlas._traverse_two_level_plain(ts, ro, rd, t0, any_hit, 1e-4)
        for x, k in zip(a, ("t", "prim", "inst", "u", "v")):
            assert torch.equal(x, b[k]), k


def test_wrapper_rejects_bad_arguments(reference_native):
    _, ts, ro, rd = _setup("fixture_random")
    ro, rd = torch.tensor(ro[:64]), torch.tensor(rd[:64])
    t0 = torch.full((64,), 5.0)
    with pytest.raises(ValueError, match="ro"):
        tlas_cuda.tlas_traverse(ts, ro.double(), rd, t0)
    with pytest.raises(ValueError, match="rd"):
        tlas_cuda.tlas_traverse(ts, ro, rd[:, :2].contiguous(), t0)
    with pytest.raises(ValueError, match="contiguous"):
        tlas_cuda.tlas_traverse(ts, ro, rd.t().contiguous().t(), t0)
    with pytest.raises(ValueError, match="differ"):
        tlas_cuda.tlas_traverse(ts, ro, rd, t0[:10])
    with pytest.raises(ValueError, match="unsupported device"):
        tlas_cuda.tlas_traverse(ts, ro.to("meta"), rd.to("meta"), t0.to("meta"))
    bad = Scene({**ts.arrays, "tl_hit": ts["tl_hit"].long()}, ts.static, ts.device)
    with pytest.raises(ValueError, match="tl_hit"):
        tlas_cuda.tlas_traverse(bad, ro, rd, t0)
    bad = Scene({**ts.arrays, "inst_w2l": ts["inst_w2l"][:-1]}, ts.static, ts.device)
    with pytest.raises(ValueError, match="inst_w2l"):
        tlas_cuda.tlas_traverse(bad, ro, rd, t0)
    bad = Scene({**ts.arrays, "tl_insts": ts["tl_insts"][:-1]}, ts.static, ts.device)
    with pytest.raises(ValueError, match="tl_insts"):
        tlas_cuda.tlas_traverse(bad, ro, rd, t0)


@pytest.mark.parametrize("key", tlas_layout.ARRAY_KEYS)
def test_wrapper_refuses_a_scene_without_the_records(reference_native, key):
    """The wrapper checks K5's packed records on every device, so on a
    CUDA tensor it never launches over a scene that lacks one; here, on
    the CPU, it raises before its plain walk."""
    _, ts, ro, rd = _setup("fixture_random")
    ro, rd = torch.tensor(ro[:64]), torch.tensor(rd[:64])
    t0 = torch.full((64,), 5.0)
    bare = Scene({k: v for k, v in ts.arrays.items() if k != key}, ts.static, ts.device)
    with pytest.raises(ValueError, match=key):
        tlas_cuda.tlas_traverse(bare, ro, rd, t0)
    shifted = torch.empty(ts[key].numel() + 1)[1:].view(ts[key].shape)
    shifted.copy_(ts[key])
    bad = Scene({**ts.arrays, key: shifted}, ts.static, ts.device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tlas_cuda.tlas_traverse(bad, ro, rd, t0)


# -- K5 against the reference's own Pallas kernel ----------------------------

@pytest.mark.parametrize("kind", ["closest", "any"])
def test_k5_matches_reference_pallas_kernel(reference_native, kind):
    """aten_tpu's `traverse_pallas_tlas` (`_make_tlas_treelet_kernel`)
    in TPU interpret mode and the port's two-level walk (impl="cuda", the
    kernel's plain version on the CPU) on the same numpy rays: 32x32 rays
    of test_pallas_tpu.py's grid over the 16-instance blob scene, their
    directions jittered.  Closest-hit: hits equal, prim agreement >=
    0.999, instances equal and t within rtol = atol = 1e-4 where prims
    agree.  Any-hit: verdicts equal."""
    js, ts, _, _ = _setup("blob_grid")
    n = 32
    rng = np.random.default_rng(5)
    gx, gy = np.meshgrid(np.linspace(-6, 6, n, dtype=np.float32),
                         np.linspace(-2, 2, n, dtype=np.float32))
    ro = np.stack([gx, gy, np.full((n, n), 8.0, np.float32)], -1).reshape(-1, 3)
    d = np.tile([[0.0, 0.0, -1.0]], (n * n, 1)) + rng.uniform(-0.15, 0.15, (n * n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dist = rng.uniform(0.0, 12.0, n * n).astype(np.float32)
    kw = {} if kind == "closest" else {"any_hit": True, "t_min": 1e-3}
    with pltpu.force_tpu_interpret_mode():
        ref = jtp.traverse_pallas_tlas(
            js, jnp.asarray(ro), jnp.asarray(rd),
            t_max=None if kind == "closest" else jnp.asarray(dist), **kw)
    ref = _np(ref)
    got = _np(ttrav.traverse(ts, torch.tensor(ro), torch.tensor(rd),
                             t_max=None if kind == "closest" else torch.tensor(dist),
                             impl="cuda", **kw))
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    assert 0.1 < got["hit"].mean() < 0.9
    if kind == "any":
        return
    m0, m1 = ref["prim"], got["prim"]
    assert (m0 == m1).mean() >= 0.999, (m0 == m1).mean()
    mask = (m0 >= 0) & (m0 == m1)
    np.testing.assert_array_equal(got["inst"][mask], ref["inst"][mask])
    np.testing.assert_allclose(got["t"][mask], ref["t"][mask], rtol=1e-4, atol=1e-4)
    assert len(np.unique(got["inst"][mask])) == 16


# -- K5's packed records -------------------------------------------------------

def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("name", ["fixture", "blob", "one_instance"])
def test_records_unpack_to_the_pool(reference_native, name):
    """tl_nodes and tl_insts unpack bit for bit to the tl_* arrays and
    inst_w2l they pack; tl_prims are K1's records of tl_prim_order."""
    if name == "fixture":
        s = _fixture()[1]
    elif name == "blob":
        s = _blob_scenes(SceneBuilder).build("cpu")
    else:
        sb = SceneBuilder()
        m = sb.add_material(MaterialType.DIFFUSE)
        o = sb.create_object()
        sb.add_sphere((0.0, 0.0, 0.0), 1.0, m, obj=o)
        sb.add_instance(o, _rot_scale(0.4, (1, 2, 1), (1, 0, 0)))
        s = sb.build("cpu")
    u = tlas_layout.unpack_two_level(s["tl_nodes"].numpy(), s["tl_insts"].numpy())
    for k in ("tl_bmin", "tl_bmax", "tl_hit", "tl_miss", "tl_ps", "tl_pc", "tl_inst"):
        assert u[k].dtype == s[k].numpy().dtype, k
        np.testing.assert_array_equal(_bits(u[k]), _bits(s[k].numpy()), err_msg=k)
    n_inst = s["num_instances"]
    np.testing.assert_array_equal(_bits(u["inst_w2l"]), _bits(s["inst_w2l"].numpy()[:n_inst]))
    kt, roots = tlas_layout.blas_roots(*(s[k].numpy() for k in ("tl_hit", "tl_miss", "tl_ps",
                                                                  "tl_inst")))
    np.testing.assert_array_equal(u["inst_root"], roots[s["inst_obj"].numpy()])
    assert (u["inst_root"] >= kt).all()
    want = bvh_layout.prim_records(s["tl_prim_order"].numpy(), *(s[k].numpy() for k in (
        "tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")), s["num_tris"])
    np.testing.assert_array_equal(_bits(s["tl_prims"].numpy()), _bits(want))


def _pool():
    return {k: (v.numpy().copy() if torch.is_tensor(v) else v)
            for k, v in _fixture()[1].arrays.items() if not isinstance(v, dict)}


@pytest.mark.parametrize("fault,match", [
    ("inner_hit", "not the next node"), ("blas_leaf_hit", "must be equal"),
    ("root", "BLAS root"), ("twice", "TLAS leaves, not one"),
    ("tlas_end", "miss link -1"), ("count", "does not pack"),
])
def test_packer_raises_on_a_broken_pool(reference_native, fault, match):
    p = _pool()
    inst, ps = p["tl_inst"], p["tl_ps"]
    leaves = np.nonzero(inst >= 0)[0]
    blas_inner = np.nonzero((ps < 0) & (inst < 0) & (np.arange(len(ps)) > leaves.max()))[0]
    if fault == "inner_hit":
        p["tl_hit"][blas_inner[1]] = p["tl_miss"][blas_inner[1]]
    elif fault == "blas_leaf_hit":
        k = int(np.nonzero(ps >= 0)[0][3])
        p["tl_hit"][k] = k  # a BLAS leaf whose hit link is not its miss link
    elif fault == "root":  # a TLAS leaf into the middle of its object's tree
        p["tl_hit"][leaves[0]] += 1
    elif fault == "twice":
        p["tl_inst"][leaves[1]] = inst[leaves[0]]
    elif fault == "tlas_end":
        p["tl_miss"][leaves[np.argmax(p["tl_miss"][leaves] == -1)]] = 0
    else:
        p["tl_pc"][int(np.nonzero(ps >= 0)[0][0])] = 200
    with pytest.raises(ValueError, match=match):
        tlas_layout.build_tlas_layout(p, p["tri_v0"], p["tri_e1"], p["tri_e2"],
                                      p["sph_center"], p["sph_radius"],
                                      _fixture()[1]["num_tris"])


def test_every_instanced_scene_carries_the_records(reference_native):
    """The builder (both policies that matter to instancing) and the
    bridge attach the records, equal bit for bit; a single-level scene
    gets none."""
    js, ts, _ = _fixture()
    own, _ = tdefs.instanced_mesh_scene(64, 64, **SMALL, device="cpu")
    for k in tlas_layout.ARRAY_KEYS:
        np.testing.assert_array_equal(_bits(own[k].numpy()), _bits(ts[k].numpy()), err_msg=k)
        assert own[k].dtype == torch.float32 and own[k].is_contiguous()
    assert own["tl_nodes"].shape[0] == own["tl_bmin"].shape[0]
    assert own["tl_insts"].shape == (own["num_instances"], tlas_layout.INST_WORDS)
    assert own["tl_prims"].shape[0] == own["tl_prim_order"].shape[0]
    single = _single_level()[1]
    assert not any(k in single for k in tlas_layout.ARRAY_KEYS)
