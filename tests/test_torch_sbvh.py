"""aten_tpu_torch's SBVH (accel/build.py::build_sbvh, the native
builder's aten_build_sbvh) against aten_tpu's.

* The arrays bitwise the reference's on tests/test_sbvh.py's sliver
  scenes, well formed (every prim referenced, leaf ranges tiling the
  references), and cheaper by the leaf-area proxy than the SAH tree.
* The oracle walk on the SBVH (put on the scene with `Scene.replace`)
  against the SAH tree, as test_sbvh_traversal_matches_sah holds the
  reference, and against the reference's walk on its SBVH (prim
  agreement >= 0.999, t within 1e-4).
* K1's plain version on the SBVH's records (duplicated references)
  against the oracle walk: prim agreement >= 0.999, t within 1e-4 (it
  is in fact bitwise)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sbvh import _boxes, _long_tri_scene
from test_torch_bvh_scene import reference_native  # noqa: F401

from aten_tpu.accel import build as jbuild
from aten_tpu.accel.traverse import traverse as jtraverse
from aten_tpu.scene.materials import MaterialType as JMT
from aten_tpu.scene.scene import SceneBuilder as JSceneBuilder
from aten_tpu_torch.accel.build import build_bvh, build_sbvh
from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plain, traverse
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)


@pytest.mark.parametrize("n,seed", [(200, 0), (300, 2), (400, 5)])
def test_build_sbvh_matches_reference(reference_native, n, seed):
    bmin, bmax = _boxes(_long_tri_scene(n, seed))
    got, ref = build_sbvh(bmin, bmax), jbuild.build_sbvh(bmin, bmax)
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k
    order, ps, pc = got["prim_order"], got["nodes_prim_start"], got["nodes_prim_count"]
    assert set(order.tolist()) == set(range(n)) and len(order) > n
    leaf = ps >= 0
    spans = np.sort(np.stack([ps[leaf], ps[leaf] + pc[leaf]], 1), axis=0)
    assert spans[0, 0] == 0 and (spans[1:, 0] == spans[:-1, 1]).all()
    assert spans[-1, 1] == len(order) and pc.max() <= 4

    def leaf_cost(b):
        d = np.maximum(b["nodes_bmax"] - b["nodes_bmin"], 0)
        area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        lf = b["nodes_prim_start"] >= 0
        return float((area[lf] * b["nodes_prim_count"][lf]).sum())

    # cheaper than the SAH tree; by 10% on test_sbvh_improves_sliver_sah_cost's case
    assert leaf_cost(got) < leaf_cost(build_bvh(bmin, bmax)) * (0.9 if seed == 5 else 1.0)


def test_build_sbvh_below_four_prims_is_the_sah_tree():
    bmin, bmax = _boxes(_long_tri_scene(2, 1))
    got, want = build_sbvh(bmin, bmax), build_bvh(bmin, bmax)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _scenes(tris):
    b, jb = SceneBuilder(), JSceneBuilder()
    faces = np.arange(tris.shape[0] * 3).reshape(-1, 3)
    b.add_mesh(tris.reshape(-1, 3), faces, b.add_material(MaterialType.DIFFUSE))
    jb.add_mesh(tris.reshape(-1, 3), faces, jb.add_material(JMT.DIFFUSE))
    return b.build("cpu"), jb.build()


def _rays(tris, n=500, seed=3):
    """test_sbvh_traversal_matches_sah's n random rays, then n aimed at
    random triangles' centroids."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro2 = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd2 = tris[rng.integers(0, len(tris), n)].mean(axis=1) - ro2
    rd = np.concatenate([rd, rd2.astype(np.float32)])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return np.concatenate([ro, ro2]), rd


def test_sbvh_walks_match_sah_and_reference(reference_native):
    tris = _long_tri_scene(300, seed=2)
    scene, jscene = _scenes(tris)
    sbvh = build_sbvh(*_boxes(tris))
    s_sbvh = scene.replace(**sbvh)
    j_sbvh = jscene.replace(**{k: jnp.asarray(v) for k, v in sbvh.items()})
    ro, rd = _rays(tris)
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    h0 = traverse(scene, tro, trd, impl="plain")
    h1 = traverse(s_sbvh, tro, trd, impl="plain")
    assert torch.equal(h0["hit"], h1["hit"]) and int(h0["hit"].sum()) > 400
    m = h0["hit"]
    np.testing.assert_allclose(h1["t"][m].numpy(), h0["t"][m].numpy(), rtol=1e-5)
    assert torch.equal(h0["prim"][m], h1["prim"][m])
    # against the reference's jitted walk (which contracts FMAs): the
    # traversal tolerances of tests/test_pallas_tpu.py::_check_parity
    ref = jtraverse(j_sbvh, jnp.asarray(ro), jnp.asarray(rd), impl="jax")
    assert (h1["prim"].numpy() == np.asarray(ref["prim"])).mean() >= 0.999
    np.testing.assert_allclose(h1["t"][m].numpy(), np.asarray(ref["t"])[m.numpy()], atol=1e-4)


def test_k1_plain_on_sbvh_records_matches_the_oracle(reference_native):
    tris = _long_tri_scene(400, seed=5)
    scene = _scenes(tris)[0].replace(**build_sbvh(*_boxes(tris)))
    assert scene["bvh_prims"].shape[0] == scene["prim_order"].shape[0] > 400
    rng = np.random.default_rng(7)
    ro = rng.uniform(-6, 6, (2000, 3)).astype(np.float32)
    rd = tris[rng.integers(0, 400, 2000)].mean(axis=1) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd.astype(np.float32))
    dist = torch.from_numpy(rng.uniform(0.5, 9.0, 2000).astype(np.float32))
    for any_hit, t_max, t_min in ((False, None, 1e-4), (True, dist, 1e-3)):
        t0 = _t0_of(t_max, 2000, "cpu")
        oracle = _traverse_plain(scene, ro, rd, t0, any_hit, t_min)
        k1 = _traverse_plain(scene, ro, rd, t0, any_hit, t_min, baked=True)
        assert torch.equal(oracle["hit"], k1["hit"]), any_hit
        if not any_hit:
            assert (oracle["prim"] == k1["prim"]).float().mean() >= 0.999
            m = oracle["hit"]
            assert int(m.sum()) > 1500
            np.testing.assert_allclose(k1["t"][m].numpy(), oracle["t"][m].numpy(), atol=1e-4)
            assert torch.equal(k1["t"], oracle["t"]) and torch.equal(k1["prim"], oracle["prim"])
