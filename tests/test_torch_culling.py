"""aten_tpu_torch's frustum culling, compaction and gathers against
aten_tpu's.

* Frustum planes, node masks and prim masks (leaf-conservative and
  refined per prim) bitwise the reference's, on tests/test_frustum.py's
  boxes and on the 2,004-prim knot scene from its camera.
* `compaction_order`, `compact` and `scatter_back`: permutations, counts
  and gathered rows bitwise, and scatter_back of compact the identity.
* `take_rows` and `take_fields` bitwise the reference's, ids above 256
  included (tests/test_gather.py's cases)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bvh_scene import reference_native  # noqa: F401

from aten_tpu.accel import frustum as jfrustum
from aten_tpu.accel.build import build_bvh as jbuild_bvh
from aten_tpu.core.camera import PinholeCamera as JPinhole
from aten_tpu.ops import compaction as jcompaction
from aten_tpu.ops import gather as jgather
from aten_tpu.scene.scene import SceneBuilder as JSceneBuilder
from aten_tpu_torch.accel import frustum
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.ops import compaction, gather
from aten_tpu_torch.scene import scenedefs

torch.set_num_threads(1)
CAM = dict(origin=(0.0, 0.0, 5.0), lookat=(0.0, 0.0, 0.0), vfov_deg=40.0, width=64, height=64)


def _same(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


def test_frustum_on_boxes_matches_reference():
    planes = frustum.frustum_planes_from_camera(PinholeCamera(**CAM))
    np.testing.assert_array_equal(planes, jfrustum.frustum_planes_from_camera(JPinhole(**CAM)))
    rng = np.random.default_rng(0)
    centers = rng.uniform(-6, 6, size=(64, 3)).astype(np.float32)
    bmin, bmax = centers - 0.05, centers + 0.05
    tree = jbuild_bvh(bmin, bmax)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for boxes in ((), (bmin, bmax)):
        pm, nm = frustum.visible_prims(ttree, planes, *boxes)
        jpm, jnm = jfrustum.visible_prims(tree, planes, *boxes)
        _same(pm, jpm)
        _same(nm, jnm)
    brute = frustum.intersect_frustum_nodes(planes, bmin, bmax)
    _same(brute, jfrustum.intersect_frustum_nodes(planes, bmin, bmax))
    assert torch.equal(pm, brute) and 0 < int(pm.sum()) < 64
    for lo, hi, inside in (([-0.1] * 3, [0.1] * 3, True), ([-0.1, -0.1, 7.0], [0.1, 0.1, 7.5], False),
                           ([50.0, -0.1, -0.1], [50.2, 0.1, 0.1], False)):
        got = frustum.intersect_frustum_nodes(planes, torch.tensor([lo]), torch.tensor([hi]))
        assert bool(got[0]) == inside


def test_frustum_on_the_knot_matches_reference(reference_native):
    scene, cam = scenedefs.procedural_mesh_scene(64, 48, n_u=40, n_v=25, device="cpu")
    # the reference's builder populated by the port's fixture, its camera
    # re-seated as the reference's class
    jb = JSceneBuilder()
    jcam = JPinhole(**vars(scenedefs.populate_procedural_mesh_scene(jb, 64, 48, 40, 25)))
    jscene = jb.build()
    assert scene["num_tris"] == 2004
    planes = frustum.frustum_planes_from_camera(cam)
    np.testing.assert_array_equal(planes, jfrustum.frustum_planes_from_camera(jcam))
    keys = ("nodes_bmin", "nodes_bmax", "nodes_prim_start", "nodes_prim_count", "prim_order")
    jtree = {k: np.asarray(jscene[k]) for k in keys}
    for k in keys:
        _same(scene[k], jtree[k])
    p0 = scene["tri_v0"]
    corners = torch.stack([p0, p0 + scene["tri_e1"], p0 + scene["tri_e2"]], 1)
    bmin, bmax = corners.amin(1), corners.amax(1)
    for boxes in ((), (bmin, bmax)):
        pm, nm = frustum.visible_prims(scene, planes, *boxes)
        jpm, jnm = jfrustum.visible_prims(jtree, planes, *(b.numpy() for b in boxes))
        _same(pm, jpm)
        _same(nm, jnm)
    # the knot is in view, the far floor corners are not
    assert 1000 < int(pm.sum()) < 2004


@pytest.mark.parametrize("live", [0.0, 0.1, 0.5, 1.0])
def test_compaction_matches_reference(live):
    rng = np.random.default_rng(int(live * 10) + 1)
    n = 4099
    alive = rng.uniform(size=n) < live
    x = rng.normal(size=(n, 3)).astype(np.float32)
    ids = rng.integers(0, 1 << 20, n).astype(np.int32)
    perm, count, (gx, gi) = compaction.compact(torch.from_numpy(alive), torch.from_numpy(x),
                                               torch.from_numpy(ids))
    jperm, jcount, (jgx, jgi) = jcompaction.compact(jnp.asarray(alive), jnp.asarray(x),
                                                    jnp.asarray(ids))
    for a, b in ((perm, jperm), (gx, jgx), (gi, jgi)):
        _same(a, b)
    assert perm.dtype == torch.int32 and int(count) == int(jcount) == int(alive.sum())
    assert bool(torch.from_numpy(alive)[perm[:int(count)].long()].all())
    bx, bi = compaction.scatter_back(perm, gx, gi)
    assert torch.equal(bx, torch.from_numpy(x)) and torch.equal(bi, torch.from_numpy(ids))
    (jbx,) = jcompaction.scatter_back(jperm, jgx)
    _same(bx, jbx)


def test_take_rows_matches_reference():
    rng = np.random.default_rng(0)
    K, D, N = 1024, 24, 333
    table = (rng.standard_normal((K, D)) * 1e3).astype(np.float32)
    idx = rng.integers(0, K, size=N).astype(np.int32)
    with jax.default_matmul_precision("bfloat16"):
        ref = jax.jit(jgather.take_rows)(jnp.asarray(table), jnp.asarray(idx))
    got = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    _same(got, ref)
    _same(got, table[idx])
    big = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx), max_rows=16)
    _same(big, jgather.take_rows(jnp.asarray(table), jnp.asarray(idx), max_rows=16))


def test_take_fields_int_ids_above_256_match_reference():
    rng = np.random.default_rng(1)
    K, N = 2000, 257
    ids = rng.integers(0, 200_000, size=K).astype(np.int32)
    vals = rng.standard_normal((K, 3)).astype(np.float32)
    scalar = rng.standard_normal(K).astype(np.float32)
    idx = rng.integers(0, K, size=N).astype(np.int32)
    fields = {"tri_start": ids, "pos": vals, "w": scalar}
    with jax.default_matmul_precision("bfloat16"):
        ref = jax.jit(lambda i: jgather.take_fields(
            {k: jnp.asarray(v) for k, v in fields.items()}, i, int_fields=("tri_start",)))(
            jnp.asarray(idx))
    got = gather.take_fields({k: torch.from_numpy(v) for k, v in fields.items()},
                             torch.from_numpy(idx), int_fields=("tri_start",))
    assert sorted(got) == sorted(ref)
    for k in fields:
        assert got[k].dtype == {"tri_start": torch.int32}.get(k, torch.float32)
        _same(got[k], ref[k])
    _same(got["tri_start"], ids[idx])
