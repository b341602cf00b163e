"""aten_tpu_torch's render checkpoints, `Scene.replace` and the entry
points against aten_tpu's.

* The bit-identical resume of tests/test_checkpoint_camera.py on the
  port; each package's .npz resumed by the other (the same keys); the
  nested scene arrays restored through `Scene.replace`.
* `Scene.replace` with a new tree (an SBVH with duplicated references)
  drops every layout of the old one (K3's, K4's, voxel LOD) and attaches
  K1's records of the new tree, which K1's plain version walks exactly
  as the oracle walks the new tree's arrays.
* `entry()` on the CPU against `__graft_entry__.entry()` (jitted) within
  the full-image bounds (tests/test_torch_bands.py: the jitted reference
  contracts FMAs), and `dryrun_multichip(2)` in a gloo group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sbvh import _boxes, _long_tri_scene
from test_torch_bvh_scene import reference_native  # noqa: F401

import __graft_entry__
from aten_tpu.integrator.film import Film as JFilm
from aten_tpu.integrator.pathtracer import render_sample as jrender_sample
from aten_tpu.scene.scenedefs import cornell_box as jcornell_box
from aten_tpu.utils import checkpoint as jckpt
from aten_tpu_torch.accel import voxel
from aten_tpu_torch.accel.build import build_bvh, build_sbvh
from aten_tpu_torch.accel.traverse import _t0_of, _traverse_plain
from aten_tpu_torch.entry import dryrun_multichip, entry
from aten_tpu_torch.integrator.film import Film
from aten_tpu_torch.integrator.pathtracer import render_sample
from aten_tpu_torch.ops import bvh_layout
from aten_tpu_torch.scene import scenedefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import (
    KERNEL_STATICS, SceneBuilder, with_plk_layout, with_trl_layout)
from aten_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
W = H = 24


def _samples(scene, ca, spp):
    return [render_sample(scene, ca, W, H, 0, s, spp, 3, 2) for s in range(spp)]


def test_film_checkpoint_resume_bit_identical(tmp_path):
    scene, cam = scenedefs.cornell_box(W, H, device="cpu")
    imgs = _samples(scene, cam.arrays("cpu"), 4)
    direct = Film(H, W, "cpu")
    for img in imgs:
        direct.accumulate(img)
    first = Film(H, W, "cpu")
    for img in imgs[:2]:
        first.accumulate(img)
    p = str(tmp_path / "ckpt.npz")
    ckpt.save_checkpoint(p, ckpt.render_state(first, frame=0))
    resumed = Film(H, W, "cpu")
    frame, same_scene = ckpt.restore_render_state(ckpt.load_checkpoint(p, "cpu"), resumed)
    assert frame == 0 and resumed.count == 2 and same_scene is None
    for img in imgs[2:]:
        resumed.accumulate(img)
    assert torch.equal(resumed.image(), direct.image())
    with pytest.raises(ValueError, match=r"\.npz"):
        ckpt.save_checkpoint(str(tmp_path / "dir_ckpt"), ckpt.render_state(first, 0))


def test_checkpoints_cross_packages(tmp_path):
    """The reference's 2-sample film resumed by the port and rendered to
    4 samples, within the golden bounds of the reference's own 4; and the
    port's file loaded by the reference, bitwise."""
    jscene, jcam = jcornell_box(W, H)
    jca = jcam.arrays()
    jimgs = [jrender_sample(jscene, jca, W, H, jnp.uint32(0), jnp.uint32(s), 4, 3, 2)
             for s in range(4)]
    jf = JFilm(H, W)
    for img in jimgs[:2]:
        jf.accumulate(img)
    p = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(p, jckpt.render_state(jf, frame=5))
    for img in jimgs[2:]:
        jf.accumulate(img)

    film = Film(H, W, "cpu")
    frame, _ = ckpt.restore_render_state(ckpt.load_checkpoint(p, "cpu"), film)
    assert frame == 5 and film.count == 2
    scene, cam = scenedefs.cornell_box(W, H, device="cpu")
    for img in _samples(scene, cam.arrays("cpu"), 4)[2:]:
        film.accumulate(img)
    err = np.abs(film.image().numpy() - np.asarray(jf.image()))
    assert err.max() < 5e-3 and err.mean() < 5e-4, (err.max(), err.mean())

    q = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(q, ckpt.render_state(film, frame=7))
    jf2 = JFilm(H, W)
    jframe, _ = jckpt.restore_render_state(jckpt.load_checkpoint(q), jf2)
    assert jframe == 7 and jf2.count == 4
    np.testing.assert_array_equal(np.asarray(jf2.image()), film.image().numpy())


def test_checkpoint_nested_scene_arrays(tmp_path):
    scene, _ = scenedefs.cornell_box(16, 16, device="cpu")
    f = Film(16, 16, "cpu")
    f.accumulate(torch.ones((16, 16, 3)))
    p = str(tmp_path / "full.npz")
    ckpt.save_checkpoint(p, ckpt.render_state(f, frame=3, scene=scene))
    st = ckpt.load_checkpoint(p, "cpu")
    assert int(st["frame"]) == 3 and "materials/base_color" not in st["scene_arrays"]
    trained = dict(st["scene_arrays"])
    trained["materials"] = dict(trained["materials"],
                                base_color=trained["materials"]["base_color"] * 0.5)
    st["scene_arrays"] = trained
    frame, scene2 = ckpt.restore_render_state(st, Film(16, 16, "cpu"), scene)
    assert frame == 3
    assert torch.equal(scene2["materials"]["base_color"], scene["materials"]["base_color"] * 0.5)
    # the tree and geometry are the same values, so nothing is rebuilt
    for k, v in scene.arrays.items():
        if torch.is_tensor(v):
            assert scene2[k] is not v and _bits(scene2[k]) == _bits(v), k
    assert scene2.static == scene.static


def _bits(x):
    return (x.dtype, tuple(x.shape), x.contiguous().numpy().tobytes())


def _sliver_scene(tris):
    b = SceneBuilder()
    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.5,) * 3)
    b.add_mesh(tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3), m)
    return b.build("cpu")


def _rays(tris, n=600, seed=3):
    """Rays from random points toward random triangles' centroids."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = tris[rng.integers(0, len(tris), n)].mean(axis=1) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro), torch.from_numpy(rd.astype(np.float32))


def test_replace_with_a_new_tree_drops_every_old_layout(reference_native):
    tris = _long_tri_scene(300, seed=2)
    scene = voxel.enable_voxel_lod(_sliver_scene(tris), lod_depth=4)
    scene = with_trl_layout(with_plk_layout(scene))
    assert any(k.startswith(("plk_", "trl_")) for k in scene.arrays) and scene["has_voxel_lod"]
    tree = build_sbvh(*_boxes(tris))
    assert tree["prim_order"].shape[0] > 300  # duplicated references
    new = scene.replace(**tree)
    for k in new.arrays:
        assert not k.startswith(("plk_", "trl_")) and k not in voxel.ARRAY_KEYS, k
    for k in KERNEL_STATICS + ("has_voxel_lod", "lod_bake_depth"):
        assert k not in new.static, k
    lay = bvh_layout.build_bvh_layout(tree, *(new[k].numpy() for k in (
        "tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")), new["num_tris"])
    for k in bvh_layout.ARRAY_KEYS:
        assert np.array_equal(new[k].numpy().view(np.int32), lay[k].view(np.int32)), k
    ro, rd = _rays(tris)
    dist = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 9, 600).astype(np.float32))
    for any_hit, t_max, t_min in ((False, None, 1e-4), (True, dist, 1e-3)):
        t0 = _t0_of(t_max, 600, "cpu")
        oracle = _traverse_plain(new, ro, rd, t0, any_hit, t_min)
        k1 = _traverse_plain(new, ro, rd, t0, any_hit, t_min, baked=True)
        for k in ("t", "prim", "u", "v", "steps"):
            assert torch.equal(oracle[k], k1[k]), (any_hit, k)
        assert int(oracle["hit"].sum()) > (100 if any_hit else 500)
    # the same values again change nothing; a new geometry relayouts
    assert new.replace(**tree).arrays.keys() == new.arrays.keys()
    moved = new.replace(tri_v0=new["tri_v0"] + 0.25)
    assert not torch.equal(moved["bvh_prims"], new["bvh_prims"])
    assert torch.equal(moved["nodes_bmin"], new["nodes_bmin"])


def test_replace_refuses_a_two_level_tree():
    scene, _ = scenedefs.instanced_mesh_scene(32, 32, n_u=20, n_v=8, device="cpu")
    tree = build_bvh(np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="two-level"):
        scene.replace(**tree)
    assert scene.replace(bg=torch.ones(3))["bg"].sum() == 3.0


def test_entry_matches_reference():
    fn, args = entry("cpu")
    assert args[0].device.type == "cpu"
    img = fn(*args).numpy()
    jfn, jargs = __graft_entry__.entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    assert img.shape == ref.shape == (64, 64, 3) and np.isfinite(img).all()
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3 and rel.mean() < 3e-3, ((rel > 2e-2).mean(), rel.mean())


def test_dryrun_multichip_two_ranks():
    dryrun_multichip(2)
