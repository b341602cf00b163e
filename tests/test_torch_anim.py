"""aten_tpu_torch's skeleton FK, keyframe clips, LBS skinning and the
deformable containers against aten_tpu's: the six cases of
tests/test_anim.py on the same inputs, held to rtol 1e-6 (atol 1e-6 for
values near 0); the .npz container round trip across both packages; and
`load_gltf_skinned` of tests/test_anim_formats.py.  Also the port's own
guarantees for a posed scene: an area light on the deformed triangles
gets its area and CDF anew, and instanced scenes are refused."""
import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.anim import animation as janim
from aten_tpu.anim import formats as jformats
from aten_tpu.anim import skeleton as jskel
from aten_tpu.anim import skinning as jskin
from aten_tpu.accel.traverse import traverse as jtraverse
from aten_tpu.scene.materials import MaterialType as JMT
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel.traverse import traverse
from aten_tpu_torch.anim import formats
from aten_tpu_torch.anim import skeleton as tskel
from aten_tpu_torch.anim.animation import AnimationClip, slerp
from aten_tpu_torch.anim.skeleton import (
    Skeleton, global_matrices, quat_to_mat, skinning_palette, trs_to_mat)
from aten_tpu_torch.anim.skinning import (
    DeformableMesh, apply_pose, skin_vertices, vertex_normals)
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)

IDQ = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
TOL = {"rtol": 1e-6, "atol": 1e-6}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.numpy() if torch.is_tensor(port) else port,
                               np.asarray(ref), **{**TOL, **kw})


def _quat_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float32)
    axis /= np.linalg.norm(axis)
    s = np.sin(angle / 2)
    return np.array([*(axis * s), np.cos(angle / 2)], np.float32)


def _two_bone(mod):
    """Root at the origin, child offset +1x."""
    return mod.Skeleton(
        parents=(-1, 0),
        bind_t=np.array([[0, 0, 0], [1, 0, 0]], np.float32),
        bind_q=np.stack([IDQ, IDQ]),
        bind_s=np.ones((2, 3), np.float32),
    )


def _rig(seed=0, J=7):
    """A seeded tree of J joints (several per level) in a random pose."""
    rng = np.random.default_rng(seed)
    parents = (-1, 0, 0, 1, 1, 2, 4)[:J]
    t = rng.uniform(-1, 1, (J, 3)).astype(np.float32)
    q = rng.standard_normal((J, 4)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (J, 3)).astype(np.float32)
    bt = rng.uniform(-1, 1, (J, 3)).astype(np.float32)
    bq = rng.standard_normal((J, 4)).astype(np.float32)
    bq /= np.linalg.norm(bq, axis=1, keepdims=True)
    bs = rng.uniform(0.8, 1.2, (J, 3)).astype(np.float32)
    return parents, (t, q, s), (bt, bq, bs)


def test_fk_two_bone_rotation_matches_reference():
    q = np.stack([_quat_axis_angle([0, 0, 1], np.pi / 2), IDQ])
    skel, jsk = _two_bone(tskel), _two_bone(jskel)
    g = global_matrices(skel, _t(skel.bind_t), _t(q), _t(skel.bind_s))
    jg = jskel.global_matrices(jsk, jnp.asarray(jsk.bind_t), jnp.asarray(q),
                               jnp.asarray(jsk.bind_s))
    _close(g, jg)
    np.testing.assert_allclose(g[1, :3, 3].numpy(), [0, 1, 0], atol=1e-6)
    # a seeded rig of three levels, with scales: FK, quat_to_mat, trs_to_mat
    parents, (t, q, s), _ = _rig()
    rig = Skeleton(parents, t, q, s)
    jrig = jskel.Skeleton(parents, t, q, s)
    _close(global_matrices(rig, _t(t), _t(q), _t(s)),
           jskel.global_matrices(jrig, jnp.asarray(t), jnp.asarray(q), jnp.asarray(s)))
    _close(quat_to_mat(_t(q)), jskel.quat_to_mat(jnp.asarray(q)))
    _close(trs_to_mat(_t(t), _t(q), _t(s)),
           jskel.trs_to_mat(jnp.asarray(t), jnp.asarray(q), jnp.asarray(s)))
    assert [lv.tolist() for lv in rig.levels()] == [lv.tolist() for lv in jrig.levels()]


def test_inverse_bind_identity_palette_matches_reference():
    parents, (t, q, s), (bt, bq, bs) = _rig(1)
    rig, jrig = Skeleton(parents, bt, bq, bs), jskel.Skeleton(parents, bt, bq, bs)
    inv, jinv = rig.inverse_bind(), jrig.inverse_bind()
    assert inv.dtype == np.float32
    _close(inv, jinv)
    pal = skinning_palette(rig, _t(bt), _t(bq), _t(bs), _t(jinv))
    jpal = jskel.skinning_palette(jrig, jnp.asarray(bt), jnp.asarray(bq), jnp.asarray(bs),
                                  jnp.asarray(jinv))
    _close(pal, jpal)
    expect = np.tile(np.eye(4, dtype=np.float32)[:3, :4], (len(parents), 1, 1))
    np.testing.assert_allclose(pal.numpy(), expect, atol=1e-5)
    # a posed palette
    _close(skinning_palette(rig, _t(t), _t(q), _t(s), _t(jinv)),
           jskel.skinning_palette(jrig, jnp.asarray(t), jnp.asarray(q), jnp.asarray(s),
                                  jnp.asarray(jinv)))
    sk = _two_bone(tskel)
    pal2 = skinning_palette(sk, _t(sk.bind_t), _t(sk.bind_q), _t(sk.bind_s), sk.inverse_bind())
    np.testing.assert_allclose(pal2.numpy(), np.tile(np.eye(4)[:3, :4], (2, 1, 1)), atol=1e-6)


def test_lbs_matches_reference():
    pal = np.stack([np.hstack([np.eye(3), [[0], [0], [0]]]),
                    np.hstack([np.eye(3), [[2], [0], [0]]])]).astype(np.float32)
    p, n = skin_vertices(_t(pal), _t([[0.0, 1.0, 0.0]]), _t([[0.0, 0.0, 1.0]]),
                         _t([[0.5, 0.5, 0.0, 0.0]]), _t(np.array([[0, 1, 0, 0]], np.int32)))
    np.testing.assert_allclose(p.numpy(), [[1.0, 1.0, 0.0]], atol=1e-6)
    np.testing.assert_allclose(n.numpy(), [[0.0, 0.0, 1.0]], atol=1e-6)
    # seeded palettes, vertices, weights and joints
    rng = np.random.default_rng(3)
    J, V = 5, 200
    pal = rng.uniform(-1, 1, (J, 3, 4)).astype(np.float32)
    pos = rng.uniform(-2, 2, (V, 3)).astype(np.float32)
    nml = rng.standard_normal((V, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (V, 4)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    j = rng.integers(0, J, (V, 4)).astype(np.int32)
    got = skin_vertices(_t(pal), _t(pos), _t(nml), _t(w), _t(j))
    ref = jskin.skin_vertices(*(jnp.asarray(a) for a in (pal, pos, nml, w, j)))
    for a, b in zip(got, ref):
        _close(a, b)


def test_clip_sampling_matches_reference():
    q90 = _quat_axis_angle([0, 0, 1], np.pi / 2)
    tracks = [{"times": np.array([0.0, 1.0], np.float32),
               "trans": np.array([[0, 0, 0], [2, 0, 0]], np.float32),
               "rot": np.stack([IDQ, q90]), "scale": np.ones((2, 3), np.float32)},
              {"times": np.array([0.0, 0.25, 0.5, 2.0], np.float32),
               "trans": np.arange(12, dtype=np.float32).reshape(4, 3),
               "rot": np.stack([IDQ, q90, -q90, _quat_axis_angle([1, 1, 0], 2.0)]),
               "scale": np.linspace(0.5, 2, 12, dtype=np.float32).reshape(4, 3)},
              {"times": np.array([0.3], np.float32), "trans": np.ones((1, 3), np.float32),
               "rot": IDQ[None], "scale": np.ones((1, 3), np.float32)}]
    clip, jclip = AnimationClip.from_tracks(tracks), janim.AnimationClip.from_tracks(tracks)
    for f in ("times", "trans", "rot", "scale"):
        np.testing.assert_array_equal(getattr(clip, f), getattr(jclip, f))
    assert clip.duration == jclip.duration == 2.0
    for tt in (-1.0, 0.0, 0.1, 0.25, 0.3, 0.5, 0.77, 1.0, 1.9, 2.0, 5.0):
        for a, b in zip(clip.sample(tt), jclip.sample(tt)):
            _close(a, b)
        for a, b in zip(clip.sample(torch.tensor(tt)), jclip.sample(tt)):
            _close(a, b)
    tr, q, sc = clip.sample(0.5)
    np.testing.assert_allclose(tr[0].numpy(), [1.0, 0.0, 0.0], atol=1e-6)
    m = quat_to_mat(q).numpy()[0]
    np.testing.assert_allclose(m[0, 0], np.cos(np.pi / 4), atol=1e-5)
    np.testing.assert_allclose(clip.sample(5.0)[0][0].numpy(), [2.0, 0.0, 0.0], atol=1e-5)
    # slerp on seeded quaternions, both arcs and the lerp fallback
    rng = np.random.default_rng(4)
    q0 = rng.standard_normal((64, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q1 = rng.standard_normal((64, 4)).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q1[:4] = q0[:4]
    u = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    _close(slerp(_t(q0), _t(q1), _t(u)), janim.slerp(*(jnp.asarray(a) for a in (q0, q1, u))))


def _filler(b, m):
    """519 static triangles away from the quad: the scene leaves the dense
    test (> 512 prims)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, -10, (520, 3)).astype(np.float32)
    b.add_mesh(pts[:519], np.arange(519).reshape(-1, 3), m)


def _skinned_quad(cls, mt, dm_cls):
    sb = cls()
    m = sb.add_material(mt.DIFFUSE, base_color=(0.6, 0.6, 0.6))
    _filler(sb, m)
    V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    W = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (4, 1))
    J = np.zeros((4, 4), np.int32)
    return sb, dm_cls.attach(sb, V, F, m, W, J)


def test_skinned_scene_update_and_traversal_match_reference():
    """Attach a deformable quad, pose it +5x by a single joint: rays hit it
    at its new place after the rebuild, as in the reference."""
    sb, dm = _skinned_quad(SceneBuilder, MaterialType, DeformableMesh)
    jsb, jdm = _skinned_quad(JaxSceneBuilder, JMT, jskin.DeformableMesh)
    for f in ("faces", "bind_pos", "bind_nml", "weights", "joints"):
        np.testing.assert_array_equal(getattr(dm, f), np.asarray(getattr(jdm, f)), err_msg=f)
    assert dm.tri_start == jdm.tri_start == 173
    scene = sb.build("cpu")
    jscene = jsb.build().drop("pl_nodes", "pl_prims", "pl_meta")
    rest = np.eye(4, dtype=np.float32)[:3, :4][None]
    moved = np.hstack([np.eye(3), [[5.0], [0], [0]]]).astype(np.float32)[None]
    ro = np.array([[0.5, 0.5, 3.0], [5.5, 0.5, 3.0]], np.float32)
    rd = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    step = jax.jit(lambda s, pal: jskin.apply_pose(s, jdm, pal))
    for pal, hits in ((rest, [True, False]), (moved, [False, True])):
        s = apply_pose(scene, dm, _t(pal))
        js = step(jscene, jnp.asarray(pal))
        for k in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2", "tri_area"):
            _close(s[k], js[k], err_msg=k)
        h = traverse(s, _t(ro), _t(rd))
        jh = jtraverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax")
        assert h["hit"].tolist() == hits == np.asarray(jh["hit"]).tolist()
        np.testing.assert_array_equal(h["prim"].numpy(), np.asarray(jh["prim"]))
        _close(h["t"], jh["t"])
    np.testing.assert_allclose(float(h["t"][1]), 3.0, atol=1e-4)
    # without the rebuild: the triangles move, every kernel layout goes
    s = apply_pose(scene, dm, _t(moved), rebuild=False)
    assert not any(k.startswith(("bvh_", "plk_", "trl_")) for k in s.arrays)
    assert torch.equal(s["nodes_hit"], scene["nodes_hit"])


def test_vertex_normals_match_reference():
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = vertex_normals(_t(pos), _t(faces)).numpy()
    np.testing.assert_allclose(n, np.tile([[0, 0, 1]], (4, 1)), atol=1e-6)
    rng = np.random.default_rng(9)
    pos = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (150, 3)).astype(np.int32)
    _close(vertex_normals(_t(pos), _t(faces)),
           jskin.vertex_normals(jnp.asarray(pos), jnp.asarray(faces)))


def test_npz_container_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(12)
    mesh = DeformableMesh(
        tri_start=3, faces=np.array([[0, 1, 2], [1, 2, 3]]),
        bind_pos=rng.uniform(-1, 1, (4, 3)).astype(np.float32),
        bind_nml=np.tile([[0, 0, 1]], (4, 1)).astype(np.float32),
        weights=np.tile([[1, 0, 0, 0]], (4, 1)).astype(np.float32),
        joints=np.zeros((4, 4), np.int32))
    parents, _, (bt, bq, bs) = _rig(2, J=3)
    skel = Skeleton(parents, bt, bq, bs)
    clip = AnimationClip.from_tracks([
        {"times": np.array([0.0, 1.0], np.float32), "trans": np.zeros((2, 3), np.float32),
         "rot": np.stack([IDQ, IDQ]), "scale": np.ones((2, 3), np.float32)}
        for _ in range(3)])
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    formats.save_deformable(p, mesh, skel, clips=[clip, clip], inv_bind=skel.inverse_bind())
    jmesh = jskin.DeformableMesh(**{f: getattr(mesh, f) for f in (
        "tri_start", "faces", "bind_pos", "bind_nml", "weights", "joints")})
    jformats.save_deformable(q, jmesh, jskel.Skeleton(parents, bt, bq, bs), clips=[clip, clip],
                             inv_bind=skel.inverse_bind())
    for path in (p, q):  # each package reads the other's file
        got, jgot = formats.load_deformable(path), jformats.load_deformable(path)
        (m2, s2, clips2, ib), (jm2, js2, jclips2, jib) = got, jgot
        assert m2.tri_start == jm2.tri_start == 3
        for f in ("faces", "bind_pos", "bind_nml", "weights", "joints"):
            np.testing.assert_array_equal(getattr(m2, f), getattr(jm2, f))
            np.testing.assert_array_equal(getattr(m2, f), getattr(mesh, f))
        assert s2.parents == js2.parents == parents
        for f in ("bind_t", "bind_q", "bind_s"):
            np.testing.assert_array_equal(getattr(s2, f), getattr(js2, f))
        assert len(clips2) == len(jclips2) == 2
        for f in ("times", "trans", "rot", "scale"):
            np.testing.assert_array_equal(getattr(clips2[1], f), getattr(jclips2[1], f))
        np.testing.assert_array_equal(ib, jib)
    assert formats.load_deformable(str(tmp_path / "port.npz"))[3].shape == (3, 4, 4)
    formats.save_deformable(p, mesh, skel)
    assert formats.load_deformable(p)[2:] == ([], None)


def _skinned_gltf(tmp_path):
    """A column of 6 vertices; joint 1 at y = 1 turns in an animation
    (tests/test_anim_formats.py's file)."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 2, 0], [1, 2, 0]],
                   np.float32)
    w1 = np.clip(pos[:, 1] - 0.5, 0, 1)
    weights = np.stack([1 - w1, w1, np.zeros_like(w1), np.zeros_like(w1)], 1)
    # the skin lists the child joint first: skin joint 0 is node 2 (at
    # y = 1), joint 1 the root node 1, which the import reorders
    joints = np.zeros((6, 4), np.uint16)
    joints[:, 0] = 1
    idx = np.array([0, 1, 2, 1, 3, 2, 2, 3, 4, 3, 5, 4], np.uint16)
    ibm = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    ibm[0, 3, 1] = -1.0  # column-major: the inverse bind of y = +1
    times = np.array([0.0, 1.0], np.float32)
    rots = np.array([[0, 0, 0, 1], [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], np.float32)
    parts = [pos, weights.astype(np.float32), joints, idx, ibm, times, rots]
    offs = np.cumsum([0] + [a.nbytes for a in parts])
    buf = b"".join(a.tobytes() for a in parts)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0, "skin": 0},
                  {"children": [2], "translation": [0, 0, 0]},
                  {"translation": [0, 1, 0]}],
        "skins": [{"joints": [2, 1], "inverseBindMatrices": 4}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "WEIGHTS_0": 1,
                                                   "JOINTS_0": 2}, "indices": 3}]}],
        "animations": [{
            "channels": [{"sampler": 0, "target": {"node": 2, "path": "rotation"}},
                         {"sampler": 1, "target": {"node": 1, "path": "translation"}}],
            "samplers": [{"input": 5, "output": 6, "interpolation": "LINEAR"},
                         {"input": 7, "output": 8, "interpolation": "LINEAR"}],
        }],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 6, "type": "VEC4"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "VEC4"},
            {"bufferView": 3, "componentType": 5123, "count": 12, "type": "SCALAR"},
            {"bufferView": 4, "componentType": 5126, "count": 2, "type": "MAT4"},
            {"bufferView": 5, "componentType": 5126, "count": 2, "type": "SCALAR"},
            {"bufferView": 6, "componentType": 5126, "count": 2, "type": "VEC4"},
            {"bufferView": 5, "componentType": 5126, "count": 1, "type": "SCALAR"},
            {"bufferView": 0, "componentType": 5126, "count": 1, "type": "VEC3"},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": int(offs[i]),
                         "byteLength": int(parts[i].nbytes)} for i in range(7)],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
    }
    p = tmp_path / "skinned.gltf"
    p.write_text(json.dumps(doc))
    return str(p)


def test_gltf_skinned_import_matches_reference(tmp_path):
    path = _skinned_gltf(tmp_path)
    sb, jsb = SceneBuilder(), JaxSceneBuilder()
    mesh, skel, clips, inv_bind = formats.load_gltf_skinned(sb, path)
    jmesh, jsk, jclips, jinv = jformats.load_gltf_skinned(jsb, path)
    assert skel.num_joints == 2 and skel.parents == jsk.parents == (-1, 0)
    np.testing.assert_array_equal(inv_bind, jinv)
    for f in ("bind_t", "bind_q", "bind_s"):
        np.testing.assert_array_equal(getattr(skel, f), getattr(jsk, f))
    assert mesh.tri_start == jmesh.tri_start
    for f in ("faces", "bind_pos", "weights", "joints"):
        np.testing.assert_array_equal(getattr(mesh, f), np.asarray(getattr(jmesh, f)), err_msg=f)
    _close(mesh.bind_nml, jmesh.bind_nml)
    assert len(clips) == len(jclips) == 1
    for f in ("times", "trans", "rot", "scale"):
        np.testing.assert_array_equal(getattr(clips[0], f), getattr(jclips[0], f))
    # bind pose -> identity palette -> the bind positions
    pal = skinning_palette(skel, _t(skel.bind_t), _t(skel.bind_q), _t(skel.bind_s), _t(inv_bind))
    p0, _ = skin_vertices(pal, _t(mesh.bind_pos), _t(mesh.bind_nml), _t(mesh.weights),
                          _t(mesh.joints))
    np.testing.assert_allclose(p0.numpy(), mesh.bind_pos, atol=1e-5)
    # the animated pose: the clip through FK and LBS in both packages
    for tt in (0.5, 1.0):
        tr, q, s = clips[0].sample(tt)
        jtr, jq, js = jclips[0].sample(tt)
        pal1 = skinning_palette(skel, tr, q, s, _t(inv_bind))
        jpal1 = jskel.skinning_palette(jsk, jtr, jq, js, jnp.asarray(jinv))
        _close(pal1, jpal1)
        p1, _ = skin_vertices(pal1, _t(mesh.bind_pos), _t(mesh.bind_nml), _t(mesh.weights),
                              _t(mesh.joints))
        jp1, _ = jskin.skin_vertices(jpal1, jnp.asarray(jmesh.bind_pos),
                                     jnp.asarray(jmesh.bind_nml), jnp.asarray(jmesh.weights),
                                     jnp.asarray(jmesh.joints))
        _close(p1, jp1)
    # vertex 4 = (0,2,0), fully the y = 1 joint: turned 90 degrees about (0,1,0)
    np.testing.assert_allclose(p1.numpy()[4], [-1.0, 1.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(p1.numpy()[0], [0.0, 0.0, 0.0], atol=1e-5)
    _close(sb.build("cpu")["tri_v0"], jsb.build()["tri_v0"], rtol=0, atol=0)


def test_pose_refreshes_an_area_light_on_the_mesh():
    """The port refreshes what the reference leaves stale: an emitter on
    the skinned triangles gets the posed area and triangle CDF."""
    sb = SceneBuilder()
    m = sb.add_material(MaterialType.EMISSIVE, base_color=(4.0, 4.0, 4.0))
    _filler(sb, sb.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5)))
    V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    dm = DeformableMesh.attach(sb, V, [[0, 1, 2], [0, 2, 3]], m,
                               np.tile([[1.0, 0, 0, 0]], (4, 1)), np.zeros((4, 4)))
    sb.add_area_light_tris(dm.tri_start, 2, le=(4.0, 4.0, 4.0))
    ls, lc = sb.add_quad([5, 5, 5], [6, 5, 5], [6, 6, 5], [5, 6, 5], m)
    sb.add_area_light_tris(ls, lc, le=(1.0, 1.0, 1.0))
    scene = sb.build("cpu")
    pal = np.zeros((1, 3, 4), np.float32)
    pal[0, :3, :3] = np.diag([2.0, 3.0, 1.0])  # stretch: area 1 -> 6
    posed = apply_pose(scene, dm, _t(pal))
    np.testing.assert_allclose(posed["lights"]["area"].numpy(), [6.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(posed["lights"]["tri_cdf"][0].numpy(), [0.5, 1.0], rtol=1e-6)
    np.testing.assert_array_equal(posed["lights"]["tri_cdf"][1].numpy(),
                                  scene["lights"]["tri_cdf"][1].numpy())
    np.testing.assert_allclose(posed["tri_area"][dm.tri_start:dm.tri_start + 2].numpy(), 3.0)


def test_pose_refuses_instanced_scenes():
    sb = SceneBuilder()
    m = sb.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    dm = DeformableMesh.attach(sb, [[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]], m,
                               [[1.0, 0, 0, 0]] * 3, np.zeros((3, 4)))
    o = sb.create_object()
    sb.add_sphere((0, 0, 0), 1.0, m, obj=o)
    sb.add_instance(o, np.eye(4))
    with pytest.raises(ValueError, match="instances"):
        apply_pose(sb.build("cpu"), dm, torch.zeros(1, 3, 4))
