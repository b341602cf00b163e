"""aten_tpu_torch's binary FBX importer against aten_tpu's, on files
written here: the reference's own test reads an asset that is absent,
so `write_fbx` below writes the binary format (32-bit node records below
version 7500, 64-bit from it; arrays raw or zlib-deflated).

The file holds a mesh of quads, triangles and a pentagon with normals
(Direct) and UVs (IndexToDirect), both by polygon vertex or both by
control point, per-polygon materials; two LimbNodes with PreRotation,
rotation orders and a scale; a skin of two clusters with their
TransformLinks; and a take whose one curve turns the child joint.  Both
packages' parse_fbx, load_fbx_meshes, fbx_joint_names, load_fbx_clip
and load_fbx_skinned must agree on it."""
import struct
import zlib

import numpy as np
import pytest
import torch

from aten_tpu.io import fbx as jfbx
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.io import fbx
from aten_tpu_torch.ops import bvh_layout
from aten_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)

KTIME_PER_SEC = 46186158000
_ARRAY = {"d": "<f8", "f": "<f4", "i": "<i4", "l": "<i8", "b": "u1"}
_SCALAR = {"Y": "<h", "C": "<?", "I": "<i", "F": "<f", "D": "<d", "L": "<q"}


def _prop(code, value, compress):
    if code in _ARRAY:
        raw = np.asarray(value, _ARRAY[code]).tobytes()
        data = zlib.compress(raw) if compress else raw
        return (code.encode() + struct.pack("<III", len(value), int(compress), len(data))
                + data)
    if code in _SCALAR:
        return code.encode() + struct.pack(_SCALAR[code], value)
    data = value.encode() if code == "S" else value
    return code.encode() + struct.pack("<I", len(data)) + data


def _node(node, start, big, compress):
    """One node record at file offset `start`: (name, [(code, value)],
    [children])."""
    name, props, children = node
    pbytes = b"".join(_prop(c, v, compress) for c, v in props)
    head = (24 if big else 12) + 1 + len(name)
    kids = b""
    for child in children:
        kids += _node(child, start + head + len(pbytes) + len(kids), big, compress)
    if children:
        kids += b"\0" * (25 if big else 13)
    end = start + head + len(pbytes) + len(kids)
    fmt = "<QQQ" if big else "<III"
    return (struct.pack(fmt, end, len(props), len(pbytes)) + bytes([len(name)])
            + name.encode() + pbytes + kids)


def write_fbx(path, version, top, compress):
    big = version >= 7500
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", version)
    for node in top:
        out += _node(node, len(out), big, compress)
    out += b"\0" * (25 if big else 13)
    with open(path, "wb") as f:
        f.write(out)


def _p70(*entries):
    """A Properties70 block of (name, type, values) P records."""
    return ("Properties70", [], [
        ("P", [("S", n), ("S", t), ("S", ""), ("S", "A")] + list(vals), [])
        for n, t, vals in entries])


def _vec(name, xyz):
    return (name, name, [("D", float(v)) for v in xyz])


def _limb(uid, name, t, r, pre, order, s=(1.0, 1.0, 1.0)):
    return ("Model", [("L", uid), ("S", f"{name}\x00\x01Model"), ("S", "LimbNode")], [
        _p70(_vec("Lcl Translation", t), _vec("Lcl Rotation", r), _vec("PreRotation", pre),
             _vec("Lcl Scaling", s), ("RotationOrder", "enum", [("I", order)]))])


def _scene(mapping):
    """The Objects and Connections of the test file."""
    rng = np.random.default_rng(17)
    V = 9
    pos = np.stack(np.meshgrid(np.arange(3.0), np.arange(3.0), indexing="ij"), -1).reshape(-1, 2)
    pos = np.concatenate([pos, rng.uniform(-0.2, 0.2, (V, 1))], 1)  # [V, 3]
    polys = [[0, 1, 4, 3], [1, 2, 5], [4, 5, 2], [3, 4, 7, 8, 6]]
    pvi = []
    for poly in polys:
        pvi += poly[:-1] + [~poly[-1]]
    n_corner = len(pvi)
    rows = n_corner if mapping == "ByPolygonVertex" else V
    nml = rng.standard_normal((rows, 3))
    nml /= np.linalg.norm(nml, axis=1, keepdims=True)
    uv_table = rng.uniform(0, 1, (5, 2))
    uv_index = rng.integers(0, 5, rows)
    geom = ("Geometry", [("L", 100), ("S", "knot\x00\x01Geometry"), ("S", "Mesh")], [
        ("Vertices", [("d", pos.reshape(-1))], []),
        ("PolygonVertexIndex", [("i", pvi)], []),
        ("LayerElementNormal", [("I", 0)], [
            ("MappingInformationType", [("S", mapping)], []),
            ("ReferenceInformationType", [("S", "Direct")], []),
            ("Normals", [("d", nml.reshape(-1))], [])]),
        ("LayerElementUV", [("I", 0)], [
            ("MappingInformationType", [("S", mapping)], []),
            ("ReferenceInformationType", [("S", "IndexToDirect")], []),
            ("UV", [("d", uv_table.reshape(-1))], []),
            ("UVIndex", [("i", uv_index)], [])]),
        ("LayerElementMaterial", [("I", 0)], [
            ("MappingInformationType", [("S", "ByPolygon")], []),
            ("Materials", [("i", [0, 1, 1, 0])], [])]),
    ])
    w1 = np.clip(pos[:, 0] / 2.0, 0.0, 1.0)
    link = [np.eye(4), np.eye(4)]
    link[0][3, :3] = (0.0, 1.0, 0.0)  # column-major: the translation row
    link[1][3, :3] = (0.1, 2.0, -0.2)
    link[1][:3, :3] = [[0.8, 0.6, 0.0], [-0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]
    clusters = [
        ("Deformer", [("L", 300 + k), ("S", f"c{k}\x00\x01SubDeformer"), ("S", "Cluster")], [
            ("Indexes", [("i", np.arange(V))], []),
            ("Weights", [("d", w if k else 1.0 - w)], []),
            ("TransformLink", [("d", link[k].reshape(-1))], [])])
        for k, w in ((0, w1), (1, w1))]
    keys = np.array([0, KTIME_PER_SEC // 2, KTIME_PER_SEC], np.int64) + KTIME_PER_SEC // 4
    objects = ("Objects", [], [
        geom,
        ("Model", [("L", 101), ("S", "knot\x00\x01Model"), ("S", "Mesh")], []),
        _limb(200, "Hips", (0.0, 1.0, 0.0), (10.0, 20.0, 30.0), (-90.0, 0.0, 0.0), 0),
        _limb(201, "Spine", (0.0, 1.0, 0.0), (0.0, 0.0, 15.0), (0.0, 5.0, 0.0), 2,
              s=(1.0, 1.2, 1.0)),
        ("Deformer", [("L", 299), ("S", "skin\x00\x01Deformer"), ("S", "Skin")], []),
        *clusters,
        ("AnimationStack", [("L", 400), ("S", "Take\x00\x01AnimStack"), ("S", "")], []),
        ("AnimationLayer", [("L", 401), ("S", "Base\x00\x01AnimLayer"), ("S", "")], []),
        ("AnimationCurveNode", [("L", 402), ("S", "R\x00\x01AnimCurveNode"), ("S", "")], []),
        ("AnimationCurve", [("L", 403), ("S", "\x00\x01AnimCurve"), ("S", "")], [
            ("KeyTime", [("l", keys)], []),
            ("KeyValueFloat", [("f", np.array([15.0, 40.0, 75.0], np.float32))], [])]),
    ])

    def c(child, parent, prop=None):
        props = [("S", "OP" if prop else "OO"), ("L", child), ("L", parent)]
        return ("C", props + ([("S", prop)] if prop else []), [])

    conns = ("Connections", [], [
        c(101, 0), c(100, 101), c(299, 100), c(300, 299), c(301, 299), c(200, 300),
        c(201, 301), c(200, 0), c(201, 200), c(401, 400), c(402, 401),
        c(402, 201, "Lcl Rotation"), c(403, 402, "d|Z")])
    return [("FBXHeaderExtension", [], [("FBXVersion", [("I", 7400)], [])]), objects, conns]


def _same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, where


def _trees_equal(a, b, where="root"):
    assert a.name == b.name and len(a.props) == len(b.props), where
    for i, (p, q) in enumerate(zip(a.props, b.props)):
        _same(p, q, f"{where}.{a.name}[{i}]")
    assert len(a.children) == len(b.children), where
    for x, y in zip(a.children, b.children):
        _trees_equal(x, y, f"{where}/{x.name}")


@pytest.mark.parametrize("mapping", ["ByPolygonVertex", "ByControlPoint"])
@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_matches_reference(tmp_path, version, compress, mapping):
    path = str(tmp_path / "rig.fbx")
    write_fbx(path, version, _scene(mapping), compress)

    root = fbx.parse_fbx(path)
    assert root.props == [version]
    assert [n.name for n in root.children] == ["FBXHeaderExtension", "Objects", "Connections"]
    _trees_equal(root, jfbx.parse_fbx(path))

    meshes, ref_meshes = fbx.load_fbx_meshes(path), jfbx.load_fbx_meshes(path)
    assert len(meshes) == len(ref_meshes) == 1
    for k, v in meshes[0].items():
        _same(v, ref_meshes[0][k], k)
    m = meshes[0]
    assert m["name"] == "knot" and m["faces"].shape == (2 + 1 + 1 + 3, 3)
    # one row a polygon corner, in both mappings
    assert m["normals_corner"].shape == (15, 3) and m["uvs_corner"].shape == (15, 2)
    np.testing.assert_array_equal(m["mat_tri"], [0, 0, 1, 1, 0, 0, 0])

    names = fbx.fbx_joint_names(path)
    assert names == jfbx.fbx_joint_names(path) == ["Hips", "Spine"]
    for kw in ({}, {"joint_names": ["Spine", "Nobody", "Hips"]}):
        clip, ref_clip = fbx.load_fbx_clip(path, **kw), jfbx.load_fbx_clip(path, **kw)
        for f in ("times", "trans", "rot", "scale"):
            _same(getattr(clip, f), getattr(ref_clip, f), f)
    clip = fbx.load_fbx_clip(path)
    np.testing.assert_allclose(clip.times[1], [0.0, 0.5, 1.0])  # the take starts at 0
    assert clip.times.shape == (2, 3) and clip.duration == 1.0

    b, jb = SceneBuilder(), JaxSceneBuilder()
    dm, skel, clips, inv_bind = fbx.load_fbx_skinned(b, path)
    jdm, jskel, jclips, jinv = jfbx.load_fbx_skinned(jb, path)
    assert clips == jclips == []
    _same(inv_bind, jinv, "inv_bind")
    assert skel.parents == jskel.parents == (-1, 0)
    for f in ("bind_t", "bind_q", "bind_s"):
        _same(getattr(skel, f), np.asarray(getattr(jskel, f)), f)
    assert dm.tri_start == jdm.tri_start
    for f in ("faces", "bind_pos", "weights", "joints"):
        _same(getattr(dm, f), np.asarray(getattr(jdm, f)), f)
    # normals from the faces: a scatter-add in both, summed in another order
    np.testing.assert_allclose(dm.bind_nml, np.asarray(jdm.bind_nml), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dm.weights.sum(1), 1.0, atol=1e-6)
    port, ref = b.build("cpu"), jb.build()
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_mtl", "nodes_hit", "prim_order"):
        _same(port[k].numpy(), np.asarray(ref[k]), k)
    assert all(k in port for k in bvh_layout.ARRAY_KEYS)


def test_fbx_rejects_other_files(tmp_path):
    p = tmp_path / "ascii.fbx"
    p.write_text("; FBX 7.4.0 project file\n")
    with pytest.raises(ValueError, match="not a binary FBX file"):
        fbx.parse_fbx(str(p))
    q = str(tmp_path / "empty.fbx")
    write_fbx(q, 7400, [("Objects", [], [])], False)
    assert fbx.load_fbx_meshes(q) == []
    with pytest.raises(ValueError, match="no mesh geometry"):
        fbx.load_fbx_skinned(SceneBuilder(), q)
