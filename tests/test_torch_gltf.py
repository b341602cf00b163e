"""aten_tpu_torch's glTF 2.0 importer against aten_tpu's: the embedded,
.glb and instanced cases of tests/test_gltf.py, and a file with every
node transform (TRS, matrix, hierarchy, scene scale), UVs, an external
buffer, a base-colour texture and the material kinds.  Both packages load
the same file; the scenes they build (on the CPU) hold the same tables,
bit for bit, but for the port's own kernel records."""
import base64
import json
import struct

import numpy as np
import pytest
import torch

from aten_tpu.io.gltf import load_gltf as jload_gltf
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel.traverse import traverse
from aten_tpu_torch.io.gltf import load_gltf
from aten_tpu_torch.io.image import save_image
from aten_tpu_torch.ops import bvh_layout, tlas_layout
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)

# the port's kernel records, which the reference does not have
PORT_ONLY = bvh_layout.ARRAY_KEYS + tlas_layout.ARRAY_KEYS


def _tables_equal(ref, port, prefix=""):
    for k, v in port.items():
        if k in PORT_ONLY:
            continue
        if isinstance(v, dict):
            _tables_equal(ref[k], v, prefix + k + ".")
            continue
        r = np.asarray(ref[k])
        assert v.numpy().dtype == r.dtype, prefix + k
        np.testing.assert_array_equal(v.numpy(), r, err_msg=prefix + k)


def _load_both(path, **kw):
    """(port scene, reference scene, port builder, the loaders' returns)."""
    b, jb = SceneBuilder(), JaxSceneBuilder()
    out = load_gltf(b, path, **kw)
    assert out == jload_gltf(jb, path, **kw)
    port, ref = b.build("cpu"), jb.build()
    _tables_equal(ref.arrays, port.arrays)
    for k, v in port.static.items():
        assert ref.static[k] == v, k
    return port, ref, b, out


def _quad_gltf_doc():
    """Unit quad in the xy plane, indexed, with a translated node."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nml = np.tile([[0, 0, 1]], (4, 1)).astype(np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + nml.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [2.0, 0.0, 0.0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.8, 1.0],
                                                "metallicFactor": 0.0,
                                                "roughnessFactor": 0.5}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 12},
        ],
        "buffers": [{"byteLength": len(buf)}],
    }
    return doc, buf


def _embed(doc, buf):
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(buf).decode())


def test_gltf_embedded_base64_matches_reference(tmp_path):
    doc, buf = _quad_gltf_doc()
    _embed(doc, buf)
    p = tmp_path / "quad.gltf"
    p.write_text(json.dumps(doc))
    scene, _, b, prims = _load_both(str(p))
    assert prims == [(0, 2)]
    assert scene["num_tris"] == 2
    assert scene["tri_v0"][:, 0].min() >= 2.0 - 1e-5  # the node's translation baked
    rows = b.materials.rows
    assert rows[0]["type"] == int(MaterialType.DISNEY)
    np.testing.assert_allclose(rows[0]["base_color"], (0.2, 0.4, 0.8))
    assert rows[0]["roughness"] == 0.5


def glb_bytes(doc, buf):
    """A GLB container of the JSON `doc` and the binary chunk `buf`."""
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    bin_chunk = buf + b"\0" * (-len(buf) % 4)
    return (struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_chunk))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)


def test_glb_container_matches_reference(tmp_path):
    doc, buf = _quad_gltf_doc()
    p = tmp_path / "quad.glb"
    p.write_bytes(glb_bytes(doc, buf))
    scene, _, _, prims = _load_both(str(p))
    assert prims == [(0, 2)]
    assert scene["num_tris"] == 2


def test_gltf_instanced_shared_mesh_matches_reference(tmp_path):
    doc, buf = _quad_gltf_doc()
    _embed(doc, buf)
    doc["nodes"] = [{"mesh": 0, "translation": [0.0, 0.0, 0.0]},
                    {"mesh": 0, "translation": [5.0, 0.0, 0.0]}]
    doc["scenes"] = [{"nodes": [0, 1]}]
    p = tmp_path / "two.gltf"
    p.write_text(json.dumps(doc))
    scene, ref, _, _ = _load_both(str(p), instanced=True)
    assert scene["num_instances"] == 2
    assert scene["num_tris"] == 2  # the mesh stored once
    assert all(k in scene for k in tlas_layout.ARRAY_KEYS)
    ro = torch.tensor([[0.5, 0.5, 3.0], [5.5, 0.5, 3.0], [8.0, 0.5, 3.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    h = traverse(scene, ro, rd)
    assert h["hit"].tolist() == [True, True, False]
    assert h["inst"][:2].tolist() == [0, 1]
    np.testing.assert_allclose(h["t"][:2].numpy(), 3.0, atol=1e-5)


def _rich_doc(tmp_path):
    """Two meshes (one unindexed, with UVs), five nodes: TRS with a
    rotation and a non-uniform scale, a matrix, a child of a rotated
    parent, a second instance of the first mesh; an external buffer; a
    textured, an emissive and a default material."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    nml = rng.standard_normal((12, 3)).astype(np.float32)
    nml /= np.linalg.norm(nml, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (12, 2)).astype(np.float32)
    idx = rng.integers(0, 12, 18).astype(np.uint32)
    tri = rng.uniform(-1, 1, (9, 3)).astype(np.float32)  # unindexed: 3 triangles
    parts = [pos, nml, uv, idx, tri]
    offs = np.cumsum([0] + [a.nbytes for a in parts])
    buf = b"".join(a.tobytes() for a in parts)
    (tmp_path / "mesh.bin").write_bytes(buf)
    save_image(str(tmp_path / "base.png"), rng.uniform(0, 1, (4, 4, 3)).astype(np.float32))
    q = np.array([0.1, 0.7, -0.2, 0.6], np.float64)
    q /= np.linalg.norm(q)
    mat = np.eye(4)
    mat[:3, :3] = [[0.0, -1.5, 0.0], [1.5, 0.0, 0.0], [0.0, 0.0, 1.5]]
    mat[:3, 3] = [0.5, -1.0, 2.0]
    views = [{"buffer": 0, "byteOffset": int(offs[i]), "byteLength": int(parts[i].nbytes)}
             for i in range(5)]
    return {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [
            {"mesh": 0, "translation": [1.0, 2.0, -0.5], "rotation": q.tolist(),
             "scale": [1.0, 2.0, 0.5]},
            {"mesh": 1, "matrix": mat.T.reshape(-1).tolist()},
            {"rotation": [0.0, 0.0, 0.3826834, 0.9238795], "children": [3, 4]},
            {"mesh": 0, "translation": [3.0, 0.0, 0.0]},
            {"translation": [0.0, 4.0, 0.0]},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                             "indices": 3, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 4}, "material": 1},
                            {"attributes": {"POSITION": 4}}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                                      "metallicFactor": 0.25, "roughnessFactor": 0.4,
                                      "baseColorTexture": {"index": 0}}},
            {"emissiveFactor": [4.0, 3.0, 2.0]},
        ],
        "textures": [{"source": 0}],
        "images": [{"uri": "base.png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 12, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 12, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 12, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": 18, "type": "SCALAR"},
            {"bufferView": 4, "componentType": 5126, "count": 9, "type": "VEC3"},
        ],
        "bufferViews": views,
        "buffers": [{"byteLength": len(buf), "uri": "mesh.bin"}],
    }


@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_gltf_transforms_uvs_and_materials_match_reference(tmp_path, instanced, scale):
    p = tmp_path / "rich.gltf"
    p.write_text(json.dumps(_rich_doc(tmp_path)))
    scene, _, b, prims = _load_both(str(p), scale=scale, instanced=instanced)
    rows = b.materials.rows
    assert [r["type"] for r in rows] == [int(MaterialType.DISNEY), int(MaterialType.EMISSIVE),
                                         int(MaterialType.DIFFUSE)]
    assert rows[0]["albedo_map"] == 0 and scene["has_albedo_maps"]
    if instanced:  # two meshes as objects, three mesh nodes as instances
        assert scene["num_instances"] == 3 and len(prims) == 3
        assert scene["num_tris"] == 6 + 3 + 3
    else:
        assert len(prims) == 4 and scene["num_tris"] == 6 + 3 + 3 + 6
