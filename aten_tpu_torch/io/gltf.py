"""glTF 2.0 importer.

Counterpart of aten_tpu/io/gltf.py, which it follows so both packages
build the same arrays from one file: JSON with external .bin or embedded
base64 buffers, and the GLB binary container; meshes (POSITION, NORMAL,
TEXCOORD_0 and indices); the node hierarchy with TRS or matrix
transforms, baked into world space or, with instanced=True, one object
a glTF mesh and one instance a node (the two-level pool and kernel K5);
and pbrMetallicRoughness materials mapped onto the Disney rows of the
material table, base-colour textures through io/image.py.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np
import torch

from aten_tpu_torch.anim.skeleton import quat_to_mat
from aten_tpu_torch.io.image import load_image
from aten_tpu_torch.scene.materials import MaterialType

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_doc(path):
    """Returns (json_dict, [buffer bytes])."""
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        data = f.read()
    if head == b"glTF":  # GLB container
        magic, version, length = struct.unpack_from("<III", data, 0)
        off = 12
        doc = None
        bin_chunk = b""
        while off < length:
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            off += 8 + clen
        buffers = [bin_chunk]
        return doc, buffers
    doc = json.loads(data.decode("utf-8"))
    buffers = []
    base = os.path.dirname(path)
    for b in doc.get("buffers", []):
        uri = b.get("uri", "")
        if uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base, uri), "rb") as f:
                buffers.append(f.read())
    return doc, buffers


def _accessor(doc, buffers, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    width = _TYPE_WIDTH[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype().nbytes * width
    if stride == dtype().nbytes * width:
        a = np.frombuffer(buf, dtype, count * width, offset).reshape(count, width)
    else:  # interleaved
        a = np.lib.stride_tricks.as_strided(
            np.frombuffer(buf, np.uint8),
            shape=(count, width),
            strides=(stride, dtype().nbytes),
        ).view(dtype)[:count]
        a = np.array(
            [np.frombuffer(buf, dtype, width, offset + i * stride)
             for i in range(count)]
        )
    return np.array(a)


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "rotation" in node or "translation" in node or "scale" in node:
        t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
        q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
        s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
        r = quat_to_mat(torch.from_numpy(q)).numpy()
        m[:3, :3] = r * s[None, :]
        m[:3, 3] = t
    return m


def _gltf_material(builder, doc, buffers, midx, base_dir, tex_cache):
    if midx is None:
        return builder.add_material(
            MaterialType.DIFFUSE, base_color=(0.8, 0.8, 0.8)
        )
    m = doc.get("materials", [])[midx]
    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    metallic = pbr.get("metallicFactor", 1.0)
    rough = pbr.get("roughnessFactor", 1.0)
    kw = {}
    tex_info = pbr.get("baseColorTexture")
    if tex_info is not None and "textures" in doc:
        ti = doc["textures"][tex_info["index"]].get("source")
        if ti is not None and ti not in tex_cache:
            img_def = doc["images"][ti]
            uri = img_def.get("uri")
            if uri and not uri.startswith("data:"):
                tex_cache[ti] = builder.add_texture(
                    load_image(os.path.join(base_dir, uri))
                )
        if ti in tex_cache:
            kw["albedo_map"] = tex_cache[ti]
    if m.get("emissiveFactor") and max(m["emissiveFactor"]) > 0:
        return builder.add_material(
            MaterialType.EMISSIVE, base_color=tuple(m["emissiveFactor"])
        )
    return builder.add_material(
        MaterialType.DISNEY,
        base_color=tuple(base[:3]),
        metallic=float(metallic),
        roughness=float(rough),
        **kw,
    )


def load_gltf(builder, path, scale=1.0, instanced=False):
    """Load a .gltf/.glb into a SceneBuilder.

    instanced=False bakes node transforms into world-space vertices (the
    AssimpImporter flattening); instanced=True registers each glTF mesh
    as an object and each node as an instance (two-level TLAS).
    Returns a list of (tri_start, tri_count) per loaded primitive.
    """
    doc, buffers = _load_doc(path)
    base_dir = os.path.dirname(path)
    tex_cache = {}
    mtl_cache = {}

    def material_for(prim):
        mi = prim.get("material")
        if mi not in mtl_cache:
            mtl_cache[mi] = _gltf_material(
                builder, doc, buffers, mi, base_dir, tex_cache
            )
        return mtl_cache[mi]

    # world transform per node (scene graph flatten)
    nodes = doc.get("nodes", [])
    world = [None] * len(nodes)

    def visit(ni, parent_m):
        m = parent_m @ _node_matrix(nodes[ni])
        world[ni] = m
        for c in nodes[ni].get("children", []):
            visit(c, m)

    scene_idx = doc.get("scene", 0)
    roots = doc.get("scenes", [{}])[scene_idx].get("roots") or doc.get(
        "scenes", [{}]
    )[scene_idx].get("nodes", [])
    for r in roots:
        visit(r, np.diag([scale, scale, scale, 1.0]).astype(np.float32))

    out = []
    mesh_obj = {}
    for ni, node in enumerate(nodes):
        if world[ni] is None or "mesh" not in node:
            continue
        mesh = doc["meshes"][node["mesh"]]
        if instanced:
            if node["mesh"] not in mesh_obj:
                oid = builder.create_object()
                for prim in mesh["primitives"]:
                    out.append(_add_prim(builder, doc, buffers, prim,
                                         material_for, np.eye(4, dtype=np.float32),
                                         obj=oid))
                mesh_obj[node["mesh"]] = oid
            builder.add_instance(mesh_obj[node["mesh"]], world[ni])
        else:
            for prim in mesh["primitives"]:
                out.append(_add_prim(builder, doc, buffers, prim,
                                     material_for, world[ni], obj=None))
    return out


def _add_prim(builder, doc, buffers, prim, material_for, xform, obj):
    attrs = prim["attributes"]
    pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
    pos = pos @ xform[:3, :3].T + xform[:3, 3]
    nml = None
    if "NORMAL" in attrs:
        nml = _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
        nmtx = np.linalg.inv(xform[:3, :3]).T
        nml = nml @ nmtx.T
        nml /= np.maximum(np.linalg.norm(nml, axis=1, keepdims=True), 1e-12)
    uv = None
    if "TEXCOORD_0" in attrs:
        uv = _accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
        uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=1)  # glTF v down
    if "indices" in prim:
        idx = _accessor(doc, buffers, prim["indices"]).reshape(-1)
    else:
        idx = np.arange(len(pos))
    faces = idx.reshape(-1, 3).astype(np.int64)
    return builder.add_mesh(
        pos, faces, material_for(prim), nml=nml, uv=uv, obj=obj
    )
