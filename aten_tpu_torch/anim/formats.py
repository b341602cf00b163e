"""Deformable model and animation containers.

Counterpart of aten_tpu/anim/formats.py:
  1. an .npz container (`save_deformable`, `load_deformable`) holding a
     DeformableMesh's arrays, its Skeleton, AnimationClips and inverse
     bind matrices;
  2. the skinned glTF importer (`load_gltf_skinned`): the first skin's
     joints in topological (parents-first) order, its inverse bind
     matrices, the skinned mesh attached to a SceneBuilder, and each
     animation as a clip on the union of its channels' key times.
"""
from __future__ import annotations

import numpy as np

from aten_tpu_torch.anim.animation import AnimationClip
from aten_tpu_torch.anim.skeleton import Skeleton
from aten_tpu_torch.anim.skinning import DeformableMesh
from aten_tpu_torch.io.gltf import _accessor, _load_doc
from aten_tpu_torch.scene.materials import MaterialType


def save_deformable(path, mesh: DeformableMesh, skel: Skeleton,
                    clips=None, inv_bind=None):
    """Write the MDL/SKL/ANM-equivalent .npz container."""
    d = {
        "tri_start": np.int64(mesh.tri_start),
        "faces": mesh.faces,
        "bind_pos": mesh.bind_pos,
        "bind_nml": mesh.bind_nml,
        "weights": mesh.weights,
        "joints": mesh.joints,
        "skel_parents": np.asarray(skel.parents, np.int64),
        "skel_t": skel.bind_t,
        "skel_q": skel.bind_q,
        "skel_s": skel.bind_s,
    }
    if inv_bind is not None:
        d["inv_bind"] = np.asarray(inv_bind, np.float32)
    for i, c in enumerate(clips or []):
        d[f"clip{i}_times"] = c.times
        d[f"clip{i}_trans"] = c.trans
        d[f"clip{i}_rot"] = c.rot
        d[f"clip{i}_scale"] = c.scale
    np.savez_compressed(path, **d)


def load_deformable(path):
    """Returns (DeformableMesh, Skeleton, [AnimationClip], inv_bind|None)."""
    with np.load(path) as z:
        mesh = DeformableMesh(
            tri_start=int(z["tri_start"]),
            faces=z["faces"],
            bind_pos=z["bind_pos"],
            bind_nml=z["bind_nml"],
            weights=z["weights"],
            joints=z["joints"],
        )
        skel = Skeleton(
            parents=tuple(int(p) for p in z["skel_parents"]),
            bind_t=z["skel_t"],
            bind_q=z["skel_q"],
            bind_s=z["skel_s"],
        )
        clips = []
        i = 0
        while f"clip{i}_times" in z.files:
            clips.append(AnimationClip(
                z[f"clip{i}_times"], z[f"clip{i}_trans"],
                z[f"clip{i}_rot"], z[f"clip{i}_scale"],
            ))
            i += 1
        inv_bind = z["inv_bind"] if "inv_bind" in z.files else None
    return mesh, skel, clips, inv_bind


def load_gltf_skinned(builder, path, mtl_id=None):
    """Import the first skinned mesh of a glTF file.

    Returns (DeformableMesh attached to `builder`, Skeleton,
    [AnimationClip], inv_bind [J,4,4]).  Joint indices in the returned
    mesh are remapped into topological (parents-first) order as the
    Skeleton class requires.
    """
    doc, buffers = _load_doc(path)
    skins = doc.get("skins")
    if not skins:
        raise ValueError(f"{path}: no skins in the glTF file")
    skin = skins[0]
    joint_nodes = skin["joints"]  # node indices
    J = len(joint_nodes)
    nodes = doc["nodes"]

    # topological order of joints (parents before children)
    node_to_joint = {n: j for j, n in enumerate(joint_nodes)}
    parent_node = {}
    for ni, nd in enumerate(nodes):
        for c in nd.get("children", []):
            parent_node[c] = ni
    order = []
    seen = set()

    def add_joint(n):
        if n in seen:
            return
        p = parent_node.get(n)
        if p is not None and p in node_to_joint:
            add_joint(p)
        seen.add(n)
        order.append(n)

    for n in joint_nodes:
        add_joint(n)
    remap = {node_to_joint[n]: k for k, n in enumerate(order)}  # old j -> new

    parents = []
    bind_t = np.zeros((J, 3), np.float32)
    bind_q = np.tile(np.array([0, 0, 0, 1], np.float32), (J, 1))
    bind_s = np.ones((J, 3), np.float32)
    for k, n in enumerate(order):
        nd = nodes[n]
        p = parent_node.get(n)
        parents.append(remap[node_to_joint[p]] if p in node_to_joint else -1)
        bind_t[k] = nd.get("translation", [0, 0, 0])
        bind_q[k] = nd.get("rotation", [0, 0, 0, 1])
        bind_s[k] = nd.get("scale", [1, 1, 1])
    skel = Skeleton(tuple(parents), bind_t, bind_q, bind_s)

    inv_bind = None
    if "inverseBindMatrices" in skin:
        ibm = _accessor(doc, buffers, skin["inverseBindMatrices"])
        ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)  # column-major in
        inv_bind = np.zeros_like(ibm)
        for old_j in range(J):
            inv_bind[remap[old_j]] = ibm[old_j]
        inv_bind = inv_bind.astype(np.float32)

    # the skinned mesh: first mesh on a node with this skin
    mesh_prim = None
    for nd in nodes:
        if nd.get("skin") == 0 and "mesh" in nd:
            mesh_prim = doc["meshes"][nd["mesh"]]["primitives"][0]
            break
    if mesh_prim is None:
        raise ValueError(f"{path}: no node uses skin 0")
    attrs = mesh_prim["attributes"]
    pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
    nml = (
        _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
        if "NORMAL" in attrs else None
    )
    jts = _accessor(doc, buffers, attrs["JOINTS_0"]).astype(np.int64)
    wts = _accessor(doc, buffers, attrs["WEIGHTS_0"]).astype(np.float32)
    jts = np.vectorize(lambda j: remap[int(j)])(jts).astype(np.int32)
    if "indices" in mesh_prim:
        faces = _accessor(doc, buffers, mesh_prim["indices"]).reshape(-1, 3)
    else:
        faces = np.arange(len(pos)).reshape(-1, 3)
    if mtl_id is None:
        mtl_id = builder.add_material(
            MaterialType.DIFFUSE, base_color=(0.7, 0.7, 0.7)
        )
    mesh = DeformableMesh.attach(
        builder, pos, faces.astype(np.int64), mtl_id, wts, jts, nml=nml
    )

    # animations -> clips (channels grouped per animation)
    clips = []
    for anim in doc.get("animations", []):
        tracks = [
            {"times": np.array([0.0], np.float32),
             "trans": bind_t[j : j + 1].copy(),
             "rot": bind_q[j : j + 1].copy(),
             "scale": bind_s[j : j + 1].copy()}
            for j in range(J)
        ]
        per_joint = {}
        for ch in anim["channels"]:
            tgt = ch["target"]
            n = tgt.get("node")
            if n not in node_to_joint:
                continue
            j = remap[node_to_joint[n]]
            smp = anim["samplers"][ch["sampler"]]
            times = _accessor(doc, buffers, smp["input"]).reshape(-1)
            vals = _accessor(doc, buffers, smp["output"])
            per_joint.setdefault(j, {})[tgt["path"]] = (
                times.astype(np.float32), vals.astype(np.float32)
            )
        for j, chans in per_joint.items():
            # merge channels on the union timeline (resampled linearly)
            all_t = np.unique(np.concatenate(
                [t for t, _ in chans.values()]
            ))

            def resample(t, v, K):
                out = np.zeros((len(all_t), K), np.float32)
                for c in range(K):
                    out[:, c] = np.interp(all_t, t, v[:, c])
                return out

            tr = chans.get("translation")
            q = chans.get("rotation")
            sc = chans.get("scale")
            tracks[j] = {
                "times": all_t,
                "trans": resample(*tr, 3) if tr else
                    np.tile(bind_t[j], (len(all_t), 1)),
                "rot": resample(*q, 4) if q else
                    np.tile(bind_q[j], (len(all_t), 1)),
                "scale": resample(*sc, 3) if sc else
                    np.tile(bind_s[j], (len(all_t), 1)),
            }
        clips.append(AnimationClip.from_tracks(tracks))
    return mesh, skel, clips, inv_bind
