"""Binary FBX importer (meshes, skins, skeleton, animation takes).

Counterpart of aten_tpu/io/fbx.py, which it follows so both packages
read the same arrays from one file.  The "Kaydara FBX Binary" format,
version 7.x, is parsed with the standard library (zlib included) and
numpy, and feeds the structures the glTF path produces
(anim/skinning.DeformableMesh, anim/skeleton.Skeleton,
anim/animation.AnimationClip).

Format summary (publicly documented layout):
  header: 23-byte magic "Kaydara FBX Binary  \\x00\\x1a\\x00" + u32 version
  node record: endOffset, numProps, propListLen (u32 each below version
    7500, u64 from it), nameLen u8, name, properties, nested children,
    then a NULL record (13 or 25 bytes)
  property typecodes: Y i16, C bool, I i32, F f32, D f64, L i64,
    f/d/l/i/b arrays {len u32, encoding u32, compLen u32, data
    (zlib-deflate when encoding == 1)}, S string, R raw.

Scope: triangulated meshes (polygon fan), normals and UVs
(ByPolygonVertex or ByControlPoint, Direct or IndexToDirect),
per-polygon material ids, skin clusters (Indexes, Weights,
TransformLink), the LimbNode skeleton with Lcl TRS and PreRotation, and
animation takes (AnimationStack -> Layer -> CurveNode -> Curve, KeyTime
ticks and d|X/Y/Z channels -> AnimationClip).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from aten_tpu_torch.anim.animation import AnimationClip
from aten_tpu_torch.anim.skeleton import Skeleton
from aten_tpu_torch.anim.skinning import DeformableMesh
from aten_tpu_torch.scene.materials import MaterialType

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_array(data, off, fmt, itemsize):
    n, enc, comp = struct.unpack_from("<III", data, off)
    off += 12
    if enc == 0:
        raw = bytes(data[off:off + n * itemsize])
        off += n * itemsize
    else:
        raw = zlib.decompress(bytes(data[off:off + comp]))
        off += comp
    return np.frombuffer(raw, fmt, n), off


def _read_prop(data, off):
    t = data[off:off + 1]
    off += 1
    if t == b"Y":
        return struct.unpack_from("<h", data, off)[0], off + 2
    if t == b"C":
        return bool(data[off]), off + 1
    if t == b"I":
        return struct.unpack_from("<i", data, off)[0], off + 4
    if t == b"F":
        return struct.unpack_from("<f", data, off)[0], off + 4
    if t == b"D":
        return struct.unpack_from("<d", data, off)[0], off + 8
    if t == b"L":
        return struct.unpack_from("<q", data, off)[0], off + 8
    if t == b"f":
        return _read_array(data, off, "<f4", 4)
    if t == b"d":
        return _read_array(data, off, "<f8", 8)
    if t == b"l":
        return _read_array(data, off, "<i8", 8)
    if t == b"i":
        return _read_array(data, off, "<i4", 4)
    if t == b"b":
        return _read_array(data, off, "u1", 1)
    if t in (b"S", b"R"):
        n = struct.unpack_from("<I", data, off)[0]
        off += 4
        raw = bytes(data[off:off + n])
        return (raw.decode("utf-8", "replace") if t == b"S" else raw), off + n
    raise ValueError(f"unknown FBX property type {t!r} at {off}")


def _read_node(data, off, big):
    if big:  # version >= 7500: 64-bit offsets
        end, nprops, _plen = struct.unpack_from("<QQQ", data, off)
        off += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", data, off)
        off += 12
    nlen = data[off]
    off += 1
    name = bytes(data[off:off + nlen]).decode("ascii", "replace")
    off += nlen
    if end == 0:  # null terminator record
        return None, off
    props = []
    for _ in range(nprops):
        p, off = _read_prop(data, off)
        props.append(p)
    children = []
    while off < end:
        child, off = _read_node(data, off, big)
        if child is None:
            break
    # _read_node returning None advanced past the sentinel
        children.append(child)
    return FbxNode(name, props, children), end


def parse_fbx(path):
    """Parse a binary FBX file into an FbxNode tree (root node)."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    if bytes(data[:23]) != _MAGIC:
        raise ValueError("not a binary FBX file (ASCII FBX unsupported)")
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500
    off = 27
    top = []
    while off < len(data):
        node, off = _read_node(data, off, big)
        if node is None:
            break
        top.append(node)
    return FbxNode("", [version], top)


# ---------------------------------------------------------------------------
# Scene interpretation
# ---------------------------------------------------------------------------


def _props70(node):
    """{name: value-tuple} of a Properties70 block."""
    out = {}
    p70 = node.first("Properties70")
    if p70 is None:
        return out
    for p in p70.find("P"):
        out[p.props[0]] = tuple(p.props[4:])
    return out


_ROT_ORDERS = ("XYZ", "XZY", "YZX", "YXZ", "ZXY", "ZYX")


def _rotation_order(props):
    """Map a model's RotationOrder Properties70 enum (0..5) to the
    Euler-order string consumed by _euler_deg_to_quat; FBX default XYZ."""
    ro = props.get("RotationOrder")
    if not ro:
        return "XYZ"
    try:
        return _ROT_ORDERS[int(ro[-1])]
    except (ValueError, IndexError, TypeError):
        return "XYZ"


def _euler_deg_to_quat(e, order="XYZ"):
    """Euler degrees -> quaternion (x,y,z,w), FBX default order XYZ
    (R = Rz @ Ry @ Rx applied to column vectors)."""
    rx, ry, rz = [np.deg2rad(float(a)) for a in e]

    def axis_q(axis, a):
        s, c = np.sin(a / 2), np.cos(a / 2)
        v = [0.0, 0.0, 0.0]
        v[axis] = s
        return np.array([v[0], v[1], v[2], c], np.float64)

    def qmul(a, b):
        ax, ay, az, aw = a
        bx, by, bz, bw = b
        return np.array([
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ])

    qx, qy, qz = axis_q(0, rx), axis_q(1, ry), axis_q(2, rz)
    seq = {"XYZ": (qz, qy, qx), "ZYX": (qx, qy, qz), "XZY": (qy, qz, qx),
           "YZX": (qx, qz, qy), "YXZ": (qz, qx, qy), "ZXY": (qy, qx, qz)}
    a, b, c = seq.get(order, (qz, qy, qx))
    q = qmul(a, qmul(b, c))
    return (q / np.linalg.norm(q)).astype(np.float32)


def _layer_values(geom, layer_name, value_name, index_name, poly_vert_ids,
                  width):
    """Resolve a layer element (normals/uvs) to per-polygon-vertex rows."""
    layer = geom.first(layer_name)
    if layer is None:
        return None
    mapping = (layer.first("MappingInformationType").props[0]
               if layer.first("MappingInformationType") else "ByPolygonVertex")
    ref = (layer.first("ReferenceInformationType").props[0]
           if layer.first("ReferenceInformationType") else "Direct")
    vals_node = layer.first(value_name)
    if vals_node is None:
        return None
    vals = np.asarray(vals_node.props[0], np.float64).reshape(-1, width)
    if ref == "IndexToDirect":
        idx_node = layer.first(index_name)
        if idx_node is not None and len(idx_node.props):
            idx = np.asarray(idx_node.props[0], np.int64)
            # ByPolygonVertex index arrays address polygon corners
            if mapping == "ByPolygonVertex":
                vals = vals[np.clip(idx, 0, len(vals) - 1)]
                mapping = "ByPolygonVertex_resolved"
            else:
                vals = vals[np.clip(idx, 0, len(vals) - 1)]
    if mapping in ("ByPolygonVertex", "ByPolygonVertex_resolved"):
        return vals.astype(np.float32)  # one row per polygon corner
    if mapping in ("ByVertice", "ByVertex", "ByControlPoint"):
        return vals.astype(np.float32)[poly_vert_ids]
    if mapping == "AllSame":
        return np.repeat(vals.astype(np.float32), len(poly_vert_ids), axis=0)
    return None


def _triangulate(pvi):
    """PolygonVertexIndex -> (tri corner index triples into the flattened
    corner list, per-corner control-point ids).  Negative entry = last
    corner of a polygon, actual id = ~v (published encoding)."""
    corners = np.where(pvi < 0, ~pvi, pvi)
    tri_corners = []
    start = 0
    for i, v in enumerate(pvi):
        if v < 0:  # polygon of corners [start..i]
            for k in range(start + 1, i):
                tri_corners.append((start, k, k + 1))
            start = i + 1
    tris = np.asarray(tri_corners, np.int64).reshape(-1, 3)
    return tris, corners


def load_fbx_meshes(path):
    """All mesh geometries: list of dicts {name, pos [V,3], faces [T,3],
    normals [T*3,3] per-corner or None, uvs, material of each tri}."""
    root = parse_fbx(path)
    objects = root.first("Objects")
    if objects is None:
        return []
    out = []
    for geom in objects.find("Geometry"):
        if len(geom.props) < 3 or geom.props[2] != "Mesh":
            continue
        vn = geom.first("Vertices")
        pn = geom.first("PolygonVertexIndex")
        if vn is None or pn is None:
            continue
        pos = np.asarray(vn.props[0], np.float64).reshape(-1, 3)
        pvi = np.asarray(pn.props[0], np.int64)
        tris, corners = _triangulate(pvi)
        faces = corners[tris]  # control-point ids per triangle
        nrm_rows = _layer_values(geom, "LayerElementNormal", "Normals",
                                 "NormalsIndex", corners, 3)
        uv_rows = _layer_values(geom, "LayerElementUV", "UV", "UVIndex",
                                corners, 2)
        # per-triangle material slot
        mat_tri = np.zeros(len(tris), np.int64)
        lm = geom.first("LayerElementMaterial")
        if lm is not None and lm.first("Materials") is not None:
            mats = np.asarray(lm.first("Materials").props[0], np.int64)
            mapping = (lm.first("MappingInformationType").props[0]
                       if lm.first("MappingInformationType") else "AllSame")
            if mapping == "ByPolygon" and len(mats):
                # triangle -> source polygon index
                poly_ids = []
                poly = 0
                start = 0
                for i, v in enumerate(pvi):
                    if v < 0:
                        n_tris = (i - start + 1) - 2
                        poly_ids.extend([poly] * max(n_tris, 0))
                        poly += 1
                        start = i + 1
                mat_tri = mats[np.clip(np.asarray(poly_ids, np.int64), 0,
                                       len(mats) - 1)]
            elif len(mats):
                mat_tri[:] = mats[0]
        out.append({
            "id": geom.props[0] if geom.props else 0,
            "name": (geom.props[1].split("\x00")[0]
                     if len(geom.props) > 1 and isinstance(geom.props[1], str)
                     else ""),
            "pos": pos.astype(np.float32),
            "faces": faces,
            "tri_corners": tris,
            "normals_corner": nrm_rows,
            "uvs_corner": uv_rows,
            "mat_tri": mat_tri,
        })
    return out


def _connections(root):
    """(child -> [parents], (child,parent) -> prop) from the C records."""
    conn = {}
    cn = root.first("Connections")
    if cn is None:
        return conn
    for c in cn.find("C"):
        if len(c.props) >= 3:
            conn.setdefault(c.props[1], []).append(c.props[2])
    return conn


def _connections_full(root):
    """All C records as (child, parent, property-or-None) triples."""
    out = []
    cn = root.first("Connections")
    if cn is None:
        return out
    for c in cn.find("C"):
        if len(c.props) >= 3:
            out.append((c.props[1], c.props[2],
                        c.props[3] if len(c.props) > 3 else None))
    return out


def _limb_order(objects, conn):
    """(topological joint-node order, child->parent map) over LimbNode/
    Root/Null models — shared by the skin importer and the clip loader
    so both assign identical joint indices."""
    limb_ids = [n.props[0] for n in objects.find("Model")
                if len(n.props) >= 3 and n.props[2] in ("LimbNode", "Root",
                                                        "Null")]
    limb_set = set(limb_ids)
    parent_of = {}
    for child in limb_ids:
        for p in conn.get(child, []):
            if p in limb_set:
                parent_of[child] = p
                break
    order = []
    seen = set()

    def add(n):
        if n in seen:
            return
        p = parent_of.get(n)
        if p is not None:
            add(p)
        seen.add(n)
        order.append(n)

    for n in limb_ids:
        add(n)
    return order, parent_of


def _model_name(node):
    p = node.props
    if len(p) > 1 and isinstance(p[1], str):
        return p[1].split("\x00")[0]
    return ""


def fbx_joint_names(path):
    """Joint names in the same order load_fbx_skinned assigns indices."""
    root = parse_fbx(path)
    objects = root.first("Objects")
    conn = _connections(root)
    order, _ = _limb_order(objects, conn)
    by_id = {n.props[0]: n for n in objects.children if n.props}
    return [_model_name(by_id[nid]) for nid in order]


# 1 second = 46,186,158,000 FBX KTime ticks (published constant)
_KTIME_PER_SEC = 46186158000.0


def load_fbx_clip(path, joint_names=None):
    """Parse the file's take (AnimationStack -> Layer -> CurveNode ->
    Curve chain, KeyTime/KeyValueFloat) into an anim.AnimationClip:
    d|X/Y/Z channel curves land on TRS tracks, Euler rotation keys are composed with
    the model's PreRotation under its RotationOrder, exactly like the
    bind pose import.

    joint_names: target joint order (e.g. fbx_joint_names(model_fbx));
    curves are matched to it BY MODEL NAME so a separate motion take
    (unitychan_WAIT00.fbx style) can drive the model file's skeleton.
    Joints without curves hold the MOTION file's bind TRS.  Returns an
    AnimationClip with time 0 at the take's first key."""
    root = parse_fbx(path)
    objects = root.first("Objects")
    by_id = {n.props[0]: n for n in objects.children if n.props}
    conns = _connections_full(root)
    conn = _connections(root)
    order, _ = _limb_order(objects, conn)
    names = {nid: _model_name(by_id[nid]) for nid in order}

    # CurveNode -> (model node id, TRS property)
    acn_target = {}
    for child, parent, prop in conns:
        n = by_id.get(child)
        if (n is not None and n.name == "AnimationCurveNode"
                and parent in names
                and prop in ("Lcl Translation", "Lcl Rotation",
                             "Lcl Scaling")):
            acn_target[child] = (parent, prop)
    # (CurveNode, axis channel) -> AnimationCurve node
    curves = {}
    for child, parent, prop in conns:
        n = by_id.get(child)
        if (parent in acn_target and n is not None
                and n.name == "AnimationCurve"):
            curves[(parent, prop)] = n

    # per joint node: {"Lcl Translation": {axis: (times_s, values)}}
    chans = {}
    t_min = None
    for acn, (model, prop) in acn_target.items():
        for axis in ("d|X", "d|Y", "d|Z"):
            c = curves.get((acn, axis))
            if c is None:
                continue
            kt_node = c.first("KeyTime")
            kv_node = c.first("KeyValueFloat")
            if kt_node is None or kv_node is None or not len(kt_node.props):
                continue
            kt = (np.asarray(kt_node.props[0], np.float64)
                  / _KTIME_PER_SEC)
            kv = np.asarray(kv_node.props[0], np.float64)
            if kt.size == 0:
                continue
            chans.setdefault(model, {}).setdefault(prop, {})[axis] = (kt, kv)
            t0 = float(kt[0])
            t_min = t0 if t_min is None else min(t_min, t0)
    if t_min is None:
        t_min = 0.0

    if joint_names is None:
        targets = [names[nid] for nid in order]
    else:
        targets = list(joint_names)
    # motion-file model lookup by name (first match wins)
    node_of_name = {}
    for nid in order:
        node_of_name.setdefault(names[nid], nid)

    tracks = []
    for name in targets:
        nid = node_of_name.get(name)
        node = by_id.get(nid) if nid is not None else None
        props = _props70(node) if node is not None else {}
        bt = np.asarray(props.get("Lcl Translation", (0, 0, 0))[-3:],
                        np.float64)
        br = np.asarray(props.get("Lcl Rotation", (0, 0, 0))[-3:],
                        np.float64)
        bs = np.asarray(props.get("Lcl Scaling", (1, 1, 1))[-3:],
                        np.float64)
        pre = props.get("PreRotation")
        rot_order = _rotation_order(props)
        ch = chans.get(nid, {})

        # union timeline over this joint's channels (seconds, 0-based)
        all_t = [kt for group in ch.values() for kt, _ in group.values()]
        if all_t:
            times = np.unique(np.concatenate(all_t)) - t_min
        else:
            times = np.zeros(1, np.float64)

        def resample(group, default3):
            out = np.tile(np.asarray(default3, np.float64), (len(times), 1))
            for a, axis in enumerate(("d|X", "d|Y", "d|Z")):
                if axis in group:
                    kt, kv = group[axis]
                    out[:, a] = np.interp(times + t_min, kt, kv)
            return out

        tr = resample(ch.get("Lcl Translation", {}), bt)
        eu = resample(ch.get("Lcl Rotation", {}), br)
        sc = resample(ch.get("Lcl Scaling", {}), bs)
        q = np.stack([_euler_deg_to_quat(e, rot_order) for e in eu])
        if pre is not None:
            qp = _euler_deg_to_quat(pre[-3:], rot_order)
            x1, y1, z1, w1 = qp
            x2, y2, z2, w2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
            q = np.stack([
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            ], axis=1)
        tracks.append({
            "times": times.astype(np.float32),
            "trans": tr.astype(np.float32),
            "rot": q.astype(np.float32),
            "scale": sc.astype(np.float32),
        })
    return AnimationClip.from_tracks(tracks)


def load_fbx_skinned(builder, path, mtl_id=None):
    """Import the first skinned mesh: returns (DeformableMesh attached to
    `builder`, Skeleton, [] clips, inv_bind [J,4,4]) — the same contract
    as anim.formats.load_gltf_skinned, so FBX assets drive the identical
    LBS + per-frame LBVH rebuild path."""
    root = parse_fbx(path)
    objects = root.first("Objects")
    if objects is None:
        raise ValueError(f"{path}: no Objects section")
    meshes = load_fbx_meshes(path)
    if not meshes:
        raise ValueError(f"{path}: no mesh geometry")

    by_id = {}
    for n in objects.children:
        if n.props:
            by_id[n.props[0]] = n
    conn = _connections(root)
    order, parent_of = _limb_order(objects, conn)
    jindex = {n: j for j, n in enumerate(order)}

    J = len(order)
    parents, bind_t = [], np.zeros((J, 3), np.float32)
    bind_q = np.tile(np.array([0, 0, 0, 1], np.float32), (J, 1))
    bind_s = np.ones((J, 3), np.float32)
    for j, nid in enumerate(order):
        node = by_id[nid]
        p = parent_of.get(nid)
        parents.append(jindex[p] if p is not None else -1)
        props = _props70(node)
        t = props.get("Lcl Translation", (0, 0, 0))[-3:]
        r = props.get("Lcl Rotation", (0, 0, 0))[-3:]
        pre = props.get("PreRotation")
        s = props.get("Lcl Scaling", (1, 1, 1))[-3:]
        rot_order = _rotation_order(props)
        bind_t[j] = np.asarray(t, np.float64)
        q = _euler_deg_to_quat(r, rot_order)
        if pre is not None:
            qpre = _euler_deg_to_quat(pre[-3:], rot_order)
            # q_total = q_pre * q_lcl
            x1, y1, z1, w1 = qpre
            x2, y2, z2, w2 = q
            q = np.array([
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            ], np.float32)
        bind_q[j] = q
        bind_s[j] = np.asarray(s, np.float64)
    skel = Skeleton(tuple(parents), bind_t, bind_q, bind_s)

    # skin clusters of the first skinned geometry
    mesh = None
    clusters = []
    for m in meshes:
        gid = m["id"]
        # Geometry <- Skin deformer <- Clusters (children in connections)
        skin_ids = [cid for cid, pars in conn.items()
                    if gid in pars and cid in by_id
                    and by_id[cid].name == "Deformer"
                    and len(by_id[cid].props) >= 3
                    and by_id[cid].props[2] == "Skin"]
        if not skin_ids:
            continue
        cl = [cid for cid, pars in conn.items()
              if skin_ids[0] in pars and cid in by_id
              and by_id[cid].name == "Deformer"]
        if cl:
            mesh, clusters = m, cl
            break
    if mesh is None:
        raise ValueError(f"{path}: no skinned mesh")

    V = len(mesh["pos"])
    wacc = np.zeros((V, J), np.float32)
    inv_bind = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    for cid in clusters:
        cnode = by_id[cid]
        # cluster -> LimbNode connection
        limb = None
        for p in conn.get(cid, []):
            if p in jindex:
                limb = p
        # fallback: the cluster PARENTS list holds the skin; the limb is
        # a child connection (cluster is parent of nothing) — search both
        if limb is None:
            for child, pars in conn.items():
                if cid in pars and child in jindex:
                    limb = child
                    break
        if limb is None:
            continue
        j = jindex[limb]
        idxs = cnode.first("Indexes")
        wts = cnode.first("Weights")
        if idxs is None or wts is None or not len(idxs.props):
            continue
        ii = np.asarray(idxs.props[0], np.int64)
        ww = np.asarray(wts.props[0], np.float64)
        ok = (ii >= 0) & (ii < V)
        wacc[ii[ok], j] = ww[ok]
        tl = cnode.first("TransformLink")
        if tl is not None and len(tl.props):
            m44 = np.asarray(tl.props[0], np.float64).reshape(4, 4).T
            inv_bind[j] = np.linalg.inv(m44).astype(np.float32)

    # top-4 weights per vertex, normalized (LBS convention)
    top = np.argsort(-wacc, axis=1)[:, :4]
    w4 = np.take_along_axis(wacc, top, axis=1)
    norm = np.maximum(w4.sum(axis=1, keepdims=True), 1e-8)
    w4 = (w4 / norm).astype(np.float32)
    j4 = top.astype(np.int32)

    if mtl_id is None:
        mtl_id = builder.add_material(
            MaterialType.DIFFUSE, base_color=(0.75, 0.75, 0.75)
        )
    dm = DeformableMesh.attach(
        builder, mesh["pos"], mesh["faces"].astype(np.int32), mtl_id,
        w4, j4,
    )
    return dm, skel, [], inv_bind
