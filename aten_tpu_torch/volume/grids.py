"""Density-grid ingestion for heterogeneous media.

Counterpart of aten_tpu/volume/grids.py (the reference's NanoVDB
pipeline: grid upload, grid_loader_device.cu; the grid-box proxy
geometry that routes rays into the medium, grid_host.cpp:15-120), in
numpy and zlib, a copy of the reference's own so the port imports
nothing of it.  Media are dense [D, H, W] float32 density arrays
(volume/medium.py tracks through them).  This module holds:
  * .npz / .npy dense grid load and save;
  * a NanoVDB writer and reader for float grids with the NONE and ZIP
    codecs (the published v32.3 layout);
  * procedural fixtures (smoke plume, sphere shell);
  * add_grid_medium: registers a grid and its proxy box so a scene
    routes rays into the medium.
"""
from __future__ import annotations

import struct

import numpy as np

NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0"


def save_grid(path, density, bmin, bmax):
    np.savez_compressed(
        path, density=np.asarray(density, np.float32),
        bmin=np.asarray(bmin, np.float32), bmax=np.asarray(bmax, np.float32),
    )


def load_grid(path):
    """Load a dense grid: .npz (density/bmin/bmax), .npy (unit bbox)."""
    if path.endswith(".npy"):
        d = np.load(path).astype(np.float32)
        return d, np.zeros(3, np.float32), np.ones(3, np.float32)
    with np.load(path) as z:
        return (z["density"].astype(np.float32),
                z["bmin"].astype(np.float32), z["bmax"].astype(np.float32))


def read_nvdb_header(path):
    """Parse a NanoVDB file header; returns dict or raises ValueError.

    Only inspects the file-level header (magic, version, grid count and
    codec); load_nvdb_dense decodes the NONE and ZIP codecs.
    """
    with open(path, "rb") as f:
        data = f.read(64)
    if len(data) < 16:
        raise ValueError("not a NanoVDB file (too short)")
    magic = struct.unpack_from("<Q", data, 0)[0]
    if magic != NANOVDB_MAGIC:
        raise ValueError(f"bad NanoVDB magic {magic:#x}")
    version = struct.unpack_from("<I", data, 8)[0]
    grid_count = struct.unpack_from("<H", data, 12)[0]
    codec = struct.unpack_from("<H", data, 14)[0]
    return {"version": version, "grid_count": grid_count, "codec": codec}


# ---------------------------------------------------------------------------
# NanoVDB codec-NONE float-grid blob reader/writer.
#
# Targets the nanovdb v32.3+ in-memory layout (GridData 672 B, TreeData
# 64 B, root tiles keyed by packed 21-bit coords, 32^3 upper / 16^3
# lower internal nodes, 8^3 leaves).  The reference consumes these via
# the bundled nanovdb headers (volume/medium.cpp:10-25,
# libidaten/volume/grid_loader_device.cu); this implementation is written
# to the published layout and held to the reference's bytes and to the
# committed fixture tests/fixtures/smoke8_zip.nvdb
# (tests/test_torch_grids.py).  The reader derives per-level node
# strides from TreeData's explicit level offsets and node counts instead
# of hardcoding struct sizes, which absorbs alignment-padding
# differences between minor versions.
# ---------------------------------------------------------------------------

_GRIDDATA_BYTES = 672
_TREEDATA_BYTES = 64
_ROOT_BYTES = 64          # RootData<float> incl. pad to 32-byte alignment
_ROOT_TILE_BYTES = 32     # {key u64, child i64, state u32, value f32} + pad
_UPPER_TABLE = 32768      # 32^3 children
_LOWER_TABLE = 4096       # 16^3 children
_LEAF_VOX = 512           # 8^3 voxels
_UPPER_HDR = 24 + 8 + _UPPER_TABLE // 8 * 2 + 16  # bbox+flags+2 masks+stats
_LOWER_HDR = 24 + 8 + _LOWER_TABLE // 8 * 2 + 16
_LEAF_HDR = 12 + 3 + 1 + _LEAF_VOX // 8 + 16      # bboxmin+dif+flag+mask+stats
_ALIGN = 32


def _pad(n, a=_ALIGN):
    return -(-n // a) * a


_UPPER_BYTES = _pad(_UPPER_HDR) + 8 * _UPPER_TABLE
_LOWER_BYTES = _pad(_LOWER_HDR) + 8 * _LOWER_TABLE
_LEAF_BYTES = _pad(_LEAF_HDR) + 4 * _LEAF_VOX

_GRIDTYPE_FLOAT = 1
_GRIDCLASS_FOG = 3  # FogVolume


def _coord_key(i, j, k):
    """Root-tile key: upper-node origin packed 21 bits/axis, z minor."""
    return (
        ((k >> 12) & 0x1FFFFF)
        | (((j >> 12) & 0x1FFFFF) << 21)
        | (((i >> 12) & 0x1FFFFF) << 42)
    )


def write_nvdb(path, density, bmin=(0, 0, 0), bmax=(1, 1, 1),
               grid_name="density", codec="none"):
    """Write a dense [D,H,W] grid as a NanoVDB float FogVolume file —
    the export side of the reference's NanoVDB pipeline, and the fixture
    generator for the reader tests.  codec: "none" | "zip" (zlib, the
    nanovdb::io::Codec::ZIP per-blob compression)."""
    density = np.asarray(density, np.float32)
    D, H, W = density.shape  # indexed [z, y, x] -> ijk = (x, y, z)
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    vox = (bmax - bmin) / np.array([W, H, D], np.float64)

    # carve the index space into leaves/lowers/uppers that contain data
    nx, ny, nz = W, H, D
    leaf_origins = []
    for lz in range(0, nz, 8):
        for ly in range(0, ny, 8):
            for lx in range(0, nx, 8):
                block = density[lz:lz + 8, ly:ly + 8, lx:lx + 8]
                if np.any(block != 0.0):
                    leaf_origins.append((lx, ly, lz))
    lower_map = {}
    for o in leaf_origins:
        lower_map.setdefault((o[0] >> 7 << 7, o[1] >> 7 << 7, o[2] >> 7 << 7),
                             []).append(o)
    upper_map = {}
    for o in lower_map:
        upper_map.setdefault((o[0] >> 12 << 12, o[1] >> 12 << 12,
                              o[2] >> 12 << 12), []).append(o)

    n_leaf = len(leaf_origins)
    n_lower = len(lower_map)
    n_upper = len(upper_map)

    root_bytes = _ROOT_BYTES + n_upper * _ROOT_TILE_BYTES
    tree_start = _GRIDDATA_BYTES
    root_off = _TREEDATA_BYTES           # relative to TreeData
    upper_off = root_off + root_bytes
    lower_off = upper_off + n_upper * _UPPER_BYTES
    leaf_off = lower_off + n_lower * _LOWER_BYTES
    tree_bytes = leaf_off + n_leaf * _LEAF_BYTES
    grid_size = tree_start + tree_bytes

    buf = bytearray(grid_size)

    # --- GridData (NanoVDB.h GridData, 672 B) ---
    struct.pack_into("<QQ", buf, 0, NANOVDB_MAGIC, 0)  # magic, checksum
    version = (32 << 21) | (3 << 10) | 0
    struct.pack_into("<IIIIQ", buf, 16, version, 0, 0, 1, grid_size)
    name = grid_name.encode()[:255]
    buf[40:40 + len(name)] = name
    # Map (264 B at offset 296): index->world affine; diag voxel size
    mat = np.zeros(9, np.float64)
    mat[0], mat[4], mat[8] = vox
    inv = np.zeros(9, np.float64)
    inv[0], inv[4], inv[8] = 1.0 / vox
    struct.pack_into("<9d", buf, 296, *mat)
    struct.pack_into("<9d", buf, 296 + 72, *inv)
    struct.pack_into("<3d", buf, 296 + 144, *bmin)
    struct.pack_into("<d", buf, 296 + 168, 0.0)  # taper
    struct.pack_into("<9f", buf, 296 + 176, *mat.astype(np.float32))
    struct.pack_into("<9f", buf, 296 + 212, *inv.astype(np.float32))
    struct.pack_into("<3f", buf, 296 + 248, *bmin.astype(np.float32))
    struct.pack_into("<f", buf, 296 + 260, 0.0)
    # world bbox + voxel size + class/type
    struct.pack_into("<6d", buf, 560, *bmin, *bmax)
    struct.pack_into("<3d", buf, 608, *vox)
    struct.pack_into("<II", buf, 632, _GRIDCLASS_FOG, _GRIDTYPE_FLOAT)

    # --- TreeData ---
    struct.pack_into(
        "<4Q", buf, tree_start,
        leaf_off, lower_off, upper_off, root_off,
    )
    struct.pack_into("<3I", buf, tree_start + 32, n_leaf, n_lower, n_upper)
    struct.pack_into("<Q", buf, tree_start + 56,
                     int(np.count_nonzero(density)))

    # --- RootData + tiles ---
    rb = tree_start + root_off
    struct.pack_into("<6i", buf, rb, 0, 0, 0, nx - 1, ny - 1, nz - 1)
    struct.pack_into("<I", buf, rb + 24, n_upper)
    struct.pack_into("<5f", buf, rb + 28, 0.0, float(density.min()),
                     float(density.max()), float(density.mean()),
                     float(density.std()))

    upper_list = sorted(upper_map)
    for ui, uo in enumerate(upper_list):
        toff = rb + _ROOT_BYTES + ui * _ROOT_TILE_BYTES
        child_rel = (upper_off + ui * _UPPER_BYTES) - root_off  # from root
        struct.pack_into("<Qq I f", buf, toff,
                         _coord_key(uo[0], uo[1], uo[2]), child_rel, 0, 0.0)

    lower_list = []
    for uo in upper_list:
        lower_list.extend(sorted(upper_map[uo]))
    lower_index = {o: i for i, o in enumerate(lower_list)}
    leaf_list = []
    for lo in lower_list:
        leaf_list.extend(sorted(lower_map[lo]))
    leaf_index = {o: i for i, o in enumerate(leaf_list)}

    # --- upper internal nodes (32^3 children of 128^3 lowers) ---
    for ui, uo in enumerate(upper_list):
        nb = tree_start + upper_off + ui * _UPPER_BYTES
        struct.pack_into("<6i", buf, nb, *uo,
                         uo[0] + 4095, uo[1] + 4095, uo[2] + 4095)
        child_mask = np.zeros(_UPPER_TABLE // 8, np.uint8)
        table = np.zeros(_UPPER_TABLE, np.int64)
        for lo in upper_map[uo]:
            ix = (lo[0] - uo[0]) >> 7
            iy = (lo[1] - uo[1]) >> 7
            iz = (lo[2] - uo[2]) >> 7
            n = (ix << 10) | (iy << 5) | iz  # x-major, z minor
            child_mask[n >> 3] |= 1 << (n & 7)
            li = lower_index[lo]
            table[n] = (lower_off + li * _LOWER_BYTES) - (
                upper_off + ui * _UPPER_BYTES
            )  # relative to this node
        mask_off = nb + 32
        buf[mask_off + _UPPER_TABLE // 8: mask_off + _UPPER_TABLE // 4] = (
            child_mask.tobytes()
        )
        tb = nb + _pad(_UPPER_HDR)
        buf[tb:tb + 8 * _UPPER_TABLE] = table.tobytes()

    # --- lower internal nodes (16^3 children of 8^3 leaves) ---
    for li, lo in enumerate(lower_list):
        nb = tree_start + lower_off + li * _LOWER_BYTES
        struct.pack_into("<6i", buf, nb, *lo,
                         lo[0] + 127, lo[1] + 127, lo[2] + 127)
        child_mask = np.zeros(_LOWER_TABLE // 8, np.uint8)
        table = np.zeros(_LOWER_TABLE, np.int64)
        for o in lower_map[lo]:
            ix = (o[0] - lo[0]) >> 3
            iy = (o[1] - lo[1]) >> 3
            iz = (o[2] - lo[2]) >> 3
            n = (ix << 8) | (iy << 4) | iz
            child_mask[n >> 3] |= 1 << (n & 7)
            fi = leaf_index[o]
            table[n] = (leaf_off + fi * _LEAF_BYTES) - (
                lower_off + li * _LOWER_BYTES
            )
        mask_off = nb + 32
        buf[mask_off + _LOWER_TABLE // 8: mask_off + _LOWER_TABLE // 4] = (
            child_mask.tobytes()
        )
        tb = nb + _pad(_LOWER_HDR)
        buf[tb:tb + 8 * _LOWER_TABLE] = table.tobytes()

    # --- leaves ---
    for fi, o in enumerate(leaf_list):
        nb = tree_start + leaf_off + fi * _LEAF_BYTES
        struct.pack_into("<3i", buf, nb, *o)
        buf[nb + 12:nb + 15] = bytes([7, 7, 7])  # bbox dif
        block = np.zeros((8, 8, 8), np.float32)
        src = density[o[2]:o[2] + 8, o[1]:o[1] + 8, o[0]:o[0] + 8]
        block[: src.shape[0], : src.shape[1], : src.shape[2]] = src
        # value mask: all voxels active within clip
        struct.pack_into("<8Q", buf, nb + 16, *([0xFFFFFFFFFFFFFFFF] * 8))
        vb = nb + _pad(_LEAF_HDR)
        # NanoVDB leaf values are x-major: idx = (x<<6)|(y<<3)|z
        vals = np.transpose(block, (2, 1, 0)).reshape(-1)
        buf[vb:vb + 4 * _LEAF_VOX] = vals.tobytes()

    codec_id = {"none": 0, "zip": 1}[codec]
    blob = bytes(buf)
    if codec_id == 1:
        import zlib

        # Published ZIP framing (nanovdb/util/IO.h): a u64 compressed
        # byte count precedes the zlib stream, and fileSize covers both.
        z = zlib.compress(blob)
        blob = struct.pack("<Q", len(z)) + z

    with open(path, "wb") as f:
        # FileHeader {magic u64, version u32, gridCount u16, codec u16}
        # + one FileMetaData record at the PUBLISHED v32.3 offsets
        # (nanovdb/util/IO.h): gridSize@0 fileSize@8 nameKey@16
        # voxelCount@24 gridType@32 gridClass@36 worldBBox@40
        # indexBBox@88 voxelSize@112 nameSize@136 nodeCount[4]@140
        # tileCount[3]@156 codec@168 version@172; then name, then blob.
        f.write(struct.pack("<QIHH", NANOVDB_MAGIC, version, 1, codec_id))
        meta = bytearray(176)
        struct.pack_into("<QQQQ", meta, 0, grid_size, len(blob), 0,
                         int(np.count_nonzero(density)))
        struct.pack_into("<II", meta, 32, _GRIDTYPE_FLOAT, _GRIDCLASS_FOG)
        struct.pack_into("<6d", meta, 40, *bmin, *bmax)
        struct.pack_into("<6i", meta, 88, 0, 0, 0, nx - 1, ny - 1, nz - 1)
        struct.pack_into("<3d", meta, 112, *vox)
        struct.pack_into("<I", meta, 136, len(name) + 1)  # nameSize
        struct.pack_into("<4I", meta, 140, n_leaf, n_lower, n_upper, 1)
        struct.pack_into("<HH", meta, 168, codec_id, 0)
        struct.pack_into("<I", meta, 172, version)
        f.write(bytes(meta))
        f.write(name + b"\0")
        f.write(blob)


def load_nvdb_dense(path, max_dim=256):
    """Decode a NanoVDB float grid (codec NONE or ZIP) into a
    dense [D,H,W] array + world bbox — the ingestion counterpart of the
    reference's grid upload (grid_loader_device.cu role).

    Walks root tiles -> upper (32^3) -> lower (16^3) -> leaf (8^3)
    nodes.  Node strides come from TreeData's level offsets / counts,
    so minor alignment differences between nanovdb versions don't break
    the walk.  Raises for other codecs or non-float grids.
    """
    hdr = read_nvdb_header(path)
    if hdr["codec"] not in (0, 1):
        raise ValueError(
            "unsupported NanoVDB codec (only NONE and ZIP); convert "
            "offline to .npz via save_grid()"
        )
    with open(path, "rb") as f:
        data = f.read()
    # Segment parse at the published FileMetaData offsets (IO.h v32.3):
    # fileSize@8 = stored blob bytes, nameSize@136; blob follows name.
    file_size = struct.unpack_from("<Q", data, 16 + 8)[0]
    name_size = struct.unpack_from("<I", data, 16 + 136)[0]
    blob_start = 16 + 176 + name_size
    if hdr["codec"] == 1:
        import zlib

        # Published ZIP framing: u64 compressed-size prefix, then the
        # zlib stream (nanovdb/util/IO.h).  Fall back to the prefix-less
        # dialect this writer produced before the framing fix.
        csize = struct.unpack_from("<Q", data, blob_start)[0]
        try:
            g = memoryview(zlib.decompress(
                data[blob_start + 8:blob_start + 8 + csize]))
        except zlib.error:
            g = memoryview(zlib.decompress(
                data[blob_start:blob_start + file_size]))
    elif (blob_start + 8 <= len(data) and
          struct.unpack_from("<Q", data, blob_start)[0] == NANOVDB_MAGIC):
        g = memoryview(data)[blob_start:]
    else:
        # legacy fallback (files written before the meta fix): locate the
        # GridData blob by its repeated magic
        blob = data.find(struct.pack("<Q", NANOVDB_MAGIC), 8)
        if blob < 0:
            raise ValueError("no grid blob found")
        g = memoryview(data)[blob:]

    grid_size = struct.unpack_from("<Q", g, 32)[0]
    grid_type = struct.unpack_from("<I", g, 636)[0]
    if grid_type != _GRIDTYPE_FLOAT:
        raise ValueError(f"only float grids supported (type={grid_type})")
    wb = struct.unpack_from("<6d", g, 560)
    bmin = np.array(wb[:3], np.float32)
    bmax = np.array(wb[3:], np.float32)

    tree = _GRIDDATA_BYTES
    leaf_off, lower_off, upper_off, root_off = struct.unpack_from(
        "<4Q", g, tree
    )
    n_leaf, n_lower, n_upper = struct.unpack_from("<3I", g, tree + 32)
    if n_leaf == 0:
        return (np.zeros((1, 1, 1), np.float32), bmin, bmax)
    # strides derived from the layout, robust to padding differences
    upper_stride = (lower_off - upper_off) // max(n_upper, 1)
    lower_stride = (leaf_off - lower_off) // max(n_lower, 1)
    leaf_stride = (grid_size - tree - leaf_off) // n_leaf

    rb = tree + root_off
    bbox = struct.unpack_from("<6i", g, rb)
    table_size = struct.unpack_from("<I", g, rb + 24)[0]
    nx, ny, nz = bbox[3] + 1, bbox[4] + 1, bbox[5] + 1
    if max(nx, ny, nz) > max_dim:
        raise ValueError(f"grid {nx}x{ny}x{nz} exceeds max_dim={max_dim}")
    dense = np.zeros((nz, ny, nx), np.float32)

    def leaf_values(off):
        return np.frombuffer(g, np.float32, _LEAF_VOX,
                             off + leaf_stride - 4 * _LEAF_VOX)

    for ti in range(table_size):
        toff = rb + _ROOT_BYTES + ti * _ROOT_TILE_BYTES
        child_rel = struct.unpack_from("<q", g, toff + 8)[0]
        if child_rel <= 0:
            continue
        ub = rb + child_rel
        uo = struct.unpack_from("<3i", g, ub)
        utable = ub + upper_stride - 8 * _UPPER_TABLE
        ucmask = np.frombuffer(
            g, np.uint8, _UPPER_TABLE // 8, ub + 32 + _UPPER_TABLE // 8
        )
        uchildren = np.frombuffer(g, np.int64, _UPPER_TABLE, utable)
        for n in np.nonzero(np.unpackbits(ucmask, bitorder="little"))[0]:
            lb = ub + int(uchildren[n])
            lo = struct.unpack_from("<3i", g, lb)
            ltable = lb + lower_stride - 8 * _LOWER_TABLE
            lcmask = np.frombuffer(
                g, np.uint8, _LOWER_TABLE // 8, lb + 32 + _LOWER_TABLE // 8
            )
            lchildren = np.frombuffer(g, np.int64, _LOWER_TABLE, ltable)
            for m in np.nonzero(np.unpackbits(lcmask, bitorder="little"))[0]:
                fb = lb + int(lchildren[m])
                fo = struct.unpack_from("<3i", g, fb)
                vals = leaf_values(fb).reshape(8, 8, 8)  # x-major
                block = np.transpose(vals, (2, 1, 0))    # -> [z,y,x]
                z0, y0, x0 = fo[2], fo[1], fo[0]
                dz = min(8, nz - z0)
                dy = min(8, ny - y0)
                dx = min(8, nx - x0)
                if dz <= 0 or dy <= 0 or dx <= 0:
                    continue
                dense[z0:z0 + dz, y0:y0 + dy, x0:x0 + dx] = (
                    block[:dz, :dy, :dx]
                )
    return dense, bmin, bmax


# -- procedural fixtures ---------------------------------------------------

def smoke_plume(res=64, seed=0):
    """Turbulent plume density in a unit box (the smoke-scene fixture,
    scenedefs smoke/homogeneous test analogue)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:res, 0:res, 0:res].astype(np.float32) / res
    r = np.sqrt((x - 0.5) ** 2 + (z - 0.5) ** 2)
    core = np.exp(-((r / (0.12 + 0.25 * y)) ** 2)) * (y < 0.95)
    # cheap turbulence: sum of random-phase cosines
    turb = np.zeros_like(core)
    for k in range(1, 4):
        f = 2.0 ** k
        px, py, pz = rng.uniform(0, 2 * np.pi, 3)
        turb += np.cos(2 * np.pi * f * x + px) * np.cos(
            2 * np.pi * f * y + py
        ) * np.cos(2 * np.pi * f * z + pz) / f
    d = core * np.clip(0.7 + 0.6 * turb, 0.0, 2.0) * np.clip(1.2 - y, 0, 1)
    return np.clip(d, 0.0, None).astype(np.float32)


def sphere_shell(res=48, r0=0.3, r1=0.45):
    z, y, x = (np.mgrid[0:res, 0:res, 0:res].astype(np.float32) + 0.5) / res
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return ((r > r0) & (r < r1)).astype(np.float32)


def add_grid_medium(builder, density, bmin, bmax, sigma_s=(1.0, 1.0, 1.0),
                    sigma_a=(0.1, 0.1, 0.1), g=0.0, le=(0, 0, 0),
                    boundary_mtl=None):
    """Register a heterogeneous medium AND its proxy boundary box.

    The reference turns the grid bbox into proxy triangles so BVH
    traversal delivers rays into the medium (grid_host.cpp:15-120); here
    the proxy is an ior=1 refraction box (null boundary) whose material
    carries the medium id.  Returns (medium_id, material_id).
    """
    from aten_tpu_torch.scene.materials import MaterialType
    from aten_tpu_torch.scene.scenedefs import _add_box

    mid = builder.add_medium(
        sigma_a=sigma_a, sigma_s=sigma_s, g=g, le=le,
        grid=density, grid_bmin=bmin, grid_bmax=bmax,
    )
    if boundary_mtl is None:
        boundary_mtl = builder.add_material(
            MaterialType.REFRACTION, base_color=(1, 1, 1), ior=1.0,
            medium=mid,
        )
    _add_box(builder, tuple(np.asarray(bmin, np.float32)),
             tuple(np.asarray(bmax, np.float32)), boundary_mtl)
    return mid, boundary_mtl
