"""aten_tpu_torch's file I/O against aten_tpu's: Radiance HDR, LDR
images, material files, the OBJ writer and loader, the asset scenes of
scenedefs (from small files written here, with both packages'
REF_ASSET_DIR pointed at them) and `SceneBuilder.build(bvh_cache=)`.

Every file is written from a seed with numpy; both packages read the
same file, and their outputs are held bitwise (bytes written, arrays
read, scene tables built)."""
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_bvh_scene import _assert_tables_equal, reference_native  # noqa: F401

from aten_tpu.io import hdr as jhdr
from aten_tpu.io import image as jimage
from aten_tpu.io import material_io as jmio
from aten_tpu.io import obj_writer as jow
from aten_tpu.scene import objloader as jobj
from aten_tpu.scene import scenedefs as jdefs
from aten_tpu.scene.materials import MaterialType as JMT
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.io import hdr, image, material_io, obj_writer
from aten_tpu_torch.ops import bvh_layout
from aten_tpu_torch.scene import objloader, scenedefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import BVH_KEYS, SceneBuilder, save_bvh_cache

torch.set_num_threads(1)


def _hdr_image(seed=2, h=17, w=23):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(0, 1, (h, w, 3)) ** 2 * 10.0).astype(np.float32)
    img[3:6] = 2.0  # constant rows exercise RLE runs
    img[:, 10:14] = 0.0
    return img


@pytest.mark.parametrize("rle", [False, True])
def test_hdr_roundtrip_matches_reference(tmp_path, rle):
    img = _hdr_image()
    p, q = str(tmp_path / "port.hdr"), str(tmp_path / "ref.hdr")
    hdr.write_hdr(p, img, rle=rle)
    jhdr.write_hdr(q, img, rle=rle)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()
    back = hdr.read_hdr(p)
    ref = jhdr.read_hdr(p)  # float64, with values exact in float32
    np.testing.assert_array_equal(back, ref.astype(np.float32))
    np.testing.assert_array_equal(back.astype(ref.dtype), ref)
    assert back.dtype == np.float32 and back.shape == img.shape
    bound = img.max(axis=-1, keepdims=True) / 256.0 + 1e-3  # one shared exponent a pixel
    assert (np.abs(back - img) <= bound).all()
    np.testing.assert_array_equal(image.load_image(p), back)


def test_ldr_roundtrip_matches_reference(tmp_path):
    img = np.linspace(0, 1, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    p, q = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    image.save_image(p, img)
    jimage.save_image(q, img)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()
    for srgb in (True, False):
        back = image.load_image(p, srgb_to_linear=srgb)
        np.testing.assert_array_equal(back, jimage.load_image(p, srgb_to_linear=srgb))
    np.testing.assert_allclose(image.load_image(p), img, atol=0.01)


def test_ldr_without_pillow_names_the_file(tmp_path, monkeypatch):
    p = str(tmp_path / "albedo.png")
    image.save_image(p, np.zeros((2, 2, 3), np.float32))
    h = str(tmp_path / "sky.hdr")
    hdr.write_hdr(h, _hdr_image())
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="albedo.png: LDR images need Pillow"):
        image.load_image(p)
    with pytest.raises(ImportError, match="LDR images need Pillow"):
        image.save_image(str(tmp_path / "out.png"), np.zeros((2, 2, 3), np.float32))
    b = SceneBuilder()
    with pytest.raises(ImportError, match="albedo.png"):
        image.load_texture(b, p)
    assert image.load_texture(b, h) == 0  # .hdr needs no Pillow


_XML = """<?xml version="1.0"?>
<root>
  <material>
    <name>red_wall</name><type>diffuse</type>
    <baseColor>0.8 0.1 0.1</baseColor>
  </material>
  <material>
    <name>glass</name><type>refraction</type>
    <baseColor>1 1 1</baseColor><ior>1.7</ior>
  </material>
  <material>
    <name>metal</name><type>ggx</type>
    <baseColor>0.9 0.8 0.7</baseColor><roughness>0.15</roughness>
    <albedoMap>tex/albedo.png</albedoMap><normalMap>tex/nml.hdr</normalMap>
  </material>
  <material>
    <name>paint</name><type>disney_brdf</type><baseColor>0.5 0.2 0.1</baseColor>
    <metallic>0.3</metallic><clearcoatGloss>0.7</clearcoatGloss><sheenTint>0.2</sheenTint>
    <albedoMap>tex/albedo.png</albedoMap><unknownField>1</unknownField>
  </material>
</root>
"""


def _textures(tmp_path):
    os.makedirs(tmp_path / "tex", exist_ok=True)
    rng = np.random.default_rng(5)
    image.save_image(str(tmp_path / "tex" / "albedo.png"),
                     rng.uniform(0, 1, (4, 6, 3)).astype(np.float32))
    hdr.write_hdr(str(tmp_path / "tex" / "nml.hdr"), _hdr_image(6, 5, 9))


def _materials_equal(port_builder, ref_builder):
    assert len(port_builder.materials.rows) == len(ref_builder.materials.rows)
    for r, j in zip(port_builder.materials.rows, ref_builder.materials.rows):
        for k, v in j.items():
            assert r[k] == v, k
    assert len(port_builder.textures.images) == len(ref_builder.textures.images)
    for a, b in zip(port_builder.textures.images, ref_builder.textures.images):
        np.testing.assert_array_equal(a, b)


def test_material_xml_matches_reference(tmp_path):
    _textures(tmp_path)
    p = tmp_path / "m.xml"
    p.write_text(_XML)
    b, jb = SceneBuilder(), JaxSceneBuilder()
    ids = material_io.load_materials_xml(b, str(p))
    assert ids == jmio.load_materials_xml(jb, str(p))
    assert set(ids) == {"red_wall", "glass", "metal", "paint"}
    rows = b.materials.rows
    assert rows[ids["glass"]]["type"] == int(MaterialType.REFRACTION)
    assert rows[ids["glass"]]["ior"] == 1.7
    assert rows[ids["metal"]]["albedo_map"] == rows[ids["paint"]]["albedo_map"] == 0  # cached
    assert len(b.textures.images) == 2
    _materials_equal(b, jb)


def test_material_json_matches_reference(tmp_path):
    _textures(tmp_path)
    p = tmp_path / "m.json"
    p.write_text(
        '{"materials": [{"name": "d", "type": "disney", "baseColor": [0.5, 0.5, 0.5], '
        '"metallic": 0.8}, {"type": "velvet", "base_color": "0.2 0.3 0.4", "roughness": 0.6, '
        '"albedo_map": "tex/albedo.png"}]}')
    b, jb = SceneBuilder(), JaxSceneBuilder()
    ids = material_io.load_materials_json(b, str(p))
    assert ids == jmio.load_materials_json(jb, str(p))
    assert b.materials.rows[ids["d"]]["type"] == int(MaterialType.DISNEY)
    assert b.materials.rows[ids["d"]]["metallic"] == 0.8
    _materials_equal(b, jb)
    with pytest.raises(ValueError, match="unknown material type 'plastic'"):
        p.write_text('[{"type": "plastic"}]')
        material_io.load_materials_json(SceneBuilder(), str(p))


def test_material_export_import_matches_reference(tmp_path):
    b, jb = SceneBuilder(), JaxSceneBuilder()
    for builder, mt in ((b, MaterialType), (jb, JMT)):
        builder.add_material(mt.GGX, base_color=(0.2, 0.4, 0.6), roughness=0.3)
        builder.add_material(mt.DIFFUSE, base_color=(1.0, 0.5, 0.25))
        builder.add_material(mt.REFRACTION, base_color=(0.9, 0.9, 1.0), ior=1.33)
    p, q = tmp_path / "port.xml", tmp_path / "ref.xml"
    material_io.export_materials_xml(str(p), b.materials, names=["a", "b", "c"])
    jmio.export_materials_xml(str(q), jb.materials, names=["a", "b", "c"])
    assert p.read_text() == q.read_text()
    b2, jb2 = SceneBuilder(), JaxSceneBuilder()
    ids = material_io.load_materials_xml(b2, str(p))
    assert ids == jmio.load_materials_xml(jb2, str(p))
    assert b2.materials.rows[ids["a"]]["type"] == int(MaterialType.GGX)
    np.testing.assert_allclose(b2.materials.rows[ids["b"]]["base_color"], (1.0, 0.5, 0.25))
    _materials_equal(b2, jb2)


def _built_equal(port_builder, ref_builder):
    """Both builders' scenes, built on the CPU, hold the same tables."""
    ref = ref_builder.build()
    port = port_builder.build("cpu")
    _assert_tables_equal(ref.arrays, port.arrays)
    for k, v in port.static.items():
        assert ref.static[k] == v, k
    return port


def test_obj_write_load_roundtrip_matches_reference(tmp_path):
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3))
    nml = rng.standard_normal((40, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    face_mtl = rng.integers(0, 3, 60)
    b, jb = SceneBuilder(), JaxSceneBuilder()
    for builder, mt in ((b, MaterialType), (jb, JMT)):
        builder.add_material(mt.DIFFUSE, base_color=(0.3, 0.6, 0.9))
        builder.add_material(mt.GGX, base_color=(0.9, 0.6, 0.3), roughness=0.4, ior=1.8)
        builder.add_material(mt.DIFFUSE, base_color=(0.1, 0.2, 0.3))
    names = ["mat0", "shiny", "mat2"]
    files = {}
    for tag, w, builder in (("port", obj_writer, b), ("ref", jow, jb)):
        obj_p, mtl_p = str(tmp_path / f"{tag}.obj"), str(tmp_path / f"{tag}.mtl")
        w.write_mtl(mtl_p, builder.materials, names=names)
        w.write_obj(obj_p, pos, faces, nml=nml, uv=uv, face_mtl=face_mtl, mtl_names=names,
                    mtl_path=mtl_p)
        files[tag] = (open(obj_p).read(), open(mtl_p).read())
    # the same text but for the mtllib line, which names each file's own .mtl
    assert files["port"][0].replace("port.mtl", "ref.mtl") == files["ref"][0]
    assert files["port"][1] == files["ref"][1]
    lb, ljb = SceneBuilder(), JaxSceneBuilder()
    groups = objloader.load_obj(lb, str(tmp_path / "port.obj"))
    assert groups == jobj.load_obj(ljb, str(tmp_path / "port.obj"))
    assert sorted(groups) == sorted(names)
    scene = _built_equal(lb, ljb)
    assert scene["num_tris"] == 60
    assert lb.materials.rows[0]["type"] == int(MaterialType.DIFFUSE)
    np.testing.assert_allclose(lb.materials.rows[0]["base_color"], (0.3, 0.6, 0.9), atol=1e-6)


_OBJ = """# quads, a pentagon, negative indices, two groups and a default one
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0
v 0 0 1
v 1 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl lamp
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl glass
f -7/1/1 -6/2/1 -5/3/1 -3/4/1 -4/1/1
usemtl metal
f 1//2 6//2 7//2
usemtl mirror
f 2 7 3
usemtl textured
f 1/1 2/2 6/3
usemtl nomtl
f 4 5 3
"""
_MTL = """newmtl lamp
Ke 5 4 3
newmtl glass
Kd 0.9 0.9 1.0
Ni 1.45
d 0.5
newmtl metal
Kd 0.8 0.7 0.6
Ks 0.4 0.4 0.4
Ns 50
newmtl mirror
Ks 0.9 0.9 0.9
Ns 900
newmtl textured
Kd 1 1 1
map_Kd tex/albedo.png
map_bump tex/nml.hdr
# comment
"""


def test_load_obj_materials_and_textures_match_reference(tmp_path):
    _textures(tmp_path)
    (tmp_path / "scene.obj").write_text(_OBJ)
    (tmp_path / "scene.mtl").write_text(_MTL)
    path = str(tmp_path / "scene.obj")
    assert objloader.parse_mtl(str(tmp_path / "scene.mtl")) == jobj.parse_mtl(
        str(tmp_path / "scene.mtl"))
    for kw in ({}, {"scale": 2.5, "offset": (1.0, -2.0, 0.5)}):
        b, jb = SceneBuilder(), JaxSceneBuilder()
        groups = objloader.load_obj(b, path, **kw)
        assert groups == jobj.load_obj(jb, path, **kw)
        scene = _built_equal(b, jb)
        assert scene["num_tris"] == 2 + 3 + 1 + 1 + 1 + 1
        types = [r["type"] for r in b.materials.rows]
        assert types == [int(MaterialType.EMISSIVE), int(MaterialType.REFRACTION),
                         int(MaterialType.GGX), int(MaterialType.SPECULAR),
                         int(MaterialType.DIFFUSE), int(MaterialType.DIFFUSE)]
        assert b.materials.rows[4]["albedo_map"] == 0
        assert b.materials.rows[4]["normal_map"] == 1  # a map_bump named "nml" is one
        assert len(b.textures.images) == 2
    # the material callback
    b, jb = SceneBuilder(), JaxSceneBuilder()
    seen = []

    def override(builder, mt):
        def f(name, mtl):
            seen.append((name, sorted(mtl)))
            return builder.add_material(mt.DIFFUSE, base_color=(0.5, 0.5, 0.5))
        return f

    objloader.load_obj(b, path, mtl_override=override(b, MaterialType))
    jobj.load_obj(jb, path, mtl_override=override(jb, JMT))
    assert seen[:len(seen) // 2] == seen[len(seen) // 2:]
    _built_equal(b, jb)


def _knot_obj(path, n_u, n_v, mtl=None):
    pos, _, _, faces = scenedefs.torus_knot_mesh(n_u, n_v)
    obj_writer.write_obj(path, pos, faces)


_CORNELL_OBJ = """mtllib orig.mtl
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v -1 2 -1
v 1 2 -1
v 1 2 1
v -1 2 1
v -0.3 1.99 -0.3
v 0.3 1.99 -0.3
v 0.3 1.99 0.3
v -0.3 1.99 0.3
usemtl floor
f 1 4 3 2
usemtl ceiling
f 5 6 7 8
usemtl back
f 1 2 6 5
usemtl leftWall
f 1 5 8 4
usemtl rightWall
f 2 3 7 6
usemtl light
f 9 12 11 10
usemtl nomtl
f 3 4 8
"""
_CORNELL_MTL = """newmtl floor
Kd 0.73 0.73 0.73
newmtl ceiling
Kd 0.73 0.73 0.73
newmtl back
Kd 0.73 0.73 0.73
newmtl leftWall
Kd 0.63 0.065 0.05
newmtl rightWall
Kd 0.14 0.45 0.091
Ks 0.3 0.3 0.3
Ns 20
newmtl light
Kd 0.78 0.78 0.78
Ke 17 12 4
"""


def _assets(tmp_path):
    """A small stand-in of each asset the four scenes read."""
    for d in ("cornellbox", "dragon", "sponza", "crytek_sponza"):
        os.makedirs(tmp_path / d, exist_ok=True)
    (tmp_path / "cornellbox" / "orig.obj").write_text(_CORNELL_OBJ)
    (tmp_path / "cornellbox" / "orig.mtl").write_text(_CORNELL_MTL)
    _knot_obj(str(tmp_path / "dragon" / "dragon.obj"), 40, 25)
    (tmp_path / "sponza" / "sponza_lod.obj").write_text(
        _OBJ.replace("mtllib scene.mtl", "mtllib sponza_lod.mtl"))
    (tmp_path / "sponza" / "sponza_lod.mtl").write_text(_MTL.replace(
        "map_Kd tex/albedo.png\nmap_bump tex/nml.hdr\n", ""))
    image.save_image(str(tmp_path / "crytek_sponza" / "sponza_fabric_blue_diff.png"),
                     np.random.default_rng(3).uniform(0, 1, (8, 8, 3)).astype(np.float32))


@pytest.mark.parametrize("name", ["obj_cornell_box", "dragon_scene", "sponza_scene",
                                  "crytek_class_scene"])
def test_asset_scene_matches_reference(tmp_path, monkeypatch, reference_native, name):
    _assets(tmp_path)
    monkeypatch.setattr(scenedefs, "REF_ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(jdefs, "REF_ASSET_DIR", str(tmp_path))
    kw = {"dragons": 2} if name == "crytek_class_scene" else {}
    ref, rcam = getattr(jdefs, name)(48, 32, **kw)
    port, cam = getattr(scenedefs, name)(48, 32, device="cpu", **kw)
    _assert_tables_equal(ref.arrays, port.arrays)
    for k, v in port.static.items():
        assert ref.static[k] == v, k
    assert (cam.width, cam.height) == (rcam.width, rcam.height)
    for a in ("origin", "lookat", "vfov_deg"):
        assert getattr(cam, a) == getattr(rcam, a), a
    if name == "dragon_scene":
        assert port["num_tris"] == 2 * 40 * 25 + 4
    if name == "crytek_class_scene":
        assert port["has_albedo_maps"] and port["num_tris"] == 9 + 2 * 2000 + 4
    if name == "obj_cornell_box":
        assert port["num_lights"] == 1


def test_asset_scene_without_assets_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(scenedefs, "REF_ASSET_DIR", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        scenedefs.dragon_scene(8, 8, device="cpu")


def _bits_equal(a, b):
    """Tensors equal bit for bit (K1's records hold int words as floats)."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.contiguous().view(torch.uint8) == b.contiguous().view(torch.uint8)).all())


def _soup_builder(cls, mt, n=300, seed=0):
    rng = np.random.default_rng(seed)
    b = cls()
    m = b.add_material(mt.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    c = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tris = c[:, None, :] + rng.uniform(-0.4, 0.4, (n, 3, 3)).astype(np.float32)
    b.add_mesh(tris.reshape(-1, 3), np.arange(3 * n).reshape(-1, 3), m)
    b.add_sphere((0.0, 0.0, 0.0), 0.5, m)
    return b


def test_bvh_cache_that_matches_is_used(tmp_path):
    """A cache whose prim_order covers the scene's prims replaces the
    build: both packages take its tree, and the port's kernel layout is
    K1's records of that tree.  The cache here holds another valid tree of
    the same prims (the LBVH's, renumbered into preorder), so taking it
    shows in every node array."""
    from aten_tpu_torch.accel import lbvh

    built = _soup_builder(SceneBuilder, MaterialType).build("cpu")
    save_bvh_cache(built, str(tmp_path / "sah.npz"))
    with np.load(tmp_path / "sah.npz") as z:
        assert sorted(z.files) == sorted(BVH_KEYS)
    rebuilt = lbvh.rebuild_scene_bvh(built)
    pre = bvh_layout.lbvh_preorder({k: rebuilt[k] for k in BVH_KEYS}, lbvh.depth_bound(301))
    cache = str(tmp_path / "lbvh.npz")
    np.savez(cache, **{k: v.numpy() for k, v in pre.items()})
    port = _soup_builder(SceneBuilder, MaterialType).build("cpu", bvh_cache=cache)
    ref = _soup_builder(JaxSceneBuilder, JMT).build(bvh_cache=cache)
    for k in BVH_KEYS:
        np.testing.assert_array_equal(port[k].numpy(), pre[k].numpy(), err_msg=k)
    assert not np.array_equal(port["nodes_hit"].numpy(), built["nodes_hit"].numpy())
    _assert_tables_equal(ref.arrays, port.arrays)
    lay = bvh_layout.build_bvh_layout({k: pre[k].numpy() for k in BVH_KEYS},
                                      *(port[k].numpy() for k in ("tri_v0", "tri_e1", "tri_e2",
                                                                 "sph_center", "sph_radius")),
                                      port["num_tris"])
    for k in bvh_layout.ARRAY_KEYS:
        np.testing.assert_array_equal(port[k].numpy(), lay[k], err_msg=k)
    # the SAH cache of a build gives that build again
    again = _soup_builder(SceneBuilder, MaterialType).build("cpu", bvh_cache=str(tmp_path / "sah.npz"))
    for k in built.arrays:
        if isinstance(built[k], torch.Tensor):
            assert _bits_equal(again[k], built[k]), k


def test_bvh_cache_that_does_not_match_is_ignored(tmp_path):
    small = _soup_builder(SceneBuilder, MaterialType, n=40).build("cpu")
    cache = str(tmp_path / "small.npz")
    save_bvh_cache(small, cache)
    built = _soup_builder(SceneBuilder, MaterialType).build("cpu")
    for path in (cache, str(tmp_path / "absent.npz")):
        port = _soup_builder(SceneBuilder, MaterialType).build("cpu", bvh_cache=path)
        ref = _soup_builder(JaxSceneBuilder, JMT).build(bvh_cache=path)
        _assert_tables_equal(ref.arrays, port.arrays)
        for k in BVH_KEYS + bvh_layout.ARRAY_KEYS:
            assert _bits_equal(port[k], built[k]), k
