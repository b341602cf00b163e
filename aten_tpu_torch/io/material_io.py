"""Material files: load (XML and JSON) and export (XML).

Counterpart of aten_tpu/io/material_io.py, with the same schema: a
<root> of <material> elements, each with <name>, <type> and parameter
children, for example

    <root><material>
      <name>body</name><type>diffuse</type>
      <baseColor>1 1 1</baseColor>
      <albedoMap>body_01.tga</albedoMap>
    </material>...</root>

JSON holds the same fields as a list of objects (or {"materials":
[...]}).  Texture paths are resolved against a base directory and
loaded once per file through io/image.py.
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

from aten_tpu_torch.io.image import load_texture
from aten_tpu_torch.scene.materials import MaterialType

_TYPE_NAMES = {
    "emissive": MaterialType.EMISSIVE,
    "diffuse": MaterialType.DIFFUSE,
    "lambert": MaterialType.DIFFUSE,
    "ornenayar": MaterialType.OREN_NAYAR,
    "oren_nayar": MaterialType.OREN_NAYAR,
    "specular": MaterialType.SPECULAR,
    "mirror": MaterialType.SPECULAR,
    "refraction": MaterialType.REFRACTION,
    "ggx": MaterialType.GGX,
    "microfacet_ggx": MaterialType.GGX,
    "beckman": MaterialType.BECKMANN,
    "beckmann": MaterialType.BECKMANN,
    "microfacet_refraction": MaterialType.MICROFACET_REFRACTION,
    "velvet": MaterialType.VELVET,
    "retroreflective": MaterialType.RETROREFLECTIVE,
    "carpaint": MaterialType.CAR_PAINT,
    "disney_brdf": MaterialType.DISNEY,
    "disney": MaterialType.DISNEY,
    "toon": MaterialType.TOON,
}
_NAME_OF_TYPE = {}
for k, v in _TYPE_NAMES.items():
    _NAME_OF_TYPE.setdefault(int(v), k)

# XML/JSON field -> MaterialTable.add kwarg (scalar passthroughs keep
# their name).
_VEC_FIELDS = {"baseColor": "base_color", "base_color": "base_color"}
_MAP_FIELDS = {
    "albedoMap": "albedo_map",
    "albedo_map": "albedo_map",
    "normalMap": "normal_map",
    "normal_map": "normal_map",
    "roughnessMap": "roughness_map",
    "roughness_map": "roughness_map",
}
_SCALAR_ALIASES = {
    "ior": "ior", "roughness": "roughness", "shininess": "shininess",
    "metallic": "metallic", "subsurface": "subsurface",
    "specular": "specular", "specularTint": "specular_tint",
    "anisotropic": "anisotropic", "sheen": "sheen",
    "sheenTint": "sheen_tint", "clearcoat": "clearcoat",
    "clearcoatGloss": "clearcoat_gloss",
}


def _parse_entry(fields, builder, base_dir, tex_cache):
    name = fields.pop("name", None)
    tname = str(fields.pop("type", "diffuse")).lower()
    mtype = _TYPE_NAMES.get(tname)
    if mtype is None:
        raise ValueError(f"unknown material type '{tname}'")
    kw = {}
    for k, v in fields.items():
        if k in _VEC_FIELDS:
            if isinstance(v, str):
                v = [float(x) for x in v.split()]
            kw[_VEC_FIELDS[k]] = tuple(v)
        elif k in _MAP_FIELDS:
            path = os.path.join(base_dir, v) if base_dir else v
            if path not in tex_cache:
                srgb = _MAP_FIELDS[k] == "albedo_map"
                tex_cache[path] = load_texture(builder, path, srgb_to_linear=srgb)
            kw[_MAP_FIELDS[k]] = tex_cache[path]
        elif k in _SCALAR_ALIASES:
            kw[_SCALAR_ALIASES[k]] = float(v)
        # unknown fields are skipped (reference warns and continues)
    mid = builder.add_material(mtype, **kw)
    return name, mid


def load_materials_xml(builder, path, base_dir=None):
    """Parse a reference-schema material XML; returns {name: mtl_id}."""
    if base_dir is None:
        base_dir = os.path.dirname(path)
    root = ET.parse(path).getroot()
    out = {}
    cache = {}
    for el in root.findall("material"):
        fields = {c.tag: (c.text or "").strip() for c in el}
        name, mid = _parse_entry(fields, builder, base_dir, cache)
        out[name or f"material_{mid}"] = mid
    return out


def load_materials_json(builder, path, base_dir=None):
    """JSON variant: a list of {name, type, ...} objects (or {"materials":
    [...]})."""
    if base_dir is None:
        base_dir = os.path.dirname(path)
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("materials", [])
    out = {}
    cache = {}
    for fields in data:
        name, mid = _parse_entry(dict(fields), builder, base_dir, cache)
        out[name or f"material_{mid}"] = mid
    return out


def export_materials_xml(path, materials, names=None):
    """MaterialExporter counterpart: write MaterialTable rows back to the
    reference XML schema. `materials` is a MaterialTable (or .rows)."""
    rows = getattr(materials, "rows", materials)
    root = ET.Element("root")
    for i, r in enumerate(rows):
        el = ET.SubElement(root, "material")
        ET.SubElement(el, "name").text = (
            names[i] if names else f"material_{i}"
        )
        ET.SubElement(el, "type").text = _NAME_OF_TYPE[int(r["type"])]
        ET.SubElement(el, "baseColor").text = " ".join(
            f"{c:g}" for c in r["base_color"]
        )
        for k in ("ior", "roughness", "metallic"):
            if k in r:
                ET.SubElement(el, k).text = f"{r[k]:g}"
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="unicode", xml_declaration=True)
