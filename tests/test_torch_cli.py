"""aten_tpu_torch's command-line tools against aten_tpu's: bvh_builder
(SAH and --spatial-splits), obj_tool (combine, separate),
envmap_converter, bump2normal and render, each run through both
packages' `main` on the same files under tmp_path.

The builder's .npz and the OBJ text are held bitwise (the same native
builder, the same writer); the converted images within 1e-6; the
path-traced Cornell box (16x16, 2 spp, depth 3, checkpointed and
resumed) within the golden bounds (max < 5e-3, mean < 5e-4), its
checkpoint read by the other package; the npr and volume branches run
end to end.  The port's tools run with --device cpu."""
import os

import numpy as np
import pytest
import torch
from test_sbvh import _long_tri_scene
from test_torch_bvh_scene import reference_native  # noqa: F401

from aten_tpu.cli import bump2normal as jb2n
from aten_tpu.cli import bvh_builder as jbvh
from aten_tpu.cli import envmap_converter as jenv
from aten_tpu.cli import obj_tool as jobj
from aten_tpu.cli import render as jrender
from aten_tpu.io import image as jimage
from aten_tpu_torch.cli import bump2normal, bvh_builder, envmap_converter, obj_tool, render
from aten_tpu_torch.io import hdr, image
from aten_tpu_torch.io.obj_writer import write_obj

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


@pytest.fixture
def sliver_obj(tmp_path):
    """The SBVH test's 300 slivers and small triangles as an OBJ."""
    tris = _long_tri_scene(300, seed=2)
    p = str(tmp_path / "slivers.obj")
    write_obj(p, tris.reshape(-1, 3), np.arange(900).reshape(-1, 3))
    return p, tris


@pytest.mark.parametrize("splits", [False, True], ids=["sah", "sbvh"])
def test_bvh_builder_matches_reference(tmp_path, sliver_obj, reference_native, splits):
    obj, tris = sliver_obj
    flag = ["--spatial-splits"] if splits else []
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    assert bvh_builder.main([obj, "-o", p, *flag]) == 0
    assert jbvh.main([obj, "-o", q, *flag]) == 0
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        order = a["prim_order"]
    assert set(order.tolist()) == set(range(len(tris)))
    assert (len(order) > len(tris)) == splits  # the slivers' references duplicate


def test_obj_tool_matches_reference(tmp_path):
    rng = np.random.default_rng(4)
    a, b = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    with open(a, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                "usemtl red\nf 1 2 3\nusemtl blue\nf 1 3 4\n")
    pos = rng.uniform(-1, 1, (9, 3)).round(3)
    with open(b, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in pos)
        f.write("usemtl blue\nf 1 2 3 4\nusemtl green\nf 5/1 6/2 7/3\nf 7 8 9\n")
    for tag, tool in (("port", obj_tool), ("ref", jobj)):
        assert tool.main(["combine", a, b, "-o", str(tmp_path / f"{tag}.obj")]) == 0
        assert tool.main(["separate", b, "-o", str(tmp_path / f"{tag}_sep")]) == 0
    with open(tmp_path / "port.obj") as f, open(tmp_path / "ref.obj") as g:
        merged = f.read()
        assert merged == g.read()
    assert merged.count("\nv ") == 13 and merged.count("usemtl") == 3
    files = sorted(os.listdir(tmp_path / "port_sep"))
    assert files == sorted(os.listdir(tmp_path / "ref_sep")) == ["b_blue.obj", "b_green.obj"]
    for name in files:
        with open(tmp_path / "port_sep" / name) as f, open(tmp_path / "ref_sep" / name) as g:
            assert f.read() == g.read(), name


def _captured(monkeypatch, module):
    """Arrays `module.save_image` is given (the files are written too)."""
    saved = []
    real = module.save_image

    def save(path, img):
        saved.append(np.asarray(img, np.float32))
        real(path, img)

    monkeypatch.setattr(module, "save_image", save)
    return saved


def _sky(path, h=32, w=64):
    rng = np.random.default_rng(6)
    img = np.tile(np.linspace(2.0, 0.1, h, dtype=np.float32)[:, None, None], (1, w, 3))
    img = img * rng.uniform(0.5, 1.5, (h, w, 3)).astype(np.float32)
    hdr.write_hdr(path, img)


@pytest.mark.parametrize("args", [["--to", "cross", "--width", "16"],
                                  ["--from", "mirrorball", "--width", "32"],
                                  ["--width", "48"]], ids=["cross", "mirrorball", "equirect"])
def test_envmap_converter_matches_reference(tmp_path, monkeypatch, args):
    src = str(tmp_path / "in.hdr")
    _sky(src)
    port = _captured(monkeypatch, image)
    ref = _captured(monkeypatch, jimage)
    assert envmap_converter.main([src, "-o", str(tmp_path / "p.hdr"), *args, *CPU]) == 0
    assert jenv.main([src, "-o", str(tmp_path / "r.hdr"), *args]) == 0
    assert port[0].shape == ref[0].shape
    np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=1e-6)
    assert port[0].max() > 0
    if "cross" in args:
        s = 16
        assert port[0][0:s, s:2 * s].mean() > port[0][2 * s:3 * s, s:2 * s].mean() * 2


def test_bump2normal_matches_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    h = np.tile(np.linspace(0, 1, 32, dtype=np.float32), (24, 1))
    h = h + rng.uniform(0, 0.2, h.shape).astype(np.float32)
    src = str(tmp_path / "h.hdr")
    hdr.write_hdr(src, np.stack([h, h, h], -1))
    port = _captured(monkeypatch, image)
    ref = _captured(monkeypatch, jimage)
    assert bump2normal.main([src, "-o", str(tmp_path / "p.hdr"), "--scale", "2", *CPU]) == 0
    assert jb2n.main([src, "-o", str(tmp_path / "r.hdr"), "--scale", "2"]) == 0
    np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=1e-6)
    hr = hdr.read_hdr(src).mean(-1)
    np.testing.assert_allclose(bump2normal.bump_to_normal(hr, 4.0).numpy(),
                               jb2n.bump_to_normal(hr, 4.0), rtol=0, atol=1e-6)


RENDER = ["--scene", "cornell", "--width", "16", "--height", "16", "--spp", "2",
          "--max-depth", "3"]


def test_render_cli_pt_checkpoint_matches_reference(tmp_path):
    """Both CLIs render 2 spp, save, resume and render 2 more; the films
    agree within the golden bounds, and each package resumes the other's
    checkpoint with its count and frame."""
    films = {}
    for tag, tool in (("port", render), ("ref", jrender)):
        ck = str(tmp_path / f"{tag}.npz")
        extra = CPU if tool is render else []
        for _ in range(2):
            assert tool.main([*RENDER, "-o", str(tmp_path / f"{tag}.hdr"), "--checkpoint", ck,
                              *extra]) == 0
        with np.load(ck) as z:
            assert sorted(z.files) == ["film/buf", "film/count", "frame"]
            assert int(z["film/count"]) == 4 and int(z["frame"]) == 2
            films[tag] = z["film/buf"]
    err = np.abs(films["port"] - films["ref"])
    assert err.max() < 5e-3 and err.mean() < 5e-4, (err.max(), err.mean())
    assert films["port"].mean() > 0.01
    # each package resumes the other's checkpoint: 2 more samples on top
    for tag, tool, other in (("port", render, "ref"), ("ref", jrender, "port")):
        extra = CPU if tool is render else []
        assert tool.main([*RENDER, "-o", str(tmp_path / "x.hdr"), "--checkpoint",
                          str(tmp_path / f"{other}.npz"), *extra]) == 0
        with np.load(tmp_path / f"{other}.npz") as z:
            assert int(z["film/count"]) == 6 and int(z["frame"]) == 3


@pytest.mark.parametrize("integrator", ["npr", "volume"])
def test_render_cli_other_integrators(tmp_path, integrator):
    scene = {"npr": "cornell", "volume": "volume"}[integrator]
    out = str(tmp_path / f"{integrator}.hdr")
    rc = render.main(["--scene", scene, "--integrator", integrator, "--width", "16",
                      "--height", "16", "--spp", "2", "--max-depth", "3", "-o", out, *CPU])
    assert rc == 0
    img = hdr.read_hdr(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the tools ask for the card, and without one they
    raise rather than fall back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        render.main([*RENDER, "-o", str(tmp_path / "x.hdr")])
    src = str(tmp_path / "in.hdr")
    _sky(src)
    for tool in (envmap_converter, bump2normal):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tool.main([src, "-o", str(tmp_path / "y.hdr")])
