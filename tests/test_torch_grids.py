"""Density-grid ingestion (`aten_tpu_torch/volume/grids.py`) and the
medium table (`volume/medium.py::MediumTable`) against aten_tpu.

* The committed `tests/fixtures/smoke8_zip.nvdb` (ZIP codec) decodes
  through the port bitwise to `smoke8_dens.npy`, with its box.
* The port's `write_nvdb` writes the reference's bytes, with the NONE
  and the ZIP codec, and reads them back bitwise (a dense plume and a
  sparse grid whose sides are not multiples of 8).
* Garbage headers are refused; a bare valid header parses.
* The procedural fixtures and the .npz round trip bitwise the
  reference's; `MediumTable`'s rows, padded density stack and brick
  majorants for `smoke_plume(16)` and `sphere_shell(16)` bitwise.
* tests/test_grids.py's render checks on the port: a grid registered
  with `add_grid_medium`, and one read from an .nvdb, absorb behind
  their proxy box.
"""
import os
import struct

import jax
import numpy as np
import pytest
import torch

from aten_tpu.volume import grids as jgrids
from aten_tpu.volume.medium import MediumTable as JaxMediumTable
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator.volpt import render_volpt
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder
from aten_tpu_torch.volume import grids
from aten_tpu_torch.volume.medium import MediumTable

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def test_committed_zip_fixture_decodes_bitwise():
    path = os.path.join(FIXTURES, "smoke8_zip.nvdb")
    assert grids.read_nvdb_header(path)["codec"] == 1
    dens, lo, hi = grids.load_nvdb_dense(path)
    ref = np.load(os.path.join(FIXTURES, "smoke8_dens.npy"))
    assert dens.dtype == ref.dtype
    np.testing.assert_array_equal(dens, ref)
    np.testing.assert_array_equal(lo, np.float32([-1, -1, -1]))
    np.testing.assert_array_equal(hi, np.float32([1, 1, 1]))


def _sparse():
    rng = np.random.default_rng(3)
    d = np.zeros((21, 14, 35), np.float32)
    d[2:9, 3:11, 20:33] = rng.uniform(0.1, 2.0, (7, 8, 13)).astype(np.float32)
    return d


@pytest.mark.parametrize("codec", ["none", "zip"])
@pytest.mark.parametrize("grid", ["plume", "sparse"])
def test_write_nvdb_gives_the_reference_bytes(tmp_path, codec, grid):
    d = grids.smoke_plume(res=32) if grid == "plume" else _sparse()
    box = {"bmin": (-1.5, 0.0, -1.5), "bmax": (1.5, 3.0, 1.5)} if grid == "plume" else {}
    mine, theirs = str(tmp_path / "port.nvdb"), str(tmp_path / "ref.nvdb")
    grids.write_nvdb(mine, d, codec=codec, **box)
    jgrids.write_nvdb(theirs, d, codec=codec, **box)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    h = grids.read_nvdb_header(mine)
    assert h == jgrids.read_nvdb_header(theirs)
    assert h["grid_count"] == 1 and h["codec"] == {"none": 0, "zip": 1}[codec]
    got, lo, hi = grids.load_nvdb_dense(mine)
    want, jlo, jhi = jgrids.load_nvdb_dense(theirs)
    np.testing.assert_array_equal(got, d)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)


def test_garbage_headers_are_refused(tmp_path):
    p = tmp_path / "x.nvdb"
    p.write_bytes(b"not a nanovdb file at all")
    with pytest.raises(ValueError):
        grids.read_nvdb_header(str(p))
    short = tmp_path / "short.nvdb"
    short.write_bytes(b"NanoVDB")
    with pytest.raises(ValueError):
        grids.read_nvdb_header(str(short))
    with pytest.raises(ValueError):
        grids.load_nvdb_dense(str(p))
    odd = tmp_path / "codec.nvdb"
    odd.write_bytes(struct.pack("<QIHH", grids.NANOVDB_MAGIC, 32 << 21, 1, 7))
    with pytest.raises(ValueError):
        grids.load_nvdb_dense(str(odd))
    ok = tmp_path / "y.nvdb"
    ok.write_bytes(struct.pack("<QIHH", 0x304244566F6E614E, 32 << 21, 1, 0))
    h = grids.read_nvdb_header(str(ok))
    assert h["grid_count"] == 1 and h["codec"] == 0


def test_procedural_grids_and_npz_match_reference(tmp_path):
    for res in (16, 33):
        np.testing.assert_array_equal(grids.smoke_plume(res), jgrids.smoke_plume(res))
        np.testing.assert_array_equal(grids.sphere_shell(res), jgrids.sphere_shell(res))
    d = grids.smoke_plume(res=16)
    p = str(tmp_path / "g.npz")
    grids.save_grid(p, d, (-1, 0, -1), (1, 2, 1))
    for load in (grids.load_grid, jgrids.load_grid):
        d2, lo, hi = load(p)
        np.testing.assert_array_equal(d2, d)
        np.testing.assert_array_equal(lo, np.float32([-1, 0, -1]))
        np.testing.assert_array_equal(hi, np.float32([1, 2, 1]))


def test_medium_table_matches_reference():
    """Rows, padded stack and brick majorants bitwise, two grids of
    different sizes and a homogeneous medium; the reference's staged
    corner rows are the one array the port does not make."""
    tables = (MediumTable(), JaxMediumTable())
    for t in tables:
        t.add(sigma_a=(0.2, 0.1, 0.3), sigma_s=(1, 2, 3), g=0.3, grid=grids.smoke_plume(16),
              grid_bmin=(-1, 0, -1), grid_bmax=(1, 2, 1))
        t.add(sigma_a=(0.05,) * 3, sigma_s=(0.8,) * 3, g=-0.2, le=(0.1, 0.0, 0.0))
        t.add(grid=grids.sphere_shell(16)[:13, :16, :11], grid_bmin=(0, 0, 0),
              grid_bmax=(2, 3, 1))
    got = tables[0].numpy_arrays()
    want = jax.tree_util.tree_map(np.asarray, tables[1].arrays())
    assert set(want) - set(got) == {"grid_corners"}
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert got["grid_brickmax"].shape == (2, 4, 4, 4)
    # a homogeneous table has rows only
    h = (MediumTable(), JaxMediumTable())
    for t in h:
        t.add()
    got, want = h[0].numpy_arrays(), h[1].arrays()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


def _shell_scene(density, lo, hi, size):
    sb = SceneBuilder()
    lm = sb.add_material(MaterialType.EMISSIVE, base_color=(2, 2, 2))
    sb.add_quad((-6, -6, -4), (6, -6, -4), (6, 6, -4), (-6, 6, -4), lm)
    mid, mtl = grids.add_grid_medium(sb, density, lo, hi, sigma_s=(0.1,) * 3,
                                     sigma_a=(3.0,) * 3)
    assert (mid, mtl) == (0, 1)
    cam = PinholeCamera(origin=(0, 0, 6), lookat=(0, 0, 0), vfov_deg=30, width=size,
                        height=size)
    return sb.build("cpu"), cam


def test_add_grid_medium_routes_rays():
    """tests/test_grids.py's check on the port: the proxy box routes
    rays into the absorbing shell, darker through it than around it."""
    sc, cam = _shell_scene(grids.sphere_shell(res=24) * 8.0, (-1, -1, -1), (1, 1, 1), 24)
    assert sc["num_tris"] == 2 + 12
    img = render_volpt(sc, cam, spp=8, max_depth=4).numpy()
    assert np.isfinite(img).all()
    assert img[12, 12].mean() < img[1, 1].mean() * 0.9


def test_nvdb_renders_through_volpt(tmp_path):
    """tests/test_grids.py's check on the port: a grid read from an
    .nvdb drives the delta-tracked medium."""
    p = str(tmp_path / "shell.nvdb")
    grids.write_nvdb(p, grids.sphere_shell(res=16) * 6.0, bmin=(-1, -1, -1), bmax=(1, 1, 1))
    d2, lo, hi = grids.load_nvdb_dense(p)
    sc, cam = _shell_scene(d2, lo, hi, 16)
    img = render_volpt(sc, cam, spp=4, max_depth=4).numpy()
    assert np.isfinite(img).all()
    assert img[8, 8].mean() < img[1, 1].mean()
