"""aten_tpu_torch BVH build, scene build and bridge against aten_tpu.

`build_bvh` must return the reference's arrays exactly (NumPy path up to
512 prims, the C++ builder above), and `SceneBuilder.build()` /
`bridge.from_numpy` must hold the same tables as the reference SceneData.
K1's packed records (`bvh_nodes`, `bvh_prims`) are the port's own and
have no counterpart there; tests/test_torch_bvh_layout.py holds them to
the tables they pack.

`reference_native`, defined here, is the one guard of every port test
that builds a reference BVH above the native builder's 512-prim line;
the other test_torch_*.py files import it from this module.
"""
import os
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

from aten_tpu.accel import build as jbuild
from aten_tpu.accel import voxel as jvox
from aten_tpu.scene import scenedefs as jdefs
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch import native
from aten_tpu_torch.accel import build as tbuild
from aten_tpu_torch.ops import bvh_layout
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import envmap as tenv
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference_native():
    """The reference compiles native/libbvh.so in place at first use,
    with no lock (aten_tpu/accel/build.py:42-51).  A process that loads
    the file while another one writes it keeps "no native builder" for
    its life (:41, :72-73) and builds objects over 512 prims with NumPy,
    which gives the same nodes but another prim_order.  So build the file
    here first, with the reference's flags, into a temporary file moved
    into place at once, and retry the reference's load until it
    succeeds."""
    src = os.path.join(jbuild._NATIVE_DIR, "bvh_builder.cpp")
    so = os.path.join(jbuild._NATIVE_DIR, "libbvh.so")
    with native.build_lock("reference_libbvh"):
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-std=c++17", "-o", tmp, src],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
    for _ in range(60):
        if jbuild._load_native() is not None:
            return
        jbuild._native_tried = False
        time.sleep(1.0)
    pytest.fail("the reference's native BVH builder did not load")


pytestmark = pytest.mark.usefixtures("reference_native")


def _boxes(rng, n):
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - h, c + h


@pytest.mark.parametrize("n", [1, 5, 300, 512, 513, 3000])
def test_build_bvh_matches_reference(n):
    bmin, bmax = _boxes(np.random.default_rng(n), n)
    ref = jbuild.build_bvh(bmin, bmax)
    got = tbuild.build_bvh(bmin, bmax)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    assert got["nodes_prim_count"].max() <= tbuild.LEAF_MAX


def _reference_scene(name):
    """(reference SceneData, populate function args) for each scene."""
    if name == "cornell":
        return jdefs.cornell_box(64, 64)[0]
    b = JaxSceneBuilder()
    tdefs.populate_procedural_mesh_scene(b, 64, 64, n_u=48, n_v=16)
    return b.build()


def _port_scene(name):
    if name == "cornell":
        return tdefs.cornell_box(64, 64, device="cpu")[0]
    return tdefs.procedural_mesh_scene(64, 64, n_u=48, n_v=16, device="cpu")[0]


def _assert_tables_equal(ref_arrays, port_arrays, prefix=""):
    for k, v in port_arrays.items():
        if k in bvh_layout.ARRAY_KEYS:
            continue
        r = ref_arrays[k]
        if isinstance(v, dict):
            _assert_tables_equal(r, v, prefix + k + ".")
            continue
        r = np.asarray(r)
        got = v.numpy()
        assert got.shape == r.shape, prefix + k
        assert got.dtype == r.dtype, prefix + k
        np.testing.assert_array_equal(got, r, err_msg=prefix + k)


@pytest.mark.parametrize("name", ["cornell", "mesh1536"])
def test_scene_build_matches_reference(name):
    ref = _reference_scene(name)
    port = _port_scene(name)
    if name == "mesh1536":
        assert port["num_tris"] == 1536 + 4  # knot + floor and light quads
    _assert_tables_equal(ref.arrays, port.arrays)
    for k, v in port.static.items():
        assert ref.static[k] == v, k


@pytest.mark.parametrize("name", ["cornell", "mesh1536"])
def test_bridge_matches_reference_and_builder(name):
    ref = _reference_scene(name)
    arrays = jax.tree_util.tree_map(np.asarray, ref.arrays)
    via_bridge = bridge.from_numpy(arrays, ref.static, "cpu")
    _assert_tables_equal(ref.arrays, via_bridge.arrays)
    port = _port_scene(name)
    assert sorted(via_bridge.arrays) == sorted(port.arrays)
    assert via_bridge.static == port.static
    assert via_bridge.device == torch.device("cpu")


def test_bridge_rejects_unported_features():
    ref = jdefs.cornell_box(16, 16)[0]
    arrays = jax.tree_util.tree_map(np.asarray, ref.arrays)
    # an array the port does not know is refused
    with pytest.raises(NotImplementedError, match="not_a_scene_array"):
        bridge.from_numpy({**arrays, "not_a_scene_array": np.zeros((1, 3), np.float32)},
                          ref.static, "cpu")
    # media are ported (PR 14): their rows come across
    med = {"med_sigma_a": np.zeros((1, 3), np.float32), "med_sigma_s": np.ones((1, 3), np.float32),
           "med_g": np.zeros(1, np.float32), "med_le": np.zeros((1, 3), np.float32),
           "med_grid": np.full(1, -1, np.int32)}
    via = bridge.from_numpy({**arrays, **med}, ref.static, "cpu")
    for k, v in med.items():
        np.testing.assert_array_equal(via[k].numpy(), v)
    # voxel LOD is ported: the annotation and lod_depth come across, with
    # K1's records of the tree the port bakes from them
    jb = JaxSceneBuilder()
    tdefs.populate_procedural_mesh_scene(jb, 16, 16, n_u=24, n_v=12)
    lod = jvox.enable_voxel_lod(jb.build(), lod_depth=3)
    via = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, lod.arrays), lod.static, "cpu")
    assert via["has_voxel_lod"] and via["lod_bake_depth"] == 3 and int(via["lod_depth"]) == 3
    for k in ("nodes_voxel_mtl", "nodes_depth"):
        np.testing.assert_array_equal(via[k].numpy(), np.asarray(lod[k]))
    assert not any(k.startswith("trl_") for k in via.arrays)
    word = bvh_layout.unpack_nodes(via["bvh_nodes"].numpy())[4]
    assert (word <= -2).sum() > 0  # voxel leaves in the baked records
    # envmaps and textures are ported: their arrays come across
    both = bridge.from_numpy({**arrays, **tenv.build_env_tables(np.ones((2, 4, 3), np.float32))},
                             ref.static, "cpu")
    assert both["envmap"].shape == (2, 4, 3)


def test_builder_rejects_unported_features():
    b = SceneBuilder()
    with pytest.raises(TypeError, match="not_a_field"):
        b.add_material(MaterialType.DIFFUSE, not_a_field=1.0)
    # media are ported (PR 14): a material carrying one builds
    assert b.add_medium(sigma_a=(1.0, 1.0, 1.0)) == 0
    b.add_material(MaterialType.DIFFUSE, medium=0)
    b.add_quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], 0)
    scene = b.build("cpu")
    assert int(scene["materials"]["medium"][0]) == 0
    np.testing.assert_array_equal(scene["med_sigma_a"].numpy(), [[1.0, 1.0, 1.0]])
    # envmaps and textures are ported: they build
    b = SceneBuilder()
    tex = b.add_texture(np.ones((4, 4, 4), np.float32))
    b.add_material(MaterialType.DIFFUSE, albedo_map=tex)
    b.add_quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], 0)
    b.set_envmap(np.ones((4, 8, 3), np.float32))
    scene = b.build("cpu")
    assert scene["has_albedo_maps"] and "envmap" in scene and scene["num_lights"] == 1


def test_cuda_device_without_card_raises():
    from aten_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            tdefs.cornell_box(8, 8, device="cuda")
