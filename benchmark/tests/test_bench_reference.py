"""The plain reference against the program (aten_tpu_torch) on the CPU, at
a small size, through a whole run of each cell (the card's look skipped)."""
import time

import numpy as np
import pytest
import torch

from bench_cells import CELLS, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program(name):
    from benchmark import harness

    w, c = small_cell(name)
    result, compared, _ = harness.run_cell(name, 2**31 + 11, 0.0, False, "cpu", time.time(),
                                           workload=w, config=c)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0
    # the same arithmetic on the same device: equal to the last bit here
    assert all(v <= 1e-6 for _, v, _ in compared), compared
    assert set(result["metrics"]) >= {"setup_s"}


def _program_arrays(scene):
    out = {}
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_uv0", "tri_mtl", "tri_light",
              "sph_center", "sph_radius", "sph_mtl", "bg"):
        out[k] = scene[k].numpy()
    for group in ("materials", "lights"):
        for k, v in scene[group].items():
            out[f"{group}.{k}"] = v.numpy()
    for k in ("envmap", "env_weight", "env_payload"):
        if k in scene:
            out[k] = scene[k].numpy()
    return out


@pytest.mark.parametrize("config", ["knot102k", "mtrl_zoo_ibl"])
def test_config_is_the_scene_function(config):
    """A configuration's description builds the scene of the program's own
    scene function that it names."""
    from aten_tpu_torch.scene import scenedefs

    from benchmark import harness
    from benchmark.entries.render import program_scene

    c = harness.load_json(f"{harness.ROOT}/benchmark/configs/{config}.json")
    if config == "knot102k":
        want, _ = scenedefs.procedural_mesh_scene(8, 8, n_u=400, n_v=128, device="cpu")
    else:
        want, _ = scenedefs.material_test_scene(8, 8, envmap=scenedefs.sky_envmap(64, 128),
                                                device="cpu")
    got, prims = program_scene(c, "cpu")
    assert prims == c["prims"] == want["num_tris"] + want["num_spheres"]
    a, b = _program_arrays(got), _program_arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.static == want.static


def test_reference_walk_is_brute_force():
    """The reference's tree walk finds the closest hit a test of every prim
    finds, on random rays through the small knot and the zoo."""
    from benchmark.compare import reference_scene
    from benchmark.reference import walk

    for name in ("knot102k.render_720p", "mtrl_zoo_ibl.render_512"):
        _, c = small_cell(name)
        scene = reference_scene(c, "cpu", torch.float32)
        g = torch.Generator().manual_seed(3)
        ro = torch.rand(512, 3, generator=g) * torch.tensor([8.0, 4.0, 8.0]) - \
            torch.tensor([4.0, 0.5, 4.0])
        rd = torch.nn.functional.normalize(torch.randn(512, 3, generator=g), dim=-1)
        t0 = torch.full((512,), 1e30)
        hit = walk.walk(scene, ro, rd, t0, 1e-4)
        n_t, n_s = scene["num_tris"], scene["num_spheres"]
        best_t = torch.full((512,), 1e30)
        best_p = torch.full((512,), -1, dtype=torch.int64)
        for p in range(n_t + n_s):
            if p < n_t:
                idx = torch.full((512,), p)
                t, _, _, h = walk._moller_trumbore(rd, ro, scene["tri_v0"][idx],
                                                   scene["tri_e1"][idx], scene["tri_e2"][idx],
                                                   1e-4)
            else:
                idx = torch.full((512,), p - n_t)
                t, h = walk._sphere(rd, ro, scene["sph_center"][idx], scene["sph_radius"][idx],
                                    1e-4)
            closer = h & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            best_p = torch.where(closer, p, best_p)
        assert torch.equal(hit["t"], best_t)
        assert (hit["prim"] >= 0).sum() > 50
        same = hit["prim"] == best_p
        assert same.float().mean() > 0.99  # ties at shared edges may differ
