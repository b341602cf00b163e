"""Alpha and stencil punch-through of aten_tpu_torch against aten_tpu.

* `occlusion_alpha` on tests/test_alpha.py's veils (two stacked veils;
  six, past the old cap of four) and on the 1,540-prim knot scene with
  the alpha fixture's 64 cards, untextured (the BVH path, shadow rays
  from surface points toward the light): within 1e-6 of the reference.
* Renders against the reference's `render_image` at 32x32 (the veil at
  24x24), 4 spp, depth 5, within the full-image radiance bounds
  (frac(rel > 2e-2) < 5e-3, mean rel < 3e-3): the small alpha and
  stencil fixtures (`populate_alpha_mesh_scene`,
  `populate_stencil_mesh_scene`), a veil with an alpha-mapped cutout
  texture, and the toon fixture with its toon materials at alpha 0.6.
* A scene without alpha keeps its sample stream (test_alpha.py:86-101):
  no punch draw, the reference's render within the same bounds.
* The bridge carries an alpha map's fourth channel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.accel.traverse import occlusion_alpha as jax_occlusion_alpha
from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator.pathtracer import render_image as jax_render_image
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.accel.traverse import occlusion_alpha, traverse
from aten_tpu_torch.core.camera import PinholeCamera, generate_ray
from aten_tpu_torch.integrator.pathtracer import render_image
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import SceneBuilder
from aten_tpu_torch.tools.trav_stats import light_centroid
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

pytestmark = pytest.mark.usefixtures("reference_native")

# Tier-1 runs these files in parallel workers; torch's default of one
# intra-op thread per core makes the workers' small ops contend.
torch.set_num_threads(1)


def _both(populate):
    """(reference scene, the port's via the bridge, camera) of one
    populate function."""
    jb = JaxSceneBuilder()
    cam = populate(jb)
    js = jb.build()
    ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
    return js, ts, cam


def _veils(b, alphas=(0.5, 0.25), step=1.0):
    for k, a in enumerate(alphas):
        m = b.add_material(MaterialType.DIFFUSE, base_color=(1, 1, 1), alpha=a)
        z = step * k
        b.add_quad((-5, -5, z), (5, -5, z), (5, 5, z), (-5, 5, z), m)


@pytest.mark.parametrize("alphas,step,ro,dist,want", [
    ((0.5, 0.25), 1.0, [[0.0, 0.0, 3.0], [8.0, 0.0, 3.0]], [6.0, 6.0], [0.625, 0.0]),
    ((0.5,) * 6, 0.5, [[0.0, 0.0, 4.0]], [8.0], [1.0 - 0.5 ** 6]),
])
def test_occlusion_alpha_veils(alphas, step, ro, dist, want):
    """test_alpha.py's transmittance through two veils and its deep stack."""
    js, ts, _ = _both(lambda b: _veils(b, alphas, step))
    ro = np.asarray(ro, np.float32)
    rd = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (ro.shape[0], 1))
    dist = np.asarray(dist, np.float32)
    ref = np.asarray(jax_occlusion_alpha(js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(dist)))
    got = occlusion_alpha(ts, torch.tensor(ro), torch.tensor(rd), torch.tensor(dist)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _alpha_quads_mesh(b):
    """The 1,540-prim knot scene, the knot at alpha 0.7, with the alpha
    fixture's 64 cards in four layers, untextured at alpha 0.3 to 0.9 by
    layer: the alpha maps' bilinear ramps (about 32 per unit of uv) would
    turn the reference's FMA-contracted u/v into differences of ~4e-6."""
    cam = tdefs.populate_procedural_mesh_scene(b, 32, 32, n_u=48, n_v=16, alpha=0.7)
    for k, y in enumerate((6.0, 7.5, 9.0, 10.5)):
        m = b.add_material(MaterialType.DIFFUSE, base_color=(0.3, 0.6, 0.2), alpha=0.3 + 0.2 * k)
        for i in range(4):
            for j in range(4):
                x0, z0 = -4.0 + 2.0 * i + 0.1 * k, -4.0 + 2.0 * j - 0.1 * k
                b.add_quad([x0, y, z0], [x0 + 2, y, z0], [x0 + 2, y, z0 + 2], [x0, y, z0 + 2], m)
    return cam


def test_occlusion_alpha_on_the_mesh():
    """Shadow rays from 4,096 surface points of the knot and the floor
    toward points on the light: the BVH path (the oracle walk in the
    reference, K1's plain version here)."""
    js, ts, _ = _both(_alpha_quads_mesh)
    assert ts["num_tris"] + ts["num_spheres"] == 1540 + 128 and ts["has_alpha"]
    rng = np.random.default_rng(5)
    tid = rng.integers(0, 1536 + 2, 4096)  # the knot and the floor
    b = rng.random((4096, 2)) * 0.5
    v0, e1, e2 = (ts[k].numpy()[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
    p = (v0 + b[:, :1] * e1 + b[:, 1:] * e2).astype(np.float32)
    to = light_centroid(ts).numpy()[None, :] + rng.uniform(-3, 3, (4096, 3)) * [1, 0, 1] - p
    dist = np.linalg.norm(to, axis=1).astype(np.float32)
    rd = (to / dist[:, None]).astype(np.float32)
    # from the surface point: the walk stops 1e-3 short of the light
    ro = p
    ref = np.asarray(jax_occlusion_alpha(js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(dist)))
    got = occlusion_alpha(ts, torch.tensor(ro), torch.tensor(rd), torch.tensor(dist)).numpy()
    partial = ((ref > 1e-3) & (ref < 0.999)).mean()
    assert partial > 0.3, partial  # most rays pass cards or the knot
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _veil_textured(b):
    """A veil at alpha 0.8 with a cutout alpha map, in front of an emitter
    wall, lit by a quad light."""
    wall = b.add_material(MaterialType.EMISSIVE, base_color=(1.0, 1.0, 1.0))
    b.add_quad((-9, -9, -2), (9, -9, -2), (9, 9, -2), (-9, 9, -2), wall)
    cut = b.add_texture(tdefs.cutout_mask(3, n=16))
    veil = b.add_material(MaterialType.DIFFUSE, base_color=(0.6, 0.6, 0.6), alpha=0.8,
                          albedo_map=cut)
    b.add_mesh([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], [[0, 1, 2], [0, 2, 3]], veil,
               uv=[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    emit = b.add_material(MaterialType.EMISSIVE, base_color=(6, 6, 6))
    ls, lc = b.add_quad((2.0, 2.0, 2.0), (2.0, 3.0, 2.0), (3.0, 3.0, 2.0), (3.0, 2.0, 2.0), emit)
    b.add_area_light_tris(ls, lc, le=(6, 6, 6))
    return PinholeCamera(origin=(0, 0, 4), lookat=(0, 0, 0), vfov_deg=45, width=24, height=24)


def _opaque(b):
    """test_alpha.py::test_opaque_scene_stream_unchanged's scene."""
    m = b.add_material(MaterialType.DIFFUSE, base_color=(0.5, 0.5, 0.5))
    lm = b.add_material(MaterialType.EMISSIVE, base_color=(4, 4, 4))
    b.add_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3), m)
    ls, lc = b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), lm)
    b.add_area_light_tris(ls, lc, (4, 4, 4))
    return PinholeCamera(origin=(0, 2, 6), lookat=(0, 0, 0), width=16, height=16)


RENDERS = {
    "alpha_mesh": (lambda b: tdefs.populate_alpha_mesh_scene(b, 32, 32, n_u=24, n_v=12),
                   "has_alpha"),
    "stencil_mesh": (lambda b: tdefs.populate_stencil_mesh_scene(b, 32, 32, n_u=24, n_v=12),
                     "has_stencil"),
    "veil_textured": (_veil_textured, "has_alpha"),
    "toon_alpha": (lambda b: tdefs.populate_toon_scene(b, 32, 32, alpha=0.6), "has_alpha"),
    "opaque": (_opaque, None),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_matches_reference(name):
    populate, flag = RENDERS[name]
    js, ts, cam = _both(populate)
    for f in ("has_alpha", "has_stencil"):
        assert ts[f] == (f == flag) == js.static[f], f
    ref = np.asarray(jax_render_image(js, JaxPinholeCamera(**dataclasses.asdict(cam)), spp=4,
                                      max_depth=5))
    img = render_image(ts, cam, spp=4, max_depth=5).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.02
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert (rel > 2e-2).mean() < 5e-3, (rel > 2e-2).mean()
    assert rel.mean() < 3e-3, rel.mean()


def test_stencil_shows_the_always_surface():
    """test_alpha.py::test_stencil_punch_through's check on the fixture:
    of the pixels whose camera ray first hits the STENCIL quad, those
    with the knot behind show its gold, and those with only the floor
    behind show the quad's red."""
    _, ts, cam = _both(lambda b: tdefs.populate_stencil_mesh_scene(b, 48, 48, n_u=24, n_v=12))
    img = render_image(ts, cam, spp=4, max_depth=3).numpy().reshape(-1, 3)
    y, x = np.divmod(np.arange(48 * 48), 48)
    s = torch.tensor((x + 0.5) / 48, dtype=torch.float32)
    t = torch.tensor((47 - y + 0.5) / 48, dtype=torch.float32)
    ro, rd = generate_ray(cam.arrays("cpu"), s, t)
    quad = traverse(ts, ro, rd)["prim"].numpy() >= ts["num_tris"] - 2
    r, g, b = img[quad].T
    red = g < 0.4 * r
    gold = (g > 0.5 * r) & (b < 0.7 * g)
    assert quad.mean() > 0.05 and red.mean() > 0.2 and gold.mean() > 0.05, \
        (quad.mean(), red.mean(), gold.mean())


def test_bridge_carries_the_alpha_map():
    js, ts, _ = _both(_veil_textured)
    tb = SceneBuilder()
    _veil_textured(tb)
    own = tb.build("cpu")
    alpha = tdefs.cutout_mask(3, n=16)[..., 3]
    assert 0.2 < (alpha == 0).mean() and (alpha == 1).any() and ((alpha > 0) & (alpha < 1)).any()
    for s in (ts, own):
        np.testing.assert_array_equal(s["tex_stack"][0, :16, :16, 3].numpy(), alpha)
    np.testing.assert_array_equal(ts["tex_stack"].numpy(), own["tex_stack"].numpy())
