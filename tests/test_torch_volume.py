"""Participating media (`aten_tpu_torch/volume/medium.py`,
`integrator/volpt.py`, the volume fixtures) against aten_tpu.

* The scene arrays of both volume fixtures, built by the port and
  brought over by `bridge.from_numpy`, bitwise the reference's (its
  staged `grid_corners` rows dropped).
* The medium stack's operations and the tracking keys and uniforms:
  bitwise.  `hg_phase` and `hg_sample` on 4,096 lanes within rtol 1e-5
  on >= 99.5% of lanes (torch's and XLA's sin, cos and sqrt may differ
  by an ulp); `sample_grid_density` and `_brick_step` within 1e-6.
* Delta and ratio tracking on 4,096 seeded rays through
  `hetero_volume_scene`'s grid, against the reference run op by op:
  `scattered` agrees on >= 0.999 of lanes, t within 1e-5 rel where it
  agrees, tr within 1e-5 rel on >= 0.999 of lanes.  The port walks only
  the live lanes; that walk is bitwise the masked loop of the reference
  (transcribed in torch below).
* Images at 24x24, 2 spp, depth 4, RR 3, of `homogeneous_volume_scene`,
  `hetero_volume_scene(res=24)` and the 2,004-prim knot in a fog box
  (the oracle walk and K1's plain version), against the reference run op
  by op (`jax.disable_jit()`; for the knot its traversal jitted, which
  makes no random-walk decision: a walk op by op takes ~5 min): >= 0.90
  of pixels within 1e-4, the image mean within 2%, 4x4-block means
  within 10% rel.  Delta and ratio tracking decide by comparisons
  (u2 < dens / maj, t_new >= t_surf, t_new < dist) that an ulp of log
  or exp flips, after which a path takes another walk; the jitted
  reference against its own op-by-op run meets these bounds at the
  golden's configuration (0.963 of pixels, 0.90%, 6.7%).  Measured here
  (the port's CPU against the op-by-op reference): homogeneous and
  hetero every pixel within 1e-4, mean 0.0%; the knot 0.998 of pixels,
  mean 0.016%.
* `tests/golden/volume.npz` (the jitted reference, 32x32, 4 spp,
  depth 6) with the same three bounds.
* tests/test_volume.py's nested-media, attenuation and Beer-Lambert
  checks, on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aten_tpu.accel.traverse import traverse as jax_traverse
from aten_tpu.core.camera import PinholeCamera as JaxPinholeCamera
from aten_tpu.integrator import volpt as jvolpt
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu.volume import medium as jmed
from aten_tpu_torch.core.camera import PinholeCamera
from aten_tpu_torch.integrator import volpt
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.scene.scene import Scene, SceneBuilder, to_tensors
from aten_tpu_torch.volume import medium
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

torch.set_num_threads(1)

S = 24
RENDER = {"spp": 2, "max_depth": 4, "rr_depth": 3}
POPULATE = {
    "homogeneous": lambda b: tdefs.populate_homogeneous_volume_scene(b, S, S),
    "hetero": lambda b: tdefs.populate_hetero_volume_scene(b, S, S, res=24),
    "fog_knot": lambda b: tdefs.populate_fog_knot_scene(b, S, S, 40, 25),
}
PIXEL_FRAC, MEAN_REL, BLOCK_REL = 0.90, 0.02, 0.10
N_RAYS = 4096


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scenes(name):
    """(reference scene, port scene built by the port's builder, port
    scene bridged from the reference's, camera)."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    POPULATE[name](jb)
    cam = POPULATE[name](tb)
    js = jb.build()
    return js, tb.build("cpu"), bridge.from_numpy(_np(js.arrays), js.static, "cpu"), cam


def _jax_cam(cam):
    return JaxPinholeCamera(**{f: getattr(cam, f) for f in cam.__dataclass_fields__})


def image_stats(img, ref):
    """(fraction of pixels within 1e-4 in every channel, |mean - ref mean|
    / ref mean, the largest rel difference of 4x4-block means)."""
    within = float((np.abs(img - ref) <= 1e-4).all(-1).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    h, w = img.shape[0] // 4, img.shape[1] // 4
    bi = img[:h * 4, :w * 4].reshape(h, 4, w, 4, 3).mean((1, 3, 4))
    br = ref[:h * 4, :w * 4].reshape(h, 4, w, 4, 3).mean((1, 3, 4))
    block_rel = float((np.abs(bi - br) / np.maximum(np.abs(br), 1e-2)).max())
    return within, mean_rel, block_rel


def assert_image_bounds(name, img, ref):
    within, mean_rel, block_rel = image_stats(img, ref)
    print(f"{name}: {within:.4f} of pixels within 1e-4, mean rel {mean_rel:.5f}, "
          f"4x4 blocks rel <= {block_rel:.4f}")
    assert np.isfinite(img).all() and (img >= 0).all(), name
    assert within >= PIXEL_FRAC and mean_rel <= MEAN_REL and block_rel <= BLOCK_REL, (
        name, within, mean_rel, block_rel)


def _jitted_traverse(*a, **kw):
    with jax.disable_jit(False):
        return jax_traverse(*a, **kw)


@pytest.fixture(scope="module")
def references(reference_native):  # noqa: F811
    """Each fixture's scenes and the reference's render of it, op by op."""
    out = {}
    for name in POPULATE:
        js, built, bridged, cam = _scenes(name)
        with pytest.MonkeyPatch.context() as mp:
            if name == "fog_knot":
                mp.setattr(jvolpt, "traverse", _jitted_traverse)
            with jax.disable_jit():
                ref = np.asarray(jvolpt.render_volpt(js, _jax_cam(cam), **RENDER))
        out[name] = (js, built, bridged, cam, ref)
    return out


@pytest.mark.parametrize("name", ["homogeneous", "hetero"])
def test_volume_scene_arrays_match_reference(references, name):
    js, built, bridged, _, _ = references[name]
    ref = _np(js.arrays)
    assert "grid_corners" in ref if name == "hetero" else "grid_density" not in ref
    for scene in (built, bridged):
        for k, v in scene.arrays.items():
            if isinstance(v, dict) or k.startswith("bvh_"):
                continue
            r = ref[k]
            assert v.numpy().dtype == r.dtype, k
            np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
        assert "grid_corners" not in scene
        for k in medium.ARRAY_KEYS + (medium.GRID_KEYS if name == "hetero" else ()):
            assert k in scene, k
    np.testing.assert_array_equal(built["materials"]["medium"].numpy(),
                                  ref["materials"]["medium"])


def test_cuda_scene_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdefs.hetero_volume_scene(8, 8, res=8)
    with pytest.raises(RuntimeError):
        tdefs.homogeneous_volume_scene(8, 8, device="cuda")


def test_medium_stack_ops_bitwise():
    rng = np.random.default_rng(3)
    n, depth = 512, volpt.MEDIUM_STACK_DEPTH
    assert depth == jvolpt.MEDIUM_STACK_DEPTH
    mstack = rng.integers(-1, 6, (n, depth)).astype(np.int32)
    msize = rng.integers(0, depth + 1, n).astype(np.int32)
    mid = rng.integers(-1, 6, n).astype(np.int32)
    flags = rng.random((4, n)) < 0.5
    t = {k: torch.tensor(v) for k, v in (("s", mstack), ("z", msize), ("m", mid))}
    j = {k: jnp.asarray(v) for k, v in (("s", mstack), ("z", msize), ("m", mid))}
    tf, jf = [torch.tensor(f) for f in flags], [jnp.asarray(f) for f in flags]
    np.testing.assert_array_equal(volpt._stack_top(t["s"], t["z"]).numpy(),
                                  np.asarray(jvolpt._stack_top(j["s"], j["z"])))
    for got, want in zip(volpt._stack_push(t["s"], t["z"], t["m"], tf[0]),
                         jvolpt._stack_push(j["s"], j["z"], j["m"], jf[0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(volpt._stack_pop(t["z"], tf[1]).numpy(),
                                  np.asarray(jvolpt._stack_pop(j["z"], jf[1])))
    got = volpt._update_medium(t["s"], t["z"], tf[1], tf[2], {"medium": t["m"]}, tf[3])
    want = jvolpt._update_medium(j["s"], j["z"], jf[1], jf[2], {"medium": j["m"]}, jf[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_medium_stack_nested_media():
    """tests/test_volume.py's check on the port: exiting the inner
    boundary restores the outer medium; pushes past the depth are
    dropped, pops stop at 0; a fog box holding a denser box renders
    finite and darker through both."""
    N = 4
    mstack = torch.full((N, volpt.MEDIUM_STACK_DEPTH), -1, dtype=torch.int32)
    msize = torch.zeros((N,), dtype=torch.int32)
    t = torch.ones((N,), dtype=torch.bool)
    mat_outer = {"medium": torch.full((N,), 2, dtype=torch.int32)}
    mat_inner = {"medium": torch.full((N,), 5, dtype=torch.int32)}
    mstack, msize = volpt._update_medium(mstack, msize, t, t, mat_outer, t)
    mstack, msize = volpt._update_medium(mstack, msize, t, t, mat_inner, t)
    assert int(volpt._stack_top(mstack, msize)[0]) == 5
    mstack, msize = volpt._update_medium(mstack, msize, t, ~t, mat_inner, t)
    assert int(volpt._stack_top(mstack, msize)[0]) == 2
    mstack, msize = volpt._update_medium(mstack, msize, t, ~t, mat_outer, t)
    assert int(volpt._stack_top(mstack, msize)[0]) == -1
    for _ in range(volpt.MEDIUM_STACK_DEPTH + 2):
        mstack, msize = volpt._update_medium(mstack, msize, t, t, mat_inner, t)
    assert int(msize[0]) == volpt.MEDIUM_STACK_DEPTH
    for _ in range(volpt.MEDIUM_STACK_DEPTH + 2):
        mstack, msize = volpt._update_medium(mstack, msize, t, ~t, mat_inner, t)
    assert int(msize[0]) == 0

    b = SceneBuilder()
    lm = b.add_material(MaterialType.EMISSIVE, base_color=(3, 3, 3))
    b.add_quad((-8, -8, -6), (8, -8, -6), (8, 8, -6), (-8, 8, -6), lm)
    fog = b.add_medium(sigma_a=(0.25,) * 3, sigma_s=(0.02,) * 3, g=0.0)
    dense = b.add_medium(sigma_a=(3.0,) * 3, sigma_s=(0.05,) * 3, g=0.0)
    mo = b.add_material(MaterialType.REFRACTION, ior=1.0, medium=fog)
    mi = b.add_material(MaterialType.REFRACTION, ior=1.0, medium=dense)
    tdefs._add_box(b, (-3, -3, -3), (3, 3, 3), mo)
    tdefs._add_box(b, (-1, -1, -1), (1, 1, 1), mi)
    sc = b.build("cpu")
    cam = PinholeCamera(origin=(0, 0, 8), lookat=(0, 0, 0), vfov_deg=35, width=24, height=24)
    img = volpt.render_volpt(sc, cam, spp=6, max_depth=8).numpy()
    assert np.isfinite(img).all()
    assert img[12, 12].mean() < img[2, 2].mean()


def test_medium_attenuates_and_inscatters():
    """tests/test_volume.py's check on the port: moderate fog dims the
    bright pixels and lifts the darkest ones."""
    fog_scene, cam = tdefs.homogeneous_volume_scene(24, 24, sigma_s=0.4, sigma_a=0.02,
                                                    device="cpu")
    thin_scene, _ = tdefs.homogeneous_volume_scene(24, 24, sigma_s=1e-4, sigma_a=1e-5,
                                                   device="cpu")
    fog = volpt.render_volpt(fog_scene, cam, spp=8, max_depth=6, rr_depth=5).numpy()
    thin = volpt.render_volpt(thin_scene, cam, spp=8, max_depth=6, rr_depth=5).numpy()
    lt, lf = thin.mean(-1), fog.mean(-1)
    dark = lt <= np.quantile(lt, 0.08)
    bright = lt > 0.3
    assert bright.sum() > 10
    assert lf[dark].mean() > lt[dark].mean() * 1.15
    assert lf[bright].mean() < lt[bright].mean()


def test_ratio_tracking_matches_beer_lambert():
    """tests/test_volume.py's check on the port: ratio tracking through a
    constant grid reproduces Beer-Lambert in expectation."""
    tbl = medium.MediumTable()
    tbl.add(sigma_a=(0.4, 0.4, 0.4), sigma_s=(0.6, 0.6, 0.6), g=0.0,
            grid=np.full((8, 8, 8), 0.7, np.float32), grid_bmin=(-1, -1, -1),
            grid_bmax=(1, 1, 1))
    scene = to_tensors(tbl.numpy_arrays(), "cpu")
    n = 4096
    ro = torch.tensor([[-0.99, 0.0, 0.0]]).repeat(n, 1)
    rd = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    dist = torch.full((n,), 1.5)
    tr = medium.transmittance(scene, torch.zeros((n,), dtype=torch.int32), ro, rd, dist,
                              torch.arange(n)).numpy()
    expect = np.exp(-0.7 * (0.4 + 0.6) * 1.5)
    assert abs(tr[:, 0].mean() - expect) < 0.02, (tr[:, 0].mean(), expect)


def test_tracking_keys_bitwise():
    seeds = np.random.default_rng(5).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    ts = torch.tensor(seeds.astype(np.int64))
    js = jnp.asarray(seeds.astype(np.uint32))
    for port_key, want in ((medium.delta_key0(ts), js * jnp.uint32(0x9E3779B9) + jnp.uint32(1)),
                           (medium.ratio_key0(ts), js * jnp.uint32(0x85157AF5) + jnp.uint32(7))):
        for _ in range(MAX_STEPS_CHECKED):
            np.testing.assert_array_equal(port_key.numpy(), np.asarray(want).astype(np.int64))
            port_key = medium.lcg_next(port_key)
            want = want * jnp.uint32(747796405) + jnp.uint32(2891336453)
            np.testing.assert_array_equal(
                medium.key_uniform(port_key).numpy(),
                np.asarray((want >> 9).astype(jnp.float32) / jnp.float32(1 << 23)))
    # the volume tracer's seed: pixel_seed ^ (bounce * 0x27D4EB2F) ^ frame
    for bounce in (0, 1, 7):
        got = ts ^ medium._mul32(bounce, 0x27D4EB2F) ^ 3
        want = js ^ (jnp.uint32(bounce) * jnp.uint32(0x27D4EB2F)) ^ jnp.uint32(3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


MAX_STEPS_CHECKED = 2 * medium.MAX_TRACKING_STEPS


def _close_frac(got, want, rtol, atol=0.0):
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    return float(ok.reshape(ok.shape[0], -1).all(-1).mean())


def test_hg_phase_and_sample_match_reference():
    rng = np.random.default_rng(11)
    n = 4096
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    g[::16] = 0.0  # the isotropic branch
    cos_t = rng.uniform(-1, 1, n).astype(np.float32)
    wo = rng.standard_normal((n, 3))
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    u1, u2 = rng.random((2, n)).astype(np.float32)
    ph = medium.hg_phase(torch.tensor(g), torch.tensor(cos_t)).numpy()
    jph = np.asarray(jmed.hg_phase(jnp.asarray(g), jnp.asarray(cos_t)))
    assert _close_frac(ph, jph, 1e-5) >= 0.995
    wi, pdf = medium.hg_sample(torch.tensor(g), torch.tensor(wo), torch.tensor(u1),
                               torch.tensor(u2))
    jwi, jpdf = jmed.hg_sample(jnp.asarray(g), jnp.asarray(wo), jnp.asarray(u1), jnp.asarray(u2))
    # the direction's components near 0 are held absolutely
    assert _close_frac(wi.numpy(), np.asarray(jwi), 1e-5, 1e-6) >= 0.995
    assert _close_frac(pdf.numpy(), np.asarray(jpdf), 1e-5) >= 0.995


def _grid_rays(js, rng, n=N_RAYS):
    """n rays from uniform points in the hetero fixture's grid box in
    uniform directions, with the distance to the box's exit."""
    lo, hi = np.asarray(js["grid_bmin"])[0], np.asarray(js["grid_bmax"])[0]
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    with np.errstate(divide="ignore"):
        t_hi = np.where(rd > 0, (hi - ro) / rd, (lo - ro) / rd)
    t_exit = np.min(np.where(np.abs(rd) > 1e-12, t_hi, np.inf), axis=1).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    return ro, rd, t_exit, seeds


def test_grid_density_and_brick_step_match_reference(references):
    js, _, ts, _, _ = references["hetero"]
    rng = np.random.default_rng(2)
    lo, hi = np.asarray(js["grid_bmin"])[0], np.asarray(js["grid_bmax"])[0]
    p = rng.uniform(lo - 0.3, hi + 0.3, (N_RAYS, 3)).astype(np.float32)
    d = rng.standard_normal((N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = rng.uniform(0, 3, N_RAYS).astype(np.float32)
    gid = np.zeros(N_RAYS, np.int32)
    dens = medium.sample_grid_density(ts, torch.tensor(gid), torch.tensor(p)).numpy()
    with jax.disable_jit():
        jdens = np.asarray(jmed.sample_grid_density(js, jnp.asarray(gid), jnp.asarray(p)))
        jmb, jt = jmed._brick_step(js, jnp.asarray(gid), jnp.asarray(p), jnp.asarray(d),
                                   jnp.asarray(t))
    assert (dens > 0).mean() > 0.2 and (dens == 0).mean() > 0.2
    np.testing.assert_allclose(dens, jdens, rtol=0, atol=1e-6)
    mb, t_exit = medium._brick_step(ts, torch.tensor(gid), torch.tensor(p), torch.tensor(d),
                                    torch.tensor(t))
    assert (np.asarray(jmb) == 0).mean() > 0.02
    np.testing.assert_allclose(mb.numpy(), np.asarray(jmb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_exit.numpy(), np.asarray(jt), rtol=0, atol=1e-6)


def _masked_delta_track(scene, med, ro, rd, t_surf, seed):
    """The reference's masked delta-tracking loop (medium.py:307-361),
    transcribed in torch: every lane each iteration, until none is live."""
    gid, maj, s_bar = medium._tracking_setup(scene, med)
    n = ro.shape[0]
    t = torch.zeros(n)
    done = ~(t_surf > 0.0)
    scat = torch.zeros(n, dtype=torch.bool)
    key = medium.delta_key0(seed)
    i = 0
    while i < medium.MAX_TRACKING_STEPS and bool((~done).any()):
        key = medium.lcg_next(key)
        u1 = medium.key_uniform(key)
        key = medium.lcg_next(key)
        u2 = medium.key_uniform(key)
        step = -torch.log(torch.clamp(1.0 - u1, 1e-7, 1.0)) / s_bar
        t_new, skip = medium._tentative(scene, gid, ro, rd, t, step)
        dens = medium.sample_grid_density(scene, gid, ro + t_new[..., None] * rd)
        real = ~skip & (u2 < (dens / maj))
        escaped = t_new >= t_surf
        newly = ~done & (real | escaped)
        scat = torch.where(newly, real & ~escaped, scat)
        t = torch.where(done, t, t_new)
        done = done | newly
        i += 1
    return torch.minimum(t, t_surf), scat & done & (t_surf > 0.0)


def _masked_ratio_track(scene, med, ro, rd, dist, seed):
    """The reference's masked ratio-tracking loop (medium.py:385-430) in
    torch."""
    gid, maj, s_bar = medium._tracking_setup(scene, med)
    n = ro.shape[0]
    t, tr = torch.zeros(n), torch.ones(n)
    done = ~(dist > 0.0)
    key = medium.ratio_key0(seed)
    i = 0
    while i < medium.MAX_TRACKING_STEPS and bool((~done).any()):
        key = medium.lcg_next(key)
        u1 = medium.key_uniform(key)
        step = -torch.log(torch.clamp(1.0 - u1, 1e-7, 1.0)) / s_bar
        t_new, skip = medium._tentative(scene, gid, ro, rd, t, step)
        alive = ~done & (t_new < dist)
        dens = medium.sample_grid_density(scene, gid, ro + t_new[..., None] * rd)
        tr = torch.where(alive & ~skip, tr * (1.0 - dens / maj), tr)
        t = torch.where(alive, t_new, t)
        done = done | ~alive
        i += 1
    return tr[..., None] * torch.ones((1, 3))


@pytest.mark.parametrize("brick", [True, False])
def test_tracking_matches_reference_and_masked_walk(references, brick):
    """Delta and ratio tracking on 4,096 rays in the grid: the live-lanes
    walk bitwise the masked loop; both against the reference op by op.
    brick=False drops the brick majorants (the walk takes Exp steps
    through empty space)."""
    js, _, ts, _, _ = references["hetero"]
    if not brick:
        js = js.drop("grid_brickmax")
        ts = Scene({k: v for k, v in ts.arrays.items() if k != "grid_brickmax"}, ts.static,
                   ts.device)
    ro, rd, t_exit, seeds = _grid_rays(js, np.random.default_rng(9))
    n = ro.shape[0]
    # a quarter of the segments end at a surface inside the box
    t_surf = np.where(np.arange(n) % 4 == 0, t_exit * 0.5, t_exit).astype(np.float32)
    mid = np.zeros(n, np.int32)
    tro, trd, tts, tseed = (torch.tensor(ro), torch.tensor(rd), torch.tensor(t_surf),
                            torch.tensor(seeds.astype(np.int64)))
    med = medium._medium_row(ts, torch.tensor(mid))
    t, scat = medium._delta_track(ts, med, tro, trd, tts, tseed)
    mt, mscat = _masked_delta_track(ts, med, tro, trd, tts, tseed)
    assert torch.equal(t, mt) and torch.equal(scat, mscat)
    tr = medium._ratio_track(ts, med, tro, trd, tts, tseed)
    assert torch.equal(tr, _masked_ratio_track(ts, med, tro, trd, tts, tseed))

    jm = jmed._medium_row(js, jnp.asarray(mid))
    with jax.disable_jit():
        jt, jscat = jmed._delta_track(js, jm, jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(t_surf), jnp.asarray(seeds.astype(np.uint32)))
        jtr = jmed._ratio_track(js, jm, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_surf),
                                jnp.asarray(seeds.astype(np.uint32)))
    jt, jscat, jtr = np.asarray(jt), np.asarray(jscat), np.asarray(jtr)
    scat, t, tr = scat.numpy(), t.numpy(), tr.numpy()
    assert 0.1 < jscat.mean() < 0.9, jscat.mean()
    agree = scat == jscat
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(t[agree], jt[agree], rtol=1e-5, atol=0)
    assert 0.05 < jtr[:, 0].mean() < 0.95
    assert _close_frac(tr, jtr, 1e-5, 1e-7) >= 0.999


@pytest.mark.parametrize("name", list(POPULATE))
def test_render_matches_reference_op_by_op(references, name):
    _, built, bridged, cam, ref = references[name]
    impls = ("plain", "auto") if name == "fog_knot" else ("auto",)
    imgs = {}
    for impl in impls:
        imgs[impl] = volpt.render_volpt(bridged, cam, impl=impl, **RENDER).numpy()
        assert_image_bounds(f"{name} ({impl})", imgs[impl], ref)
    # the port's own builder gives the bridged scene's image
    np.testing.assert_array_equal(volpt.render_volpt(built, cam, **RENDER).numpy(),
                                  imgs["auto"])
    if name == "fog_knot":
        # K1's plain version: the oracle walk's hits, so its image
        np.testing.assert_array_equal(imgs["auto"], imgs["plain"])
        assert bridged["num_tris"] == 2 * 40 * 25 + 4 + 12


def test_volume_golden():
    """tests/golden/volume.npz (tests/test_golden.py's config: the jitted
    reference at 32x32, 4 spp, depth 6) with the image bounds."""
    import os

    scene, cam = tdefs.hetero_volume_scene(32, 32, res=24, device="cpu")
    img = volpt.render_volpt(scene, cam, spp=4, max_depth=6).numpy()
    with np.load(os.path.join(os.path.dirname(__file__), "golden", "volume.npz")) as z:
        gold = z["img"]
    assert img.shape == gold.shape
    assert_image_bounds("volume golden", img, gold)
