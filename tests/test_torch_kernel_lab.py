"""aten_tpu_torch's treelet-walk lab L1 against the reference's lab kernels.

The reference's tools/kernel_lab.py is loaded by file path (tools/ is
not a package) and its Pallas kernels run in TPU interpret mode on the
CPU, on aten_tpu's own treelet layout of a 2,004-prim knot
(`build_treelet_layout` called directly, as tests/test_torch_smt.py
does), for 2,048 rays: 1,024 camera rays through the pixel centres of a
32x32 image, then 1,024 rays from random surface points in random
directions (numpy seeded).  The port's plain versions (what `run`
computes for CPU tensors) walk the port's K4 layout of the same BVH.

* Tables: the lab's Plücker tables and ray order, bit for bit.
* `nodes`/`nodir`: t bitwise equal (the slab math gives XLA nothing to
  contract, and the least t_enter over the leaves hit does not depend on
  the walk order); prim agreement >= 0.999, since two leaves entered at
  exactly the same t_enter may resolve by the tile's ordering, whose sum
  XLA takes in another order.
* The closest-hit variants: prim agreement >= 0.999 (XLA contracts
  FMAs, and its sum order can flip a tile's ordering near a tie), t
  within 1e-4 where prims agree; `plk` at the same bounds, its products
  S and NUM within 1e-5 of a float64 product.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aten_tpu.accel.traverse import traverse as jax_traverse
from aten_tpu.core import camera as jcam
from aten_tpu.ops import traverse_pallas as jtp
from aten_tpu.scene.scene import SceneBuilder as JaxSceneBuilder
from aten_tpu_torch.scene import bridge
from aten_tpu_torch.scene import scenedefs as tdefs
from aten_tpu_torch.scene.scene import with_trl_layout
from aten_tpu_torch.tools import kernel_lab as kl
from aten_tpu_torch.utils import spans
from test_torch_bvh_scene import reference_native  # noqa: F401  (the one guard)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT_ARGS = ("tri_v0", "tri_e1", "tri_e2", "sph_center", "sph_radius")
N = 2048



_CACHE = {}


def _ref_lab():
    if "lab" not in _CACHE:
        spec = importlib.util.spec_from_file_location(
            "reference_kernel_lab", os.path.join(ROOT, "tools", "kernel_lab.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE["lab"] = mod
    return _CACHE["lab"]


def _setup():
    """(reference SceneData, its treelet layout, the port's lab tables,
    ro, rd, t0 as numpy)."""
    if "setup" not in _CACHE:
        b = JaxSceneBuilder()
        cam = tdefs.populate_procedural_mesh_scene(b, 32, 32, n_u=40, n_v=25)
        js = b.build()
        ts = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, js.arrays), js.static, "cpu")
        bvh = {k: np.asarray(js[k]) for k in bridge.BVH_KEYS}
        jl = jtp.build_treelet_layout(bvh, *(np.asarray(js[k]) for k in LAYOUT_ARGS),
                                      js["num_tris"])
        tab = kl.tables(with_trl_layout(ts))
        jc = jcam.PinholeCamera(**dataclasses.asdict(cam))
        pix = kl.lab_order(32)
        ro_c, rd_c = jcam.generate_ray(
            jc.arrays(), jnp.asarray((pix % 32 + 0.5) / 32, jnp.float32),
            jnp.asarray((31 - pix // 32 + 0.5) / 32, jnp.float32))
        rng = np.random.default_rng(1)
        tid = rng.integers(0, js["num_tris"], N // 2)
        w = rng.random((N // 2, 2))
        w[w.sum(1) > 1] = 1.0 - w[w.sum(1) > 1]
        v0, e1, e2 = (np.asarray(js[k])[tid] for k in ("tri_v0", "tri_e1", "tri_e2"))
        ro_s = (v0 + w[:, :1] * e1 + w[:, 1:] * e2).astype(np.float32)
        d = rng.standard_normal((N // 2, 3))
        rd_s = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        ro = np.concatenate([np.asarray(ro_c), ro_s]).astype(np.float32)
        rd = np.concatenate([np.asarray(rd_c), rd_s]).astype(np.float32)
        _CACHE["setup"] = (js, jl, tab, ro, rd, np.full(N, 3.4e38, np.float32))
    return _CACHE["setup"]


def _reference(variant):
    """aten_tpu's lab kernel `variant` in TPU interpret mode: (t, prim)."""
    if variant not in _CACHE:
        ref = _ref_lab()
        _, jl, _, ro, rd, t0 = _setup()

        def prep(x):
            return jnp.asarray(x.reshape(-1, 128))

        rays = [prep(ro[:, a]) for a in range(3)] + [prep(rd[:, a]) for a in range(3)] + [prep(t0)]
        nodes, prims = jnp.asarray(jl["trl_nodes"]), jnp.asarray(jl["trl_prims"])
        with pltpu.force_tpu_interpret_mode():
            if variant in ("nodes", "nodir", "leafu"):
                out = ref.run(nodes, prims, *rays, variant=variant)
            elif variant.startswith("wide16"):
                out = ref.run_wide(nodes, prims, *rays, tile_rows=16,
                                   leaf_cond=variant == "wide16")
            elif variant == "spec8":
                out = ref.run_spec(nodes, prims, *rays, tile_rows=8)
            else:
                nodes2, E, pids = _ref_plucker()
                out = ref.run_plk(jnp.asarray(nodes2), jnp.asarray(E), pids, *rays,
                                  tile_rows=16)
        _CACHE[variant] = (np.asarray(out[0]).reshape(-1), np.asarray(out[1]).reshape(-1))
    return _CACHE[variant]


def _ref_plucker():
    if "plucker" not in _CACHE:
        _CACHE["plucker"] = _ref_lab().build_plucker_leaves(_setup()[1], 0)
    return _CACHE["plucker"]


def _port(variant):
    _, _, tab, ro, rd, t0 = _setup()
    t, prim = kl.run(tab, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(t0),
                     variant)
    return t.numpy(), prim.numpy()


def test_plucker_tables_match_reference(reference_native):
    nodes2, E, pids = _ref_plucker()
    _, _, tab, _, _, _ = _setup()
    kt = tab["nodes"].shape[0]
    assert tab["emat"].shape == E.shape and E.shape[0] > 8 * 40
    np.testing.assert_array_equal(tab["emat"].numpy().view(np.int32), E.view(np.int32))
    np.testing.assert_array_equal(tab["pids"].numpy(), np.asarray(pids))
    lane21 = nodes2[:, 21].view(np.int32)
    np.testing.assert_array_equal(tab["tre"].numpy(), lane21[:kt])
    assert (lane21[kt:] == -1).all()


def test_lab_order_matches_reference_main():
    """The permutation of the reference's `main` (:227-232) at 64x64."""
    res = 64
    ids = []
    for y0 in range(0, res, 32):
        for x0 in range(0, res, 32):
            yy, xx = np.mgrid[y0:y0 + 32, x0:x0 + 32]
            ids.append((yy * res + xx).ravel())
    np.testing.assert_array_equal(kl.lab_order(res), np.concatenate(ids))


def test_lab_rays_are_the_reference_mains():
    """lab_rays: the reference main's film coordinates (:221-226) through
    the port's camera, in lab order."""
    from aten_tpu_torch.core.camera import generate_ray

    _, cam = tdefs.procedural_mesh_scene(64, 64, n_u=8, n_v=4, device="cpu")
    ro, rd, t0 = kl.lab_rays(cam, 64, "cpu")
    x = (np.arange(64) + 0.5) / 64
    y = (64 - 1 - np.arange(64) + 0.5) / 64
    s, t = np.meshgrid(x, y)
    pix = kl.lab_order(64)
    f32 = torch.float32
    want_o, want_d = generate_ray(cam.arrays("cpu"), torch.tensor(s.ravel()[pix], dtype=f32),
                                  torch.tensor(t.ravel()[pix], dtype=f32))
    assert torch.equal(ro, want_o) and torch.equal(rd, want_d)
    assert t0.shape == (4096,) and bool((t0 == np.float32(3.4e38)).all())


@pytest.mark.parametrize("variant", ["nodes", "nodir"])
def test_node_walks_match_reference(reference_native, variant):
    ref_t, ref_p = _reference(variant)
    got_t, got_p = _port(variant)
    np.testing.assert_array_equal(got_t.view(np.int32), ref_t.view(np.int32))
    assert (got_p == ref_p).mean() >= 0.999, (got_p == ref_p).mean()
    assert 0.2 < (got_p >= 0).mean() < 0.95
    first = _setup()[2]["nodes"].view(torch.int32)[:, 6].numpy()
    assert set(got_p[got_p >= 0].tolist()) <= set((first[first >= 0] // 8).tolist())


@pytest.mark.parametrize("variant", ["leafu", "wide16", "wide16_nc", "spec8", "plk"])
def test_closest_hit_walks_match_reference(reference_native, variant):
    ref_t, ref_p = _reference(variant)
    got_t, got_p = _port(variant)
    agree = (got_p == ref_p).mean()
    assert agree >= 0.999, agree
    m = (ref_p >= 0) & (got_p == ref_p)
    assert m.mean() > 0.25
    np.testing.assert_allclose(got_t[m], ref_t[m], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["leafu", "wide8", "wide16", "wide16_nc", "spec8",
                                     "spec16", "wide16_t72"])
def test_closest_hit_walks_match_oracle(reference_native, variant):
    """Every closest-hit variant but plk finds the oracle walk's prims."""
    js, _, _, ro, rd, _ = _setup()
    ref = jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax")
    ref_p, ref_t = np.asarray(ref["prim"]), np.asarray(ref["t"])
    got_t, got_p = _port(variant)
    assert (got_p == ref_p).mean() >= 0.999
    m = (ref_p >= 0) & (got_p == ref_p)
    np.testing.assert_allclose(got_t[m], ref_t[m], rtol=1e-4, atol=1e-4)


def test_plk_products_and_its_den_term(reference_native):
    """S = E^T R6 and NUM = E[:, 3P:]^T R4 within 1e-5 of the float64
    product, relative to the sum of the terms' magnitudes; and the
    lab's den (n.rd - (n.v0) m_x) costs it hits the oracle walk finds."""
    js, _, tab, ro, rd, t0 = _setup()
    e3 = tab["emat"].view(-1, 8, 4 * kl.PLK_SLOTS)[:6]
    o = torch.from_numpy(ro[:2048]).view(1, -1, 3).expand(6, -1, -1)
    d = torch.from_numpy(rd[:2048]).view(1, -1, 3).expand(6, -1, -1)
    S, NUM = kl.plk_products(e3, o, d)
    o64, d64, e64 = o.double(), d.double(), e3.double()
    r6 = torch.cat([d64, torch.linalg.cross(o64, d64)], -1)  # [6, T, 6]
    want = torch.einsum("gkc,gtk->gct", e64[:, :6], r6)
    scale = torch.einsum("gkc,gtk->gct", e64[:, :6].abs(), r6.abs())
    assert bool(((S.double() - want).abs() <= 1e-5 * scale + 1e-30).all())
    r4 = torch.cat([o64, torch.ones_like(o64[..., :1])], -1)
    q = e64[:, :4, 3 * kl.PLK_SLOTS:]
    want = torch.einsum("gkc,gtk->gct", q, r4)
    scale = torch.einsum("gkc,gtk->gct", q.abs(), r4.abs())
    assert bool(((NUM.double() - want).abs() <= 1e-5 * scale + 1e-30).all())
    ref = jax_traverse(js, jnp.asarray(ro), jnp.asarray(rd), impl="jax")
    got_t, got_p = _port("plk")
    assert (got_p >= 0).mean() < 0.9 * (np.asarray(ref["prim"]) >= 0).mean()


def test_plain_tile_subset_and_run_on_cpu(reference_native):
    """`run` on CPU tensors is `run_plain`; a tile subset is those tiles'
    rows of the whole run; v3 is the oracle walk; tile walks count work."""
    spans.reset()
    _, _, tab, ro, rd, t0 = _setup()
    args = (tab, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(t0))
    for v in ("wide8", "plk"):
        t, p = kl.run(*args, v)
        tp, pp, st = kl.run_plain(*args, v, stats=True)
        assert torch.equal(t, tp) and torch.equal(p, pp)
        assert st["tile_steps"] > 50 and st["slot_tests"] > 0 and st["leaves"] > 0
        T = kl.parse(v).tile
        ts, ps = kl.run_plain(*args, v, tiles=torch.tensor([N // T - 1]))
        assert torch.equal(ts, t[-T:]) and torch.equal(ps, p[-T:])
    t3, p3 = kl.run(*args, "v3")
    assert bool((p3 >= 0).any())
    nodes = kl.ray_walk_steps(*args)
    assert 0 < nodes < kl.run_plain(*args, "nodes", stats=True)[2]["ray_steps"]
    assert not [k for k in spans.counters() if k.startswith("launch.")]


@pytest.mark.parametrize("window", [32, 128])
def test_tables_follow_the_layout_window(reference_native, window):
    """`tables` carry the layout's window; the MT variants drain it (a
    `_t<N>` at the window is the same walk, and every variant still finds
    the oracle's hits); plk's 64-slot blocks take layouts up to 64."""
    spans.reset()
    js, _, tab, ro, rd, t0 = _setup()
    tw = kl.tables(with_trl_layout(tab["scene"], window=window))
    assert tw["window"] == window and tw["recs"].shape[0] != tab["recs"].shape[0]
    args = (tw, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(t0))
    t, p = kl.run(*args, "wide8")
    tt, pt = kl.run(*args, f"wide8_t{window}")
    assert torch.equal(t, tt) and torch.equal(p, pt)
    t64, p64 = kl.run(tab, *args[1:], "wide8")
    assert float((p == p64).float().mean()) >= 0.999
    if window > kl.PLK_SLOTS:
        assert tw["emat"].shape[0] == 0 and tw["pids"].shape == (0, kl.PLK_SLOTS)
        with pytest.raises(ValueError, match="does not fit"):
            kl.run(*args, "plk")
    else:
        assert tw["emat"].shape[1:] == (4 * kl.PLK_SLOTS,) and tw["pids"].shape[0] > 0
        assert bool((kl.run(*args, "plk")[1] >= 0).any())
    assert not [k for k in spans.counters() if k.startswith("launch.")]


def test_kernel_lab_rejects_bad_arguments(reference_native):
    spans.reset()
    _, _, tab, ro, rd, t0 = _setup()
    args = (tab, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(t0))
    for bad in ("noext", "wide12", "wide16_x", "spec4", "v4"):
        with pytest.raises(ValueError, match="unknown kernel_lab variant"):
            kl.run(*args, bad)
    # a drain under the layout's window skips slots: refused on the
    # window-64 layout, taken on a layout cut at 32, where it drains all
    with pytest.raises(ValueError, match="ATEN_TRL_WINDOW"):
        kl.run(*args, "wide16_t32")
    tab32 = kl.tables(with_trl_layout(tab["scene"], window=32))
    assert tab32["window"] == 32 and kl.drain_of(tab32, kl.parse("wide16_t32")) == 32
    t32, p32 = kl.run(tab32, *args[1:], "wide16_t32")
    tw, pw = kl.run(tab32, *args[1:], "wide16")
    assert torch.equal(t32, tw) and torch.equal(p32, pw) and bool((p32 >= 0).any())
    with pytest.raises(ValueError, match="skips slots"):
        kl.run(tab32, *args[1:], "wide16_t24")
    with pytest.raises(ValueError, match="on meta"):
        kl.run({**tab, "nodes": tab["nodes"].to("meta")}, *args[1:], "wide8")
    with pytest.raises(ValueError, match="unsupported device"):
        kl.run({k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in tab.items()},
               *(a.to("meta") for a in args[1:]), "wide8")
    with pytest.raises(ValueError, match="whole tiles"):
        kl.run(tab, *(a[:1000] for a in args[1:]), "wide8")
    assert not [k for k in spans.counters() if k.startswith("launch.")]
    with pytest.raises(ValueError, match="unknown kernel_lab variant"):
        kl.main(["kernel_lab", "noext"])
    if not torch.cuda.is_available():  # the CLI measures on a card only
        with pytest.raises(SystemExit, match="no CUDA card"):
            kl.main(["kernel_lab", "wide16"])
    # on the window-64 layout, wide16 drains the 64 slots wide16_t64 names
    assert kl.parse("spec") == kl.parse("spec8")
    assert kl.drain_of(tab, kl.parse("wide16_t64")) == kl.drain_of(tab, kl.parse("wide16")) == 64
    assert kl.parse("wide16_nc").kernel == "kernel_lab_wide16_nc"
