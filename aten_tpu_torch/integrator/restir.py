"""ReSTIR: reservoir spatiotemporal importance resampling of direct light
at the primary hit, alone (restir_direct_sample) or followed by path
traced bounces (restir_gi_sample, full GI).

Counterpart of aten_tpu/integrator/restir.py (the reference's
restir_types.h:9-76 Reservoir {w_sum, M, y, W, target_pdf_of_y} with its
streaming update; restir_impl.h: GenerateInitialCandidate :127,
EvaluateVisibility :219, ApplyTemporalReuse :275, ApplySpatialReuse
:446, ComputePixelColor :583).  The reservoir takes NEE's place at the
primary hit.  Reservoirs are flat per-pixel arrays and every pass is
batched select arithmetic on the scene's device: eager PyTorch, with no
kernel of its own; rays go through accel/traverse.py (`impl`).

The 32 candidates, the 4 spatial neighbours and the GI bounces are
Python loops that thread the sampler state in the reference's order, so
the port draws the reference's numbers.  The history and the spatial
neighbours are read with one index per field; the reference packs the
fields into one wide take, a TPU gather schedule that changes no value.

A candidate's target p-hat is the luminance of its unshadowed
contribution f*cos*Le*G in the measure it was sampled in, and q its
sampling pdf.  A spot light's falloff is folded into the stored
radiance when it is a candidate (the reference's approximation, kept).
"""
from __future__ import annotations

import torch

from aten_tpu_torch.accel.traverse import occluded, traverse, traverse_sorted
from aten_tpu_torch.core import camera as cam_mod
from aten_tpu_torch.core import sampler as smp
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.integrator.pathtracer import check_scene, eval_hit
from aten_tpu_torch.scene import textures as tex_mod
from aten_tpu_torch.scene.envmap import eval_env
from aten_tpu_torch.scene.lights import sample_light
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.shading import brdf as brdf_mod
from aten_tpu_torch.shading import nee

M_CANDIDATES = 32  # initial light candidates (the reference's M)
SPATIAL_NEIGHBORS = 4
SPATIAL_RADIUS = 8
TEMPORAL_M_CAP = 20  # clamp of the history's influence (restir_impl.h)

# the kinds of a reservoir's light sample
KIND_AREA = 0
KIND_SINGULAR = 1
KIND_INFINITE = 2

_EMISSIVE = int(MaterialType.EMISSIVE)
_SPECULAR = int(MaterialType.SPECULAR)
_REFRACTION = int(MaterialType.REFRACTION)
_Y_FIELDS = ("l_pos", "l_nml", "l_le")


def _empty_reservoir(N, device):
    z3 = torch.zeros((N, 3), dtype=torch.float32, device=device)
    z = torch.zeros((N,), dtype=torch.float32, device=device)
    return {
        "w_sum": z, "m": z,
        "target": z,  # p-hat of the kept sample
        "W": z,
        "l_pos": z3, "l_nml": z3,
        "l_le": z3,  # raw radiance (before the geometry term)
        "kind": torch.zeros((N,), dtype=torch.int32, device=device),
    }


def _eval_candidate(mat, p, ns, wo, y, used):
    """Re-evaluate a stored light sample y at a surface: (contrib [N,3],
    target [N], wi, dist)."""
    n = brdf_mod.orient_normal(ns, wo)
    is_inf = y["kind"] == KIND_INFINITE
    to_l = torch.where(is_inf[..., None], -y["l_nml"], y["l_pos"] - p)
    dist = torch.where(is_inf, 1e30, vm.length(to_l, keepdims=False))
    wi = torch.where(is_inf[..., None], -y["l_nml"],
                     to_l / torch.clamp(dist[..., None], min=1e-12))
    cos_s = torch.clamp(vm.dot(n, wi, keepdims=False), min=0.0)
    f = brdf_mod.eval_bsdf_pdf(mat, ns, wo, wi, used)[0]
    d2 = torch.clamp(dist * dist, min=1e-8)
    cos_l = torch.clamp(vm.dot(y["l_nml"], -wi, keepdims=False), min=0.0)
    geom = torch.where(y["kind"] == KIND_AREA, cos_l / d2,
                       torch.where(is_inf, 1.0, 1.0 / d2))
    contrib = f * y["l_le"] * (cos_s * geom)[..., None]
    target = vm.luminance(contrib)[..., 0]
    return contrib, target, wi, dist


def _light_sample_to_y(ls):
    """A sample_light() result as a reservoir's light-sample fields: area
    lights and IBL keep le as sampled; a singular light keeps its raw
    intensity (the distance is applied again at evaluation)."""
    kind = torch.where(ls["singular"], KIND_SINGULAR,
                       torch.where(ls["infinite"], KIND_INFINITE, KIND_AREA)).to(torch.int32)
    dist2 = torch.clamp(ls["dist"] * ls["dist"], min=1e-8)[..., None]
    le_store = torch.where(ls["singular"][..., None], ls["le"] * dist2, ls["le"])
    return {"l_pos": ls["pos"], "l_nml": ls["nml"], "l_le": le_store, "kind": kind}


def _take(r, y, take, target):
    out = {k: torch.where(take[..., None], y[k], r[k]) for k in _Y_FIELDS}
    out["kind"] = torch.where(take, y["kind"], r["kind"])
    out["target"] = torch.where(take, target, r["target"])
    return out


def _reservoir_update(r, y, w, u):
    """Streaming reservoir update (restir_types.h:40-76)."""
    w_sum = r["w_sum"] + w
    take = (u * torch.clamp(w_sum, min=1e-20)) < w
    return dict(r, w_sum=w_sum, m=r["m"] + 1.0, **_take(r, y, take, y["target"]))


def _merge_reservoir(r, r2, target_of_y2_here, u, m_cap=None):
    """Merge r2 into r, re-targeted at r's surface (ApplyTemporalReuse,
    ApplySpatialReuse)."""
    m2 = r2["m"] if m_cap is None else torch.clamp(r2["m"], max=m_cap)
    w2 = target_of_y2_here * r2["W"] * m2
    w_sum = r["w_sum"] + w2
    take = (u * torch.clamp(w_sum, min=1e-20)) < w2
    return dict(r, w_sum=w_sum, m=r["m"] + m2, **_take(r, r2, take, target_of_y2_here))


def _finalize_W(r):
    W = r["w_sum"] / torch.clamp(r["m"] * r["target"], min=1e-20)
    return dict(r, W=torch.where(r["target"] > 0, W, 0.0))


def _select(mask, a, b):
    """Per-lane a where mask else b, over every field of two reservoirs."""
    return {k: torch.where(mask[..., None] if a[k].ndim == 2 else mask, a[k], b[k])
            for k in b}


def init_state(height, width, device):
    """The empty history on `device`: no pixel valid, no previous camera."""
    N = height * width
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return {
        "reservoir": _empty_reservoir(N, device),
        "normal": torch.zeros((N, 3), dtype=torch.float32, device=device),
        "depth": torch.full((N,), -1.0, dtype=torch.float32, device=device),
        "valid": torch.zeros((N,), dtype=torch.bool, device=device),
        "mtl": torch.full((N,), -1, dtype=torch.int32, device=device),
        "mesh": torch.full((N,), -1, dtype=torch.int32, device=device),
        # the previous camera's basis, for motion reprojection
        "cam": {"origin": z3, "right": z3, "up": z3, "forward": z3},
    }


def _reproject_prev_pixel(prev_cam, p, width, height):
    """The previous frame's pixel of world point p under the previous
    pinhole camera, and whether it lies in that frame (the reference reads
    a rasterized motion buffer, restir_impl.h:344-357; the analytic
    reprojection covers camera motion)."""
    d = p - prev_cam["origin"]
    f = prev_cam["forward"]
    r = prev_cam["right"]
    u = prev_cam["up"]
    k = vm.dot(d, f, keepdims=False) / torch.clamp(torch.sum(f * f), min=1e-12)
    ks = torch.clamp(k, min=1e-6)
    s = 0.5 + vm.dot(d, r, keepdims=False) / (ks * torch.clamp(torch.sum(r * r), min=1e-12))
    t = 0.5 + vm.dot(d, u, keepdims=False) / (ks * torch.clamp(torch.sum(u * u), min=1e-12))
    pxp = torch.floor(s * width).to(torch.int32)
    pyp = (float(height - 1) - torch.floor(t * height)).to(torch.int32)
    ok = (k > 0) & (pxp >= 0) & (pxp < width) & (pyp >= 0) & (pyp < height)
    idx = torch.clamp(pyp * width + pxp, 0, width * height - 1)
    return idx, ok


def _shadowed(scene, r, h, n_or, wi, dist, impl):
    """The winner's shadow ray, kept off an area emitter's own surface
    (nee.shadow_distance)."""
    cos_lw = vm.dot(r["l_nml"], -wi, keepdims=False)
    dist2 = torch.where(r["kind"] == KIND_AREA, nee.shadow_distance(dist, cos_lw), dist)
    return occluded(scene, h["p"] + n_or * 1e-3, wi, dist2, impl=impl)


def _direct_core(scene, cam_arrays, width, height, state, st, rd, hit, h, mat, impl):
    """ReSTIR direct light at a batch of primary hits: initial candidates,
    visibility, temporal reuse, spatial reuse, shade.  Shared by the
    direct and the GI renderers, so the direct pass's sample streams are
    the same in both.  Returns (color [N,3], new_state, sampler state)."""
    used = scene["used_mtl_types"]
    dev = rd.device
    N = width * height
    num_lights = scene["num_lights"]
    wo = -rd
    n_or = brdf_mod.orient_normal(h["ns"], wo)
    is_emis = mat["type"] == _EMISSIVE
    shadeable = hit["hit"] & ~is_emis

    # initial candidates (GenerateInitialCandidate, restir_impl.h:127)
    r = _empty_reservoir(N, dev)
    pdf_sel = 1.0 / max(num_lights, 1)
    for _ in range(M_CANDIDATES):
        u_pick, st = smp.next_1d(st)
        ua, ub, st = smp.next_2d(st)
        uc, st = smp.next_1d(st)
        ur, st = smp.next_1d(st)
        lidx = torch.clamp((u_pick * num_lights).to(torch.int32), max=num_lights - 1)
        ls = sample_light(scene, lidx, h["p"], uc, (ua, ub))
        y = _light_sample_to_y(ls)
        _, target, _, _ = _eval_candidate(mat, h["p"], h["ns"], wo, y, used)
        # the proposal pdf in the sample's own measure
        q = torch.where(ls["singular"], pdf_sel, ls["pdf"] * pdf_sel)
        w = torch.where(q > 0, target / torch.clamp(q, min=1e-20), 0.0)
        r = _reservoir_update(r, dict(y, target=target), w, ur)
    r = _finalize_W(r)

    # visibility of the winner (EvaluateVisibility, restir_impl.h:219)
    _, _, wi_win, dist_win = _eval_candidate(mat, h["p"], h["ns"], wo, r, used)
    blocked = _shadowed(scene, r, h, n_or, wi_win, dist_win, impl)
    r = dict(r, W=torch.where(blocked, 0.0, r["W"]))

    # temporal reuse (ApplyTemporalReuse, restir_impl.h:275-400): the
    # reprojected history, accepted by IsAcceptableNeighbor's tests
    # (material type, mesh id, normal >= 0.95) and a depth test
    ridx, in_range = _reproject_prev_pixel(state["cam"], h["p"], width, height)
    ridx = ridx.long()
    prev = {k: v[ridx] for k, v in state["reservoir"].items()}
    ndot = vm.dot(h["ns"], state["normal"][ridx], keepdims=False)
    depth_ok = torch.abs(state["depth"][ridx] - hit["t"]) < 0.1 * torch.clamp(hit["t"],
                                                                           min=1e-3)
    accept = (state["valid"][ridx] & in_range & shadeable & (ndot >= 0.95)
              & (state["mtl"][ridx] == mat["type"]) & (state["mesh"][ridx] == h["mesh"])
              & depth_ok)
    _, target_prev_here, _, _ = _eval_candidate(mat, h["p"], h["ns"], wo, prev, used)
    ut, st = smp.next_1d(st)
    merged = _finalize_W(_merge_reservoir(r, prev, target_prev_here, ut,
                                          m_cap=TEMPORAL_M_CAP * 1.0))
    r = _select(accept, merged, r)

    # spatial reuse (ApplySpatialReuse, restir_impl.h:446): each
    # neighbour is read from the reservoirs as the last merge left them
    pix = torch.arange(N, dtype=torch.int64, device=dev)
    ix = pix % width
    iy = pix // width
    for _ in range(SPATIAL_NEIGHBORS):
        ua, ub, st = smp.next_2d(st)
        us, st = smp.next_1d(st)
        dx = ((ua * 2.0 - 1.0) * SPATIAL_RADIUS).to(torch.int32)
        dy = ((ub * 2.0 - 1.0) * SPATIAL_RADIUS).to(torch.int32)
        jx = torch.clamp(ix + dx, 0, width - 1)
        jy = torch.clamp(iy + dy, 0, height - 1)
        j = jy * width + jx
        rj = {k: v[j] for k, v in r.items()}
        geo_ok = (vm.dot(h["ns"], h["ns"][j], keepdims=False) > 0.9) & (
            torch.abs(hit["t"][j] - hit["t"]) < 0.1 * torch.clamp(hit["t"], min=1e-3))
        _, target_j_here, _, _ = _eval_candidate(mat, h["p"], h["ns"], wo, rj, used)
        merged = _finalize_W(_merge_reservoir(r, rj, target_j_here, us))
        r = _select(geo_ok, merged, r)

    # final shade (ComputePixelColor, restir_impl.h:583)
    contrib, _, wi_f, dist_f = _eval_candidate(mat, h["p"], h["ns"], wo, r, used)
    blocked_f = _shadowed(scene, r, h, n_or, wi_f, dist_f, impl)
    color = contrib * torch.where(blocked_f, 0.0, r["W"])[..., None]
    # emissive surfaces show their own radiance; misses the background
    color = torch.where(shadeable[..., None], color, 0.0)
    emis_vis = hit["hit"] & is_emis & (vm.dot(h["ng"], -rd, keepdims=False) > 0)
    color = color + torch.where(emis_vis[..., None], mat["base_color"], 0.0)
    color = color + torch.where(hit["hit"][..., None], 0.0, scene["bg"])
    color = torch.where(torch.isfinite(color), color, 0.0)

    new_state = {
        "reservoir": r,
        "normal": h["ns"],
        "depth": hit["t"],
        "valid": shadeable,
        "mtl": mat["type"],
        "mesh": h["mesh"],
        "cam": {k: cam_arrays[k] for k in ("origin", "right", "up", "forward")},
    }
    return color, new_state, st


def _primary(scene, cam_arrays, width, height, frame, impl):
    """The primary rays (pinhole, one jittered sample a pixel), their hits
    and materials, and the sampler state after the jitter."""
    check_scene(scene)
    N = width * height
    pix = torch.arange(N, dtype=torch.int64, device=scene.device)
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    pixel_seed = smp.wang_hash(pix + 1)
    st = smp.make_state(pixel_seed, frame, 0, 1, bounce=0)
    ju, jv, st = smp.next_2d(st)
    s = (px + ju) / width
    t = (float(height - 1) - py + jv) / height
    ro, rd = cam_mod.generate_ray(cam_arrays, s, t)
    hit = traverse(scene, ro, rd, impl=impl)
    h = eval_hit(scene, ro, rd, hit)
    mat = gather_material(scene["materials"], h["mtl"])
    return rd, hit, h, mat, st, pixel_seed


def restir_direct_sample(scene, cam_arrays, width, height, frame, state, impl="auto"):
    """One frame of ReSTIR direct light: (image [H, W, 3], new state)."""
    rd, hit, h, mat, st, _ = _primary(scene, cam_arrays, width, height, frame, impl)
    color, new_state, _ = _direct_core(scene, cam_arrays, width, height, state, st, rd,
                                       hit, h, mat, impl)
    return color.reshape(height, width, 3), new_state


def restir_gi_sample(scene, cam_arrays, width, height, frame, state, max_depth=5,
                     rr_depth=3, impl="auto"):
    """One frame of the full ReSTIR renderer: reservoir direct light at
    bounce 0, then NEE path tracing for bounces 1 .. max_depth - 1, summed
    into one image (libidaten/restir/restir.cpp:47-128: OnShadeReSTIR at
    bounce 0, the standard shade and hitShadowRay beyond).  An emitter
    hit by the bounce-0 BSDF ray keeps the balance-heuristic weight, the
    reservoir playing NEE's part in it.  Returns (image, new state)."""
    rd, hit, h, mat, st, pixel_seed = _primary(scene, cam_arrays, width, height, frame, impl)
    N = width * height
    color, new_state, st = _direct_core(scene, cam_arrays, width, height, state, st, rd,
                                        hit, h, mat, impl)

    # the bounce-0 continuation: a BSDF sample at the primary hit
    wo = -rd
    used = scene["used_mtl_types"]
    alive = hit["hit"] & (mat["type"] != _EMISSIVE)
    u1, u2, st = smp.next_2d(st)
    u3, st = smp.next_1d(st)
    samp = brdf_mod.sample_brdf(mat, h["ns"], wo, u1, u2, u3, used)
    n_or = brdf_mod.orient_normal(h["ns"], wo)
    cos_wi = torch.abs(vm.dot(n_or, samp["wi"], keepdims=False))
    good = (samp["pdf"] > 1e-9) & (cos_wi > 1e-9)
    pdf_det = torch.clamp(samp["pdf"], min=1e-9).detach()
    throughput = torch.where((alive & good)[..., None],
                             samp["bsdf"] * (cos_wi / pdf_det)[..., None], 0.0)
    alive = alive & good
    off_n = torch.where(samp["transmission"][..., None], -n_or, n_or)
    ro = (h["p"] + off_n * 1e-3).detach()
    rd = samp["wi"].detach()
    pdf_prev = samp["pdf"]
    prev_singular = samp["singular"]

    # bounces >= 1: NEE path tracing (the path tracer's semantics)
    def occ_fn(a):
        return lambda o, d, dist: occluded(scene, o, d, torch.where(a, dist, 0.0), impl=impl)

    radiance = torch.zeros((N, 3), dtype=torch.float32, device=rd.device)
    for bounce in range(1, max_depth):
        hit = traverse_sorted(scene, ro, rd, t_max=torch.where(alive, vm.INF, 0.0), impl=impl)
        h = eval_hit(scene, ro, rd, hit)
        mat = gather_material(scene["materials"], h["mtl"])
        mat = tex_mod.apply_albedo(scene, mat, h["uv"])
        mat = tex_mod.apply_roughness_map(scene, mat, h["uv"])
        h["ns"] = tex_mod.apply_normal_map(scene, mat, h["ns"], h["uv"])

        miss = alive & ~hit["hit"]
        le_bg, w_bg = scene["bg"], 1.0
        if "envmap" in scene:
            le_bg = eval_env(scene, rd)
            w_bg = nee.env_miss_weight(scene, rd, pdf_prev, prev_singular)[..., None]
        radiance = radiance + torch.where(miss[..., None], throughput * le_bg * w_bg, 0.0)

        state = smp.make_state(pixel_seed, frame, 0, 1, bounce=bounce + 1)
        is_emis = mat["type"] == _EMISSIVE
        cos_l = vm.dot(h["ng"], -rd, keepdims=False)
        w_imp = nee.implicit_light_weight(scene, h["light"], pdf_prev, prev_singular,
                                          hit["t"], cos_l)
        w_imp = torch.where(h["light"] >= 0, w_imp, 1.0)
        radiance = radiance + torch.where(
            (alive & hit["hit"] & is_emis & (cos_l > 0))[..., None],
            throughput * mat["base_color"] * w_imp[..., None], 0.0)
        alive = alive & hit["hit"] & ~is_emis

        wo = -rd
        contrib, state = nee.nee_contribution(scene, mat, h["p"], h["ns"], wo, state,
                                              occ_fn(alive), used)
        is_sing = (mat["type"] == _SPECULAR) | (mat["type"] == _REFRACTION)
        radiance = radiance + torch.where((alive & ~is_sing)[..., None],
                                          throughput * contrib, 0.0)

        u_rr, state = smp.next_1d(state)
        if bounce >= rr_depth:
            rr_p = torch.clamp(torch.amax(throughput, dim=-1), 0.01, 0.95).detach()
        else:
            rr_p = torch.ones_like(u_rr)
        alive = alive & (u_rr < rr_p)
        throughput = throughput / rr_p[..., None]

        u1, u2, state = smp.next_2d(state)
        u3, state = smp.next_1d(state)
        samp = brdf_mod.sample_brdf(mat, h["ns"], wo, u1, u2, u3, used)
        n_or = brdf_mod.orient_normal(h["ns"], wo)
        cos_wi = torch.abs(vm.dot(n_or, samp["wi"], keepdims=False))
        good = (samp["pdf"] > 1e-9) & (cos_wi > 1e-9)
        pdf_det = torch.clamp(samp["pdf"], min=1e-9).detach()
        throughput = torch.where((alive & good)[..., None],
                                 throughput * samp["bsdf"] * (cos_wi / pdf_det)[..., None],
                                 throughput)
        alive = alive & good
        off_n = torch.where(samp["transmission"][..., None], -n_or, n_or)
        ro = (h["p"] + off_n * 1e-3).detach()
        rd = samp["wi"].detach()
        pdf_prev = samp["pdf"]
        prev_singular = samp["singular"]

    bad = ~torch.all(torch.isfinite(radiance), dim=-1) | torch.any(radiance < 0, dim=-1)
    indirect = torch.where(bad[..., None], 0.0, radiance)
    return (color + indirect).reshape(height, width, 3), new_state


class ReSTIRRenderer:
    """Counterpart of ReSTIRRenderer / idaten::ReSTIRPathTracing
    (restir/restir.cpp:570, libidaten/restir/restir.cpp:47): reservoir
    direct light at bounce 0 and path tracing beyond (gi=True), or the
    direct light alone (gi=False), on the scene's device."""

    def __init__(self, scene, cam, gi=True, max_depth=5, rr_depth=3, impl="auto"):
        self.scene = scene
        self.cam = cam
        self.cam_arrays = cam.arrays(scene.device)
        self.state = init_state(cam.height, cam.width, scene.device)
        self.frame = 0
        self.gi = gi
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.impl = impl

    def render_frame(self):
        if self.gi:
            img, self.state = restir_gi_sample(
                self.scene, self.cam_arrays, self.cam.width, self.cam.height, self.frame,
                self.state, max_depth=self.max_depth, rr_depth=self.rr_depth,
                impl=self.impl)
        else:
            img, self.state = restir_direct_sample(
                self.scene, self.cam_arrays, self.cam.width, self.cam.height, self.frame,
                self.state, impl=self.impl)
        self.frame += 1
        return img
