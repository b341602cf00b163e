"""Volumetric path tracer (surfaces and participating media).

Counterpart of aten_tpu/integrator/volpt.py (the reference's
VolumePathTracing, volume_pathtracing.cpp and volume_pathtracing_impl.h):
the path tracer's bounce loop with a per-path medium stack.  Inside a
medium the free path is sampled (analytic when homogeneous, delta
tracking through a grid; volume/medium.py); a scatter event does HG-phase
NEE with a shadow ray that punches through transmissive boundaries
(TraverseRayInMedium, :111-210) and continues in an HG-sampled
direction; crossing a transmissive surface pushes or pops the medium
(UpdateMedium, :24-48).

The medium stack is MEDIUM_STACK_DEPTH slots a path ([N, 8] ids and a
[N] size); push, pop and top are masked writes and gathers, bit for bit
the reference's.  The shadow walk makes up to SHADOW_PUNCH_MAX
closest-hit walks (t_min 1e-3, t_max the segment left): an entering or
non-medium hit occludes, an exiting medium hit multiplies in the current
medium's transmittance over the sub-segment and pops.  Each walk takes
only the lanes still active and the loop ends when none is, which
changes no lane's result.  Walks go through `traverse` (`impl` selects
it: accel/traverse.py), so a mesh scene runs K1.

Seeding is the reference's: the CMJ states by (pixel, frame, sample,
bounce), and the tracking seed pixel_seed ^ (bounce * 0x27D4EB2F) ^
frame in uint32.  As in the reference, the Russian-roulette probability,
the BSDF pdf in the throughput and the next ray are detached.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.accel.traverse import traverse
from aten_tpu_torch.core import camera as cam_mod
from aten_tpu_torch.core import sampler as smp
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.integrator.pathtracer import MAX_LANES, check_scene, eval_hit
from aten_tpu_torch.scene.envmap import eval_env
from aten_tpu_torch.scene.lights import sample_light
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.shading import brdf as brdf_mod
from aten_tpu_torch.shading import nee
from aten_tpu_torch.utils import spans
from aten_tpu_torch.volume.medium import hg_phase, hg_sample, sample_medium_distance, transmittance

SHADOW_PUNCH_MAX = 10  # reference max_lookups (pathtracing_impl.h:290)
MEDIUM_STACK_DEPTH = 8  # the reference's per-path stack (misc/stack.h)
T_FAR = 1e8

_EMISSIVE = int(MaterialType.EMISSIVE)
_SPECULAR = int(MaterialType.SPECULAR)
_REFRACTION = int(MaterialType.REFRACTION)


def _stack_top(mstack, msize):
    """Current medium id (-1 when the stack is empty)."""
    idx = torch.clamp(msize - 1, 0, MEDIUM_STACK_DEPTH - 1).long()
    top = torch.gather(mstack, 1, idx[:, None])[:, 0]
    return torch.where(msize > 0, top, -1)


def _stack_push(mstack, msize, mid, do):
    slots = torch.arange(MEDIUM_STACK_DEPTH, dtype=torch.int32, device=mstack.device)[None, :]
    ok = do & (msize < MEDIUM_STACK_DEPTH)
    write = ok[:, None] & (slots == msize[:, None])
    mstack = torch.where(write, mid[:, None], mstack)
    return mstack, torch.where(ok, msize + 1, msize)


def _stack_pop(msize, do):
    return torch.where(do & (msize > 0), msize - 1, msize)


def _update_medium(mstack, msize, transmitted, entering, mat, active):
    """UpdateMedium: a transmitted crossing that enters pushes the
    material's medium (if it has one); one that exits pops."""
    has_med = mat["medium"] >= 0
    mstack, msize = _stack_push(
        mstack, msize, mat["medium"], active & transmitted & entering & has_med)
    msize = _stack_pop(msize, active & transmitted & ~entering)
    return mstack, msize


def _shadow_transmittance(scene, ro, rd, dist, mstack, msize, seed, impl="auto"):
    """RGB transmittance along shadow segments [N] of length dist (0: no
    shadow ray), through the medium stack's boundaries.  Each walk reads
    its live count once, a host sync counted in "host_sync.shadow"
    (utils/spans.py)."""
    N = ro.shape[0]
    tr = torch.ones((N, 3), dtype=torch.float32, device=ro.device)
    lane = torch.nonzero(dist > 0.0).squeeze(1)
    spans.count("host_sync.shadow")
    o, d, rem, ms, mz, sd = ro[lane], rd[lane], dist[lane], mstack[lane], msize[lane], seed[lane]
    trl = tr[lane]
    for k in range(SHADOW_PUNCH_MAX):
        if not lane.numel():
            break
        cur_med = _stack_top(ms, mz)
        hit = traverse(scene, o, d, t_max=rem, t_min=1e-3, impl=impl)
        seg = torch.where(hit["hit"], hit["t"], rem)
        trl = trl * transmittance(scene, cur_med, o, d, seg, (sd + k) & smp._M32)
        h = eval_hit(scene, o, d, hit)
        mat = gather_material(scene["materials"], h["mtl"])
        has_med = mat["medium"] >= 0
        entering = vm.dot(-d, h["ns"], keepdims=False) > 0.0
        blocked = hit["hit"] & (~has_med | entering)
        trl = torch.where(blocked[..., None], 0.0, trl)
        tr[lane] = trl
        # exiting a medium surface: pop and go on straight through
        cont = hit["hit"] & ~blocked
        ms, mz = _update_medium(ms, mz, torch.ones_like(entering), entering, mat, cont)
        o = torch.where(cont[..., None], h["p"] + d * 1e-3, o)
        rem = torch.where(cont, torch.clamp(rem - seg - 1e-3, min=0.0), rem)
        keep = torch.nonzero(cont & (rem > 0.0)).squeeze(1)  # the walk's one sync
        lane, o, d, rem, ms, mz, sd, trl = (
            lane[keep], o[keep], d[keep], rem[keep], ms[keep], mz[keep], sd[keep], trl[keep])
        spans.count("host_sync.shadow")
    return tr


def _trace_volpt(scene, cam_arrays, width, height, frame, sample, spp, max_depth, rr_depth,
                 spp_chunk=1, impl="auto"):
    """Radiance [width*height, 3] averaged over samples [sample, sample +
    spp_chunk); lane c*W*H + p traces sample `sample + c` of pixel p."""
    dev = scene.device
    n_pix = width * height
    N = n_pix * spp_chunk
    lane = torch.arange(N, dtype=torch.int64, device=dev)
    pix = lane % n_pix
    samp_idx = sample + lane // n_pix
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    pixel_seed = smp.wang_hash(pix + 1)
    state0 = smp.make_state(pixel_seed, frame, samp_idx, spp, bounce=0)
    ju, jv, state0 = smp.next_2d(state0)
    s = (px + ju) / width
    t = (float(height - 1) - py + jv) / height
    ro, rd = cam_mod.generate_ray(cam_arrays, s, t)

    radiance = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((N, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    pdf_prev = torch.ones((N,), dtype=torch.float32, device=dev)
    prev_singular = torch.ones((N,), dtype=torch.bool, device=dev)
    mstack = torch.full((N, MEDIUM_STACK_DEPTH), -1, dtype=torch.int32, device=dev)
    msize = torch.zeros((N,), dtype=torch.int32, device=dev)
    num_lights = scene["num_lights"]
    has_media = "med_sigma_a" in scene

    for bounce in range(max_depth):
        medium = _stack_top(mstack, msize)
        # dead lanes walk nothing (t_max 0); their results are masked below
        hit = traverse(scene, ro, rd, t_max=torch.where(alive, vm.INF, 0.0), impl=impl)
        h = eval_hit(scene, ro, rd, hit)
        mat = gather_material(scene["materials"], h["mtl"])
        t_surf = torch.where(hit["hit"], hit["t"], T_FAR)

        state = smp.make_state(pixel_seed, frame, samp_idx, spp, bounce=bounce + 1)
        u_dist, state = smp.next_1d(state)
        u_chan, state = smp.next_1d(state)
        med_seed = pixel_seed ^ smp._mul32(bounce, 0x27D4EB2F) ^ (frame & smp._M32)

        if has_media:
            ms = sample_medium_distance(scene, medium, ro, rd, t_surf, u_dist, u_chan, med_seed,
                                        active=alive)
        else:
            zero3 = torch.zeros((N, 3), dtype=torch.float32, device=dev)
            ms = {"t": t_surf, "scattered": torch.zeros_like(alive),
                  "weight": torch.ones_like(zero3), "g": torch.zeros_like(t_surf),
                  "le": zero3, "sigma_a": zero3}
        in_medium = medium >= 0
        throughput = torch.where((alive & in_medium)[..., None], throughput * ms["weight"],
                                 throughput)
        scattered = alive & in_medium & ms["scattered"]

        # volume scatter event: NEE through the medium, then an HG bounce
        p_s = ro + ms["t"][..., None] * rd
        u_pick, state = smp.next_1d(state)
        ua, ub, state = smp.next_2d(state)
        uc, state = smp.next_1d(state)
        if num_lights > 0:
            lidx = torch.clamp((u_pick * num_lights).to(torch.int32), max=num_lights - 1)
            ls = sample_light(scene, lidx, p_s, uc, (ua, ub))
            cos_sc = vm.dot(-rd, ls["dir"], keepdims=False)
            ph = hg_phase(ms["g"], cos_sc)
            # no shadow ray (dist 0) for lanes without a scatter event
            tr = _shadow_transmittance(
                scene, p_s, ls["dir"], torch.where(scattered, ls["dist"] * 0.999, 0.0),
                mstack, msize, med_seed, impl=impl)
            dist2 = torch.clamp(ls["dist"] * ls["dist"], min=1e-8)
            cos_l = torch.clamp(vm.dot(ls["nml"], -ls["dir"], keepdims=False), min=0.0)
            geom = torch.where(ls["area_measure"], cos_l / dist2, torch.ones_like(cos_l))
            pdf_sel = 1.0 / num_lights
            nee_vol = (ls["le"] * tr * (ph * geom)[..., None]
                       / torch.clamp(ls["pdf"] * pdf_sel, min=1e-12)[..., None])
            radiance = radiance + torch.where(scattered[..., None], throughput * nee_vol, 0.0)
        # the HG continuation (phase / pdf == 1)
        uh1, uh2, state = smp.next_2d(state)
        wi_vol, _ = hg_sample(ms["g"], -rd, uh1, uh2)

        # surface interaction (lanes that reached the surface)
        at_surface = alive & ~scattered & hit["hit"]
        miss = alive & ~scattered & ~hit["hit"]
        if "envmap" in scene:
            le_bg = eval_env(scene, rd)
            w_bg = nee.env_miss_weight(scene, rd, pdf_prev, prev_singular)
        else:
            le_bg = scene["bg"]
            w_bg = torch.ones((N,), dtype=torch.float32, device=dev)
        radiance = radiance + torch.where(miss[..., None], throughput * le_bg * w_bg[..., None],
                                          0.0)

        is_emis = mat["type"] == _EMISSIVE
        cos_lg = vm.dot(h["ng"], -rd, keepdims=False)
        w_imp = nee.implicit_light_weight(scene, h["light"], pdf_prev, prev_singular, hit["t"],
                                          cos_lg)
        w_imp = torch.where(h["light"] >= 0, w_imp, 1.0)
        radiance = radiance + torch.where(
            (at_surface & is_emis & (cos_lg > 0))[..., None],
            throughput * mat["base_color"] * w_imp[..., None], 0.0)

        surf_alive = at_surface & ~is_emis
        wo = -rd
        # surface NEE with transmittance-aware shadow rays
        u_pick2, state = smp.next_1d(state)
        ua2, ub2, state = smp.next_2d(state)
        uc2, state = smp.next_1d(state)
        if num_lights > 0:
            lidx2 = torch.clamp((u_pick2 * num_lights).to(torch.int32), max=num_lights - 1)
            ls2 = sample_light(scene, lidx2, h["p"], uc2, (ua2, ub2))
            n_or = brdf_mod.orient_normal(h["ns"], wo)
            cos_s = vm.dot(n_or, ls2["dir"], keepdims=False)
            f2, pdf_b2 = brdf_mod.eval_bsdf_pdf(mat, h["ns"], wo, ls2["dir"],
                                                scene["used_mtl_types"])
            cos_l2 = torch.clamp(vm.dot(ls2["nml"], -ls2["dir"], keepdims=False), min=0.0)
            dist_sh2 = torch.where(ls2["area_measure"], nee.shadow_distance(ls2["dist"], cos_l2),
                                   ls2["dist"] * 0.999)
            is_sing_mat = (mat["type"] == _SPECULAR) | (mat["type"] == _REFRACTION)
            nee_need = surf_alive & ~is_sing_mat & (cos_s > 0)
            tr2 = _shadow_transmittance(
                scene, h["p"] + n_or * 1e-3, ls2["dir"], torch.where(nee_need, dist_sh2, 0.0),
                mstack, msize, (med_seed + 7) & smp._M32, impl=impl)
            dist2b = torch.clamp(ls2["dist"] * ls2["dist"], min=1e-8)
            pdf_sel = 1.0 / num_lights
            pdf_b_area = pdf_b2 * cos_l2 / dist2b
            w_area = nee.mis_balance(ls2["pdf"] * pdf_sel, pdf_b_area)
            c_area = (f2 * ls2["le"] * tr2
                      * (torch.clamp(cos_s, min=0.0) * cos_l2 / dist2b)[..., None]
                      / torch.clamp(ls2["pdf"] * pdf_sel, min=1e-12)[..., None]
                      * w_area[..., None])
            c_sing = (f2 * ls2["le"] * tr2 * torch.clamp(cos_s, min=0.0)[..., None]
                      / max(pdf_sel, 1e-12))
            contrib = torch.where(ls2["area_measure"][..., None], c_area, c_sing)
            radiance = radiance + torch.where(nee_need[..., None], throughput * contrib, 0.0)

        # Russian roulette, its probability detached
        u_rr, state = smp.next_1d(state)
        if bounce >= rr_depth:
            rr_p = torch.clamp(torch.amax(throughput, dim=-1), 0.01, 0.95).detach()
        else:
            rr_p = torch.ones_like(u_rr)
        alive = alive & (u_rr < rr_p)
        throughput = throughput / rr_p[..., None]

        # surface BSDF sample, its pdf detached in the weight
        u1, u2, state = smp.next_2d(state)
        u3, state = smp.next_1d(state)
        samp = brdf_mod.sample_brdf(mat, h["ns"], wo, u1, u2, u3, scene["used_mtl_types"])
        n_or = brdf_mod.orient_normal(h["ns"], wo)
        cos_wi = torch.abs(vm.dot(n_or, samp["wi"], keepdims=False))
        good = (samp["pdf"] > 1e-9) & (cos_wi > 1e-9)
        pdf_det = torch.clamp(samp["pdf"], min=1e-9).detach()
        weight = samp["bsdf"] * (cos_wi / pdf_det)[..., None]
        throughput = torch.where((surf_alive & good)[..., None], throughput * weight, throughput)

        # the medium stack on transmission (UpdateMedium)
        entering = vm.dot(h["ns"], wo, keepdims=False) > 0.0
        mstack, msize = _update_medium(mstack, msize, samp["transmission"], entering, mat,
                                       surf_alive)

        # the next ray, detached: the volume scatter's or the surface bounce's
        off_n = torch.where(samp["transmission"][..., None], -n_or, n_or)
        ro_s = h["p"] + off_n * 1e-3
        ro = torch.where(scattered[..., None], p_s, ro_s).detach()
        rd = torch.where(scattered[..., None], wi_vol, samp["wi"]).detach()

        alive = alive & (scattered | (surf_alive & good))
        pdf_prev = torch.where(scattered, 1.0, samp["pdf"])
        prev_singular = torch.where(scattered, True, samp["singular"])

    bad = ~torch.all(torch.isfinite(radiance), dim=-1) | torch.any(radiance < 0, dim=-1)
    radiance = torch.where(bad[..., None], 0.0, radiance)
    if spp_chunk > 1:
        radiance = radiance.reshape(spp_chunk, n_pix, 3).mean(dim=0)
    return radiance


def render_volpt_sample(scene, cam_arrays, width, height, frame, sample, spp=1, max_depth=8,
                        rr_depth=4, spp_chunk=1, impl="auto"):
    """The mean of samples [sample, sample + spp_chunk) of spp, [height,
    width, 3]."""
    check_scene(scene)
    rad = _trace_volpt(scene, cam_arrays, width, height, frame, sample, spp, max_depth,
                       rr_depth, spp_chunk=spp_chunk, impl=impl)
    return rad.reshape(height, width, 3)


def render_volpt(scene, cam, spp=8, max_depth=8, rr_depth=4, frame=0, impl="auto"):
    """The mean of spp samples of camera `cam`, [H, W, 3], on the scene's
    device, as many samples a dispatch as MAX_LANES lanes hold (lowered
    to a divisor of spp).  A sample's lanes give the same values in any
    dispatch, so this changes only the order of the sum over samples."""
    ca = cam.arrays(scene.device)
    spp_chunk = max(1, min(spp, MAX_LANES // (cam.width * cam.height)))
    while spp % spp_chunk:
        spp_chunk -= 1
    acc = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32, device=scene.device)
    for s in range(0, spp, spp_chunk):
        acc = acc + render_volpt_sample(scene, ca, cam.width, cam.height, frame, s, spp,
                                        max_depth, rr_depth, spp_chunk=spp_chunk,
                                        impl=impl) * spp_chunk
    return acc / spp
