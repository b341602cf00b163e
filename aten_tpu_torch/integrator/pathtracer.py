"""NEE path-tracing integrator, batched over (sample, pixel) lanes.

Counterpart of aten_tpu/integrator/pathtracer.py (the reference's
GeneratePath, ShadeMiss, HitImplicitLight, FillShadowRay, Russian
roulette and PrepareForNextBounce).  Every lane is one pixel sample;
terminated lanes are masked, not compacted.  Lanes are in scan order:
the reference's lane->pixel block swizzle only groups rays for TPU tile
votes and permutes nothing per pixel, so it is left out.

Seeding uses global pixel ids and the (frame, sample, bounce) of each
draw, exactly as the reference, so the port draws the reference's
random numbers bit for bit.

Each bounce applies the scene's albedo, roughness and normal maps at the
hit's uv, then the car-paint flake fields, before shading; a miss picks
up the envmap, MIS-weighted against its image-based light, or the
background colour.  In a scene that uses a toon family, each bounce
then evaluates the toon term (shading/toon.py) on every lane: a toon
hit adds it like an emitter at bounce 0 and ends its path at any depth.

`_trace_paths` traces a band of rows [y0, y0 + tile_h), seeded by the
global pixel id, so a band is bitwise the same rows of the whole image
(the unit of parallel/mesh.py's row sharding).

A voxel-LOD scene (accel/voxel.py) resolves a voxel hit on the entry
face of the node's box, with the node's dominant material shaded as
DIFFUSE and no light.

Cameras: pinhole, thin-lens (its lens sample drawn from the CMJ stream
after the pixel jitter) and equirect, by the static `cam_type`.  The
sampler "bluenoise" takes the pixel jitter and each bounce's three BSDF
dimensions from core/bluenoise.py's masks in place of the CMJ draws,
which are still drawn, as in the reference.

A scene with a stencil material (`has_stencil`) resolves its primary
rays through STENCIL surfaces to the ALWAYS surface behind them
(`_resolve_stencil`).  A scene with alpha below 1 (`has_alpha`) sends
its shadow rays through accel/traverse.py::occlusion_alpha, and at each
hit draws one more number: with probability 1 - alpha (the material's
times its albedo map's) the path punches through, straight on with its
MIS state, and neither shades nor ends there.

Spans and counters (utils/spans.py, recorded only while recording is
on): `render_image` is the "render" root span; each bounce of
`_trace_paths` counts its N lanes in "lanes.issued.<bounce>", tallies
its live lanes (those whose walk can still hit) on the device in
"lanes.live.<bounce>", and records its shading in two "shade" spans,
one between the closest-hit walk and NEE and one after NEE.

`render_sample_with_aovs` (want_aovs=True) also returns the first-hit
G-buffer of the reference's FillAOVs (svgf_impl.h:63; the reference's
pathtracer.py:339-350, :383-398): normal (shading, after the normal
map), depth (the hit's t), albedo (base colour after the albedo map),
pos, prim, mtl and inst (the instance, -1 outside two-level scenes),
taken at bounce 0 where the ray hits, from the first sample of the
chunk.  A missed lane keeps depth -1, ids -1 and zero vectors.
"""
from __future__ import annotations

import torch

from aten_tpu_torch.accel.tlas import apply_affine
from aten_tpu_torch.accel.traverse import occluded, occlusion_alpha, traverse, traverse_sorted
from aten_tpu_torch.core import camera as cam_mod
from aten_tpu_torch.core import sampler as smp
from aten_tpu_torch.core import vecmath as vm
from aten_tpu_torch.core.bluenoise import BlueNoiseSampler
from aten_tpu_torch.integrator.film import Film
from aten_tpu_torch.scene import textures as tex_mod
from aten_tpu_torch.scene.envmap import eval_env
from aten_tpu_torch.scene.materials import MaterialType, gather_material
from aten_tpu_torch.shading import brdf as brdf_mod
from aten_tpu_torch.shading import dispatch as disp_mod
from aten_tpu_torch.shading import nee
from aten_tpu_torch.shading.toon import toon_term
from aten_tpu_torch.utils import spans

_EMISSIVE = int(MaterialType.EMISSIVE)
_SPECULAR = int(MaterialType.SPECULAR)
_REFRACTION = int(MaterialType.REFRACTION)
_DIFFUSE = int(MaterialType.DIFFUSE)
_CAR_PAINT = int(MaterialType.CAR_PAINT)
_TOON = int(MaterialType.TOON)
_STYLIZED_BRDF = int(MaterialType.STYLIZED_BRDF)

# lanes per dispatch: 512x512x16 keeps the path state to a few hundred MB
MAX_LANES = 4 << 20
SAMPLERS = ("cmj", "bluenoise")
CAMERA_TYPES = ("pinhole", "thinlens", "equirect")


def check_scene(scene):
    """Raise NotImplementedError for material types the port lacks."""
    brdf_mod.check_used_types(scene.get("used_mtl_types"))


_BLUENOISE = {}


def _get_bluenoise(device):
    """The blue-noise sampler (64x64 masks, 4 layers) on `device`."""
    if device not in _BLUENOISE:
        _BLUENOISE[device] = BlueNoiseSampler(device=device)
    return _BLUENOISE[device]


def eval_hit(scene, ro, rd, hit):
    """Hit attributes (EvaluateHitResult.h:10-72): position, shading and
    geometric normals, uv (0.5 on spheres), material, light id and mesh
    id (spheres get (1 << 20) + sphere id).

    On an instanced hit the prim data is object-local: the sphere normal
    comes from the local position W2L*p, and both normals go to world
    space through the instance's normal matrix (W2L^T), renormalised.

    In a voxel-LOD scene a hit on a voxel (prim >= num_tris +
    num_spheres, the node prim - that) is resolved as the reference does
    (pathtracer.py:166-191): both normals are the axis normal of the box
    face the ray entered by, facing the ray; the material is the node's
    dominant one, the light id -1, and `is_voxel` marks such lanes."""
    prim = hit["prim"]
    num_tris = scene["num_tris"]
    T = scene["tri_v0"].shape[0]
    S = scene["sph_center"].shape[0]
    is_tri = prim < num_tris
    tid = torch.clamp(prim, 0, T - 1).long()
    sid = torch.clamp(prim - num_tris, 0, S - 1).long()
    # missed lanes carry t = INF; clamp so masked-out shading stays finite
    t_safe = torch.where(hit["hit"], hit["t"], 1.0)
    p = ro + t_safe[..., None] * rd
    instanced = "inst_nmtx" in scene and hit.get("inst") is not None
    if instanced:
        iid = torch.where(hit["inst"] >= 0, hit["inst"], scene["num_instances"]).long()
        p_loc = apply_affine(scene["inst_w2l"][iid], p[:, 0], p[:, 1], p[:, 2],
                             translate=True)
    else:
        p_loc = p

    u = hit["u"][..., None]
    v = hit["v"][..., None]
    w = 1.0 - u - v
    n0, n1, n2 = scene["tri_n0"][tid], scene["tri_n1"][tid], scene["tri_n2"][tid]
    e1, e2 = scene["tri_e1"][tid], scene["tri_e2"][tid]
    ns_tri = vm.normalize(w * n0 + u * n1 + v * n2)
    ng_tri = vm.normalize(vm.cross(e1, e2))
    uv_tri = w * scene["tri_uv0"][tid] + u * scene["tri_uv1"][tid] + v * scene["tri_uv2"][tid]

    c = scene["sph_center"][sid]
    r = scene["sph_radius"][sid][..., None]
    ns_sph = (p_loc - c) / torch.clamp(r, min=1e-12)

    m3 = is_tri[..., None]
    ns = torch.where(m3, ns_tri, ns_sph)
    ng = torch.where(m3, ng_tri, ns_sph)
    if instanced:
        nmtx = scene["inst_nmtx"][iid]
        ns = vm.normalize(apply_affine(nmtx, ns[:, 0], ns[:, 1], ns[:, 2], translate=False))
        ng = vm.normalize(apply_affine(nmtx, ng[:, 0], ng[:, 1], ng[:, 2], translate=False))
    out = {
        "p": p,
        "ns": ns,
        "ng": ng,
        "uv": torch.where(m3, uv_tri, 0.5),
        "mtl": torch.where(is_tri, scene["tri_mtl"][tid], scene["sph_mtl"][sid]),
        "light": torch.where(is_tri, scene["tri_light"][tid], scene["sph_light"][sid]),
        "mesh": torch.where(is_tri, scene["tri_mesh"][tid], (1 << 20) + sid.to(torch.int32)),
    }
    if scene.get("has_voxel_lod"):
        is_vox = prim >= num_tris + scene["num_spheres"]
        K = scene["nodes_bmin"].shape[0]
        node = torch.clamp(prim - (num_tris + scene["num_spheres"]), 0, K - 1).long()
        inv = torch.where(rd.abs() > 1e-12, 1.0 / rd, 1e12)
        t_a = (scene["nodes_bmin"][node] - ro) * inv
        t_b = (scene["nodes_bmax"][node] - ro) * inv
        axis = torch.argmax(torch.minimum(t_a, t_b), dim=-1)  # the entry face's axis
        n_vox = -torch.sign(rd) * torch.nn.functional.one_hot(axis, 3).to(rd.dtype)
        n_vox = vm.normalize(torch.where(vm.dot(n_vox, rd) < 0, n_vox, -rd))
        v3 = is_vox[..., None]
        out["ns"] = torch.where(v3, n_vox, out["ns"])
        out["ng"] = torch.where(v3, n_vox, out["ng"])
        out["mtl"] = torch.where(is_vox, scene["nodes_voxel_mtl"][node], out["mtl"])
        out["light"] = torch.where(is_vox, -1, out["light"])
        out["is_voxel"] = is_vox
    return out


def _resolve_stencil(scene, ro, rd, max_lookups=4, eps=1e-3, impl="auto"):
    """Bounce-0 stencil punch-through (CheckStencil, pathtracing_impl.h
    :612-678; the reference's pathtracer.py:195-223): where the primary
    hit is a STENCIL material (stencil 1), walk on through up to
    max_lookups surfaces for an ALWAYS one (stencil 2) facing the ray,
    and restart the ray just before it.  A NONE surface (stencil 0), an
    ALWAYS one facing away, a miss or exhausted lookups leave the ray as
    it was, so the stencil surface shades.  Only the lanes whose primary
    hit is a stencil walk on, which changes no lane's result."""
    hit0 = traverse(scene, ro, rd, impl=impl)
    h0 = eval_hit(scene, ro, rd, hit0)
    m0 = gather_material(scene["materials"], h0["mtl"])
    lane = torch.nonzero(hit0["hit"] & (m0["stencil"] == 1.0)).squeeze(1)
    ro_out = ro.clone()
    d = rd[lane]
    cur = h0["p"][lane] + d * eps
    for _ in range(max_lookups):
        if not lane.numel():
            break
        res = traverse(scene, cur, d, t_min=eps, impl=impl)
        h = eval_hit(scene, cur, d, res)
        stencil = gather_material(scene["materials"], h["mtl"])["stencil"]
        front = vm.dot(h["ns"], -d, keepdims=False) > 0.0
        take = res["hit"] & (stencil == 2.0) & front
        ro_out[lane[take]] = (h["p"] - d * eps)[take]
        go = res["hit"] & ~take & (stencil != 0.0) & ~((stencil == 2.0) & ~front)
        lane, d, cur = lane[go], d[go], (h["p"] + d * eps)[go]
    return ro_out


def _trace_paths(scene, cam_arrays, width, height, frame, sample, spp,
                 max_depth, rr_depth, spp_chunk=1, impl="auto", y0=0, tile_h=None,
                 cam_type="pinhole", sampler="cmj", want_aovs=False):
    """Radiance [tile_h*width, 3] of the rows [y0, y0 + tile_h) (default:
    the whole image), averaged over samples [sample, sample + spp_chunk);
    lane c*Npix + p traces sample `sample + c` of the band's pixel p, in
    scan order.  Seeds use the global pixel id, so a band equals the same
    rows of the whole image bit for bit.  cam_type: "pinhole",
    "thinlens" or "equirect" (`cam_arrays` of that camera); sampler:
    "cmj" or "bluenoise".  want_aovs: return (radiance, aovs), the
    first-hit G-buffer {normal, depth, albedo, pos, prim, mtl, inst} of
    the first sample, each [tile_h*width, ...]."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}: one of {SAMPLERS}")
    if cam_type not in CAMERA_TYPES:
        raise ValueError(f"unknown camera type {cam_type!r}: one of {CAMERA_TYPES}")
    dev = scene.device
    used = scene["used_mtl_types"]
    if tile_h is None:
        tile_h = height
    n_pix = width * tile_h
    N = n_pix * spp_chunk
    lane = torch.arange(N, dtype=torch.int64, device=dev)
    local = lane % n_pix
    samp_idx = sample + lane // n_pix
    px_i = local % width
    py_i = local // width + y0
    px = px_i.to(torch.float32)
    py = py_i.to(torch.float32)
    pixel_seed = smp.wang_hash(py_i * width + px_i + 1)

    state = smp.make_state(pixel_seed, frame, samp_idx, spp, bounce=0)
    ju, jv, state = smp.next_2d(state)
    if sampler == "bluenoise":
        # the blue-noise pixel jitter; the reference draws it from its
        # mask stack by (pixel, frame * 64 + sample, dimension)
        bn = _get_bluenoise(dev)
        fkey = frame * 64 + samp_idx
        ju = bn.sample(px, py, fkey, 0)
        jv = bn.sample(px, py, fkey, 1)
    s = (px + ju) / width
    t = (float(height - 1) - py + jv) / height
    if cam_type == "thinlens":
        # the lens sample comes from the same CMJ stream
        ul1, ul2, state = smp.next_2d(state)
        ro, rd = cam_mod.generate_ray_thinlens(cam_arrays, s, t, ul1, ul2)
    elif cam_type == "equirect":
        ro, rd = cam_mod.generate_ray_equirect(cam_arrays, s, t)
    else:
        ro, rd = cam_mod.generate_ray(cam_arrays, s, t)
    if scene.get("has_stencil"):
        ro = _resolve_stencil(scene, ro, rd, impl=impl)

    radiance = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((N, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    pdf_prev = torch.ones((N,), dtype=torch.float32, device=dev)
    prev_singular = torch.ones((N,), dtype=torch.bool, device=dev)

    # alpha-translucent scenes send shadow rays through the bounded
    # punch-through walk; opaque ones keep the binary any-hit test
    has_alpha = bool(scene.get("has_alpha"))

    def occluded_fn(o, d, dist):
        if has_alpha:
            return occlusion_alpha(scene, o, d, dist, impl=impl)
        return occluded(scene, o, d, dist, impl=impl)

    aovs = None
    if want_aovs:
        # what a lane keeps with no first hit (a miss, or max_depth 0)
        no_id = torch.full((N,), -1, dtype=torch.int32, device=dev)
        aovs = {"normal": torch.zeros_like(radiance), "depth": torch.full_like(pdf_prev, -1.0),
                "albedo": torch.zeros_like(radiance), "pos": torch.zeros_like(radiance),
                "prim": no_id, "mtl": no_id, "inst": no_id}

    for bounce in range(max_depth):
        if spans.active():
            spans.count(f"lanes.issued.{bounce}", N)
            spans.tally(f"lanes.live.{bounce}", alive)
        hit = traverse_sorted(
            scene, ro, rd, t_max=torch.where(alive, vm.INF, 0.0), impl=impl)
        with spans.span("shade"):
            h = eval_hit(scene, ro, rd, hit)
            mat = gather_material(scene["materials"], h["mtl"])
            # shade-time texture fetches, then the car-paint flakes at this uv
            mat = tex_mod.apply_albedo(scene, mat, h["uv"])
            mat = tex_mod.apply_roughness_map(scene, mat, h["uv"])
            h["ns"] = tex_mod.apply_normal_map(scene, mat, h["ns"], h["uv"])
            if _CAR_PAINT in used:
                mat = brdf_mod.carpaint_flake_fields(mat, h["uv"], h["ns"])
            if "is_voxel" in h:
                # voxel hits shade as DIFFUSE (FillMaterial, material_impl.h:232-262)
                mat["type"] = torch.where(h["is_voxel"], _DIFFUSE, mat["type"])
            if want_aovs and bounce == 0:
                # the first-hit G-buffer (FillAOVs, svgf_impl.h:63)
                first = hit["hit"]
                f3 = first[..., None]
                inst = hit.get("inst")
                aovs = {
                    "normal": torch.where(f3, h["ns"], aovs["normal"]),
                    "depth": torch.where(first, hit["t"], aovs["depth"]),
                    "albedo": torch.where(f3, mat["base_color"], aovs["albedo"]),
                    "pos": torch.where(f3, h["p"], aovs["pos"]),
                    "prim": torch.where(first, hit["prim"], aovs["prim"]),
                    "mtl": torch.where(first, h["mtl"], aovs["mtl"]),
                    "inst": (aovs["inst"] if inst is None
                             else torch.where(first, inst, aovs["inst"])),
                }

            # miss: the envmap, MIS-weighted against its light, or the background
            miss = alive & ~hit["hit"]
            le_bg, w_bg = scene["bg"], 1.0
            if "envmap" in scene:
                le_bg = eval_env(scene, rd)
                w_bg = nee.env_miss_weight(scene, rd, pdf_prev, prev_singular)[..., None]
            radiance = radiance + torch.where(miss[..., None], throughput * le_bg * w_bg, 0.0)

            # per-bounce sampler re-seed (reference bounce-dim offset)
            state = smp.make_state(pixel_seed, frame, samp_idx, spp, bounce=bounce + 1)

            # translucent-by-alpha punch-through (CheckMaterialTranslucentByAlpha,
            # pathtracing_impl.h:511-610): with probability 1 - alpha the path
            # goes on straight through the surface, stochastically (one ray)
            # where the reference blends
            if has_alpha:
                u_alpha, state = smp.next_1d(state)
                a_eff = mat["alpha"] * mat.get("tex_alpha", 1.0)
                punch = alive & hit["hit"] & (u_alpha >= a_eff)
            else:
                punch = torch.zeros_like(alive)

            # toon-as-light (HitTeminatedMaterial's toon branch): the term draws
            # from every lane's state, only in scenes that use a toon family;
            # at bounce 0 a live toon hit adds it like an emitter, and a toon
            # hit that does not punch through ends its path at any depth
            if _TOON in used or _STYLIZED_BRDF in used:
                is_toon = (mat["type"] == _TOON) | (mat["type"] == _STYLIZED_BRDF)
                t_rgb, state = toon_term(
                    scene, mat, h["p"], h["ns"], rd, state,
                    lambda o, d, dist, a=alive: occluded_fn(o, d, torch.where(a, dist, 0.0)),
                    stylized=mat["type"] == _STYLIZED_BRDF)
                if bounce == 0:
                    radiance = radiance + torch.where(
                        (alive & hit["hit"] & is_toon & ~punch)[..., None], throughput * t_rgb,
                        0.0)
                alive = alive & (~is_toon | punch)

            # implicit emitter hit (HitImplicitLight)
            is_emis = mat["type"] == _EMISSIVE
            cos_l = vm.dot(h["ng"], -rd, keepdims=False)
            hit_emit = alive & hit["hit"] & is_emis
            w_imp = nee.implicit_light_weight(
                scene, h["light"], pdf_prev, prev_singular, hit["t"], cos_l)
            w_imp = torch.where(h["light"] >= 0, w_imp, 1.0)
            front = cos_l > 0.0
            radiance = radiance + torch.where(
                (hit_emit & front & ~punch)[..., None],
                throughput * mat["base_color"] * w_imp[..., None],
                0.0,
            )
            alive = alive & hit["hit"] & (~is_emis | punch)

            wo = -rd
        # NEE, skipped for singular BSDFs; dead lanes pass dist 0
        contrib, state = nee.nee_contribution(
            scene, mat, h["p"], h["ns"], wo, state,
            lambda o, d, dist, a=alive: occluded_fn(o, d, torch.where(a, dist, 0.0)),
            used,
        )
        with spans.span("shade"):
            is_singular_mat = (mat["type"] == _SPECULAR) | (mat["type"] == _REFRACTION)
            nee_ok = alive & ~is_singular_mat & ~punch
            radiance = radiance + torch.where(nee_ok[..., None], throughput * contrib, 0.0)

            # Russian roulette (ComputeRussianProbability); the survival
            # probability is detached, as the reference detaches it, so RR
            # stays an unbiased estimator under autograd
            u_rr, state = smp.next_1d(state)
            if bounce >= rr_depth:
                rr_p = torch.clamp(torch.amax(throughput, dim=-1), 0.01, 0.95).detach()
            else:
                rr_p = torch.ones_like(u_rr)
            alive = alive & (u_rr < rr_p)
            throughput = throughput / rr_p[..., None]

            # BSDF sample + next ray (PrepareForNextBounce)
            u1, u2, state = smp.next_2d(state)
            u3, state = smp.next_1d(state)
            if sampler == "bluenoise":
                base = 2 + bounce * 3
                u1 = bn.sample(px, py, fkey, base)
                u2 = bn.sample(px, py, fkey, base + 1)
                u3 = bn.sample(px, py, fkey, base + 2)
            samp = disp_mod.sample_brdf(scene, mat, h["ns"], wo, u1, u2, u3, used)
            n_or = brdf_mod.orient_normal(h["ns"], wo)
            cos_wi = torch.abs(vm.dot(n_or, samp["wi"], keepdims=False))
            good = (samp["pdf"] > 1e-9) & (cos_wi > 1e-9)
            # detached-pdf estimator: E[d f / p_detached] = d E[f / p]
            pdf_det = torch.clamp(samp["pdf"], min=1e-9).detach()
            weight = samp["bsdf"] * (cos_wi / pdf_det)[..., None]
            throughput = torch.where(
                (alive & good & ~punch)[..., None], throughput * weight, throughput)
            alive = alive & (good | punch)

            # detached sampling: the next ray is a constant under autograd;
            # gradients flow through the bsdf and pdf values, not the warp.
            # Punch-through lanes go on straight through the surface, with
            # their direction and MIS state.
            off_n = torch.where(samp["transmission"][..., None], -n_or, n_or)
            ro_next = (h["p"] + off_n * 1e-3).detach()
            p3 = punch[..., None]
            ro = torch.where(p3, (h["p"] + rd * 1e-3).detach(), ro_next)
            rd = torch.where(p3, rd, samp["wi"].detach())
            pdf_prev = torch.where(punch, pdf_prev, samp["pdf"])
            prev_singular = torch.where(punch, prev_singular, samp["singular"])

    # invalid-radiance guard (Renderer::isInvalidColor)
    bad = ~torch.all(torch.isfinite(radiance), dim=-1) | torch.any(radiance < 0, dim=-1)
    radiance = torch.where(bad[..., None], 0.0, radiance)
    if spp_chunk > 1:
        radiance = radiance.reshape(spp_chunk, n_pix, 3).mean(dim=0)
    if want_aovs:
        return radiance, {k: v[:n_pix] for k, v in aovs.items()}
    return radiance


def render_sample(scene, cam_arrays, width, height, frame, sample, spp=1,
                  max_depth=5, rr_depth=3, spp_chunk=1, impl="auto",
                  cam_type="pinhole", sampler="cmj"):
    """Mean radiance [height, width, 3] of samples [sample, sample+spp_chunk)."""
    check_scene(scene)
    rad = _trace_paths(scene, cam_arrays, width, height, frame, sample, spp,
                       max_depth, rr_depth, spp_chunk=spp_chunk, impl=impl,
                       cam_type=cam_type, sampler=sampler)
    return rad.reshape(height, width, 3)


def render_sample_with_aovs(scene, cam_arrays, width, height, frame, sample, spp=1,
                            max_depth=5, rr_depth=3, impl="auto", y0=0, tile_h=None):
    """One sample's radiance [tile_h, width, 3] and its first-hit G-buffer
    (the SVGF input; the reference's pathtracer.py:612-624): {normal,
    albedo, pos [tile_h, width, 3] float32; depth [tile_h, width]
    float32; prim, mtl, inst [tile_h, width] int32}, of the rows
    [y0, y0 + tile_h) (default: the whole image, which the reference
    renders; a band is bitwise the same rows of it).  With max_depth 0
    no ray is traced: the AOVs are those of a miss, as the reference's."""
    check_scene(scene)
    tile_h = height if tile_h is None else tile_h
    rad, aovs = _trace_paths(scene, cam_arrays, width, height, frame, sample, spp,
                             max_depth, rr_depth, impl=impl, y0=y0, tile_h=tile_h,
                             want_aovs=True)
    return (rad.reshape(tile_h, width, 3),
            {k: v.reshape((tile_h, width) + tuple(v.shape[1:])) for k, v in aovs.items()})


def render_image(scene, cam, spp=16, max_depth=5, rr_depth=3, frame=0,
                 spp_chunk=None, impl="auto"):
    """Accumulate spp samples of camera `cam` on the scene's device,
    spp_chunk samples per dispatch (default: all of spp, capped at
    MAX_LANES lanes), lowered to a divisor of spp so every chunk weighs
    the same.  impl selects the traversal (see accel/traverse.py)."""
    with spans.span("render", scene.device):
        cam_type = cam_mod.camera_type_of(cam)
        cam_arrays = cam.arrays(scene.device)
        if spp_chunk is None:
            spp_chunk = max(1, min(spp, MAX_LANES // (cam.width * cam.height)))
        while spp % spp_chunk:
            spp_chunk -= 1
        acc = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32,
                          device=scene.device)
        for s in range(0, spp, spp_chunk):
            acc = acc + render_sample(
                scene, cam_arrays, cam.width, cam.height, frame, s, spp,
                max_depth, rr_depth, spp_chunk=spp_chunk, impl=impl, cam_type=cam_type,
            ) * spp_chunk
        return acc / spp


class PathTracer:
    """Progressive renderer (Renderer::render + FilmProgressive)."""

    def __init__(self, scene, cam, spp_per_frame=1, max_depth=5, rr_depth=3):
        self.cam_type = cam_mod.camera_type_of(cam)
        self.scene = scene
        self.cam = cam
        self.cam_arrays = cam.arrays(scene.device)
        self.spp_per_frame = spp_per_frame
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.frame = 0
        self.film = Film(cam.height, cam.width, scene.device)

    def render_frame(self):
        for s in range(self.spp_per_frame):
            img = render_sample(
                self.scene, self.cam_arrays, self.cam.width, self.cam.height,
                self.frame, s, self.spp_per_frame, self.max_depth,
                self.rr_depth, cam_type=self.cam_type,
            )
            self.film.accumulate(img)
        self.frame += 1
        return self.film.image()

    def reset(self):
        self.film.clear()
        self.frame = 0
