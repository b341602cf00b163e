"""Traversal statistics: the work each ray's walk takes, per ray, per warp
and per 1024-ray tile.

    python -m aten_tpu_torch.tools.trav_stats [scene] [--device cpu]
        [--res 1024] [--kernel k1|k3|k4] [--knot N_UxN_V]

Counterpart of the reference's tools/trav_stats.py, which runs its
treelet kernel's `stats` variant on a TPU and prints node iterations and
leaf rows per 1024-ray tile.  On the card each thread walks its own ray,
so the port's kernels count per ray: K1's kStats instantiation node
steps and prim tests (ops/traverse_cuda.py, stats=True), K3's node steps,
fat leaves entered and slot tests (ops/plk_cuda.py, stats=True).  K4 has
no stats variant, in the reference or here: its counts come from its
plain version's per-ray counts (accel/traverse.py::_traverse_trl_plain),
which runs on the card as tensor code.  With --device cpu every count
comes from the plain versions.

Scenes (the reference's dragon, sponza and crytek need assets the
repository does not have, so the tool takes the port's fixtures):
  mesh      the 102,404-prim knot scene (procedural_mesh_scene), K1
  large     the 512,004-prim knot scene (large_mesh_scene), K3
  mesh@D    the mesh scene with voxel LOD at lod_depth D, K1-lod
            (mesh@15: K4-lod, the layout attached as with_trl_layout does)
  large@D   the large scene at lod_depth D, K3-lod
--kernel overrides the scene's kernel (attaching its layout); --knot
sets the knot's rings and segments (the CPU tests take small ones).

Rays: res^2 primary rays through pixel centres, ordered in 32x32 pixel
blocks as the reference orders them, so a warp is a block row of 32
rays and a 1024-ray tile (the reference's TILE) one block; the
closest-hit query, then an any-hit query of shadow rays from each hit
toward the centroid of the scene's emitting triangles (1e-3 back along
the ray, t in [1e-3, dist - 1e-3]), in the same order, compacted.

Per count it prints the per-ray mean, p50, p90, max and total; per warp
the mean of each warp's max and the ratio of the summed warp maxima to
the summed warp means (1.0 when every ray of a warp takes the same work,
the divergence a lock-step warp pays); and per tile the mean, p50, p90
and max of the tile's max (the iterations of a tile walked by one vote,
the reference's figure) and of its sum.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

WARP = 32
TILE = 1024  # the reference's TILE (aten_tpu/ops/traverse_pallas.py:37)
BLOCK = 32   # the pixel block of a tile
# the kernel each scene name runs
KERNEL_OF = {"mesh": "k1", "large": "k3"}
KERNELS = ("k1", "k3", "k4")


def parse_scene(name):
    """(base, lod_depth or None) of a scene name such as 'mesh@9'."""
    base, _, depth = name.partition("@")
    if base not in KERNEL_OF:
        raise ValueError(f"unknown scene {name!r}: mesh, large, mesh@D or large@D")
    return base, (int(depth) if depth else None)


def default_kernel(name):
    base, depth = parse_scene(name)
    return "k4" if (base, depth) == ("mesh", 15) else KERNEL_OF[base]


def build_scene(name, res, device, knot=None, kernel=None, log=print):
    """(scene, camera, kernel) of a scene name, with the layout of the
    kernel attached."""
    from aten_tpu_torch.accel.voxel import enable_voxel_lod
    from aten_tpu_torch.scene import scenedefs
    from aten_tpu_torch.scene.scene import with_bvh_layout, with_plk_layout, with_trl_layout

    base, depth = parse_scene(name)
    kernel = kernel or default_kernel(name)
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}: one of {KERNELS}")
    make = scenedefs.procedural_mesh_scene if base == "mesh" else scenedefs.large_mesh_scene
    kw = {} if knot is None else {"n_u": knot[0], "n_v": knot[1]}
    scene, cam = make(res, res, device=device, **kw)
    if depth is not None:
        scene = enable_voxel_lod(scene, lod_depth=depth, log=log)
    attach = {"k1": ("bvh_nodes", with_bvh_layout), "k3": ("plk_nodes", with_plk_layout),
              "k4": ("trl_nodes", with_trl_layout)}[kernel]
    if attach[0] not in scene:
        scene = attach[1](scene)
    return scene, cam, kernel


def block_order(res):
    """Pixel ids of a res x res image in 32x32 blocks, row by row in each."""
    ids = []
    for y0 in range(0, res, BLOCK):
        for x0 in range(0, res, BLOCK):
            yy, xx = np.mgrid[y0:min(y0 + BLOCK, res), x0:min(x0 + BLOCK, res)]
            ids.append((yy * res + xx).ravel())
    return np.concatenate(ids)


def primary_rays(cam, res, device):
    """The reference tool's rays: pixel centres, image row 0 at the top,
    in block order."""
    from aten_tpu_torch.core.camera import generate_ray

    pix = block_order(res)
    s = ((pix % res) + 0.5) / res
    t = ((res - 1 - pix // res) + 0.5) / res
    ro, rd = generate_ray(cam.arrays(device),
                          torch.tensor(s, dtype=torch.float32, device=device),
                          torch.tensor(t, dtype=torch.float32, device=device))
    return ro.contiguous(), rd.contiguous()


def light_centroid(scene):
    """The centroid of the emitting triangles' vertices."""
    lit = scene["tri_light"] >= 0
    v0, e1, e2 = scene["tri_v0"][lit], scene["tri_e1"][lit], scene["tri_e2"][lit]
    return torch.cat([v0, v0 + e1, v0 + e2]).mean(dim=0)


def shadow_rays(scene, ro, rd, t):
    """Shadow rays from the hits (ro + t rd, 1e-3 back along rd) toward
    the light centroid: (ro, rd, t_max)."""
    p = ro + (t - 1e-3)[:, None] * rd
    to = light_centroid(scene)[None, :] - p
    dist = torch.linalg.vector_norm(to, dim=1)
    return p.contiguous(), (to / dist[:, None]).contiguous(), dist - 1e-3


def walk_counts(kernel, scene, ro, rd, t0, any_hit, t_min):
    """(t, prim, {count: int32 [N]}) of one query through `kernel`'s
    stats: the kStats instantiations of K1 and K3 (their plain versions
    for CPU tensors), K4's plain version."""
    if kernel == "k1":
        from aten_tpu_torch.ops.traverse_cuda import bvh_traverse

        t, prim, _, _, counts = bvh_traverse(scene, ro, rd, t0, any_hit=any_hit,
                                             t_min=t_min, stats=True)
        return t, prim, counts
    if kernel == "k3":
        from aten_tpu_torch.ops.plk_cuda import plk_traverse

        return plk_traverse(scene, ro, rd, t0, any_hit=any_hit, t_min=t_min, stats=True)
    from aten_tpu_torch.accel.traverse import _traverse_trl_plain

    h, _ = _traverse_trl_plain(scene, ro, rd, t0, any_hit, t_min, stats=True)
    return h["t"], h["prim"], h["counts"]


def summarize(c):
    """Per ray, per warp and per tile figures of one count c [N]."""
    c = c.to(torch.int64).cpu().numpy()
    n = c.shape[0]

    def groups(size):
        pad = (-n) % size
        g = np.concatenate([c, np.zeros(pad, np.int64)]).reshape(-1, size)
        return g.max(axis=1), g.sum(axis=1), np.minimum(size, n - size * np.arange(g.shape[0]))

    def pct(x):
        return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
                "p90": float(np.percentile(x, 90)), "max": int(x.max())}

    wmax, wsum, wn = groups(WARP)
    tmax, tsum, _ = groups(TILE)
    return {"rays": n, "per_ray": {**pct(c), "total": int(c.sum())},
            "per_warp": {"max_mean": float(wmax.mean()),
                         "max_over_mean": float((wmax * wn).sum() / max(int(wsum.sum()), 1))},
            "per_tile": {"max": pct(tmax), "sum": pct(tsum)}}


def format_row(kind, name, s):
    r, w, t = s["per_ray"], s["per_warp"], s["per_tile"]
    return (f"{kind:7s} {name:10s} per ray: mean {r['mean']:.2f} p50 {r['p50']:.0f} "
            f"p90 {r['p90']:.0f} max {r['max']} total {r['total']} | per warp: max "
            f"{w['max_mean']:.2f}, max/mean {w['max_over_mean']:.3f} | per tile: max "
            f"mean {t['max']['mean']:.1f} p50 {t['max']['p50']:.0f} p90 {t['max']['p90']:.0f} "
            f"max {t['max']['max']}, sum mean {t['sum']['mean']:.0f} p50 "
            f"{t['sum']['p50']:.0f} p90 {t['sum']['p90']:.0f} max {t['sum']['max']}")


def run(name, device, res=1024, kernel=None, knot=None, log=print):
    """The tool on one scene: {kind: {count: summarize(...)}} for the
    closest-hit and any-hit queries, each row logged."""
    from aten_tpu_torch.accel.traverse import _t0_of

    scene, cam, kernel = build_scene(name, res, device, knot, kernel, log)
    n_prims = scene["num_tris"] + scene["num_spheres"]
    log(f"trav_stats {name}: {n_prims} prims, kernel {kernel}"
        f"{' (plain version: K4 has no stats variant)' if kernel == 'k4' else ''}, "
        f"{res}x{res} primary rays in {BLOCK}x{BLOCK} blocks")
    ro, rd = primary_rays(cam, res, scene.device)
    t0 = _t0_of(None, ro.shape[0], ro.device)
    t, prim, counts = walk_counts(kernel, scene, ro, rd, t0, False, 1e-4)
    hit = prim >= 0
    out = {"closest": {k: summarize(v) for k, v in counts.items()}}
    sro, srd, dist = shadow_rays(scene, ro[hit], rd[hit], t[hit])
    _, sprim, scounts = walk_counts(kernel, scene, sro, srd, dist, True, 1e-3)
    out["any"] = {k: summarize(v) for k, v in scounts.items()}
    log(f"trav_stats {name}: {int(hit.sum())} of {ro.shape[0]} primary rays hit; "
        f"{float((sprim >= 0).float().mean()):.4f} of their shadow rays are occluded")
    for kind, rows in out.items():
        for k, s in rows.items():
            log(f"trav_stats {name} {format_row(kind, k, s)}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", nargs="?", default="mesh")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--kernel", choices=KERNELS)
    ap.add_argument("--knot", help="knot rings x segments, e.g. 40x25")
    a = ap.parse_args(argv)
    from aten_tpu_torch.device import resolve_device

    knot = None if a.knot is None else tuple(int(x) for x in a.knot.split("x"))
    run(a.scene, resolve_device(a.device), a.res, a.kernel, knot)


if __name__ == "__main__":
    main()
