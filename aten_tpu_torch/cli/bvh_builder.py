"""Offline BVH build and export: the counterpart of
aten_tpu/cli/bvh_builder.py (the reference's SbvhBuilder tool).  Loads an
OBJ, builds its threaded BVH over the triangles' boxes (SAH, or a
spatial-split SBVH) with the same builder as the library, and writes the
arrays to an .npz that `SceneBuilder.build(bvh_cache=...)` reads when
its prim count matches.  A host tool: it uses no card.

    python -m aten_tpu_torch.cli.bvh_builder model.obj -o model.bvh.npz
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="aten_tpu_torch.cli.bvh_builder")
    p.add_argument("obj")
    p.add_argument("-o", "--output", required=True, help=".npz cache path")
    p.add_argument("--leaf-max", type=int, default=4)
    p.add_argument("--spatial-splits", action="store_true",
                   help="SBVH build: allow duplicated clipped references "
                        "where they lower the SAH cost")
    p.add_argument("--alpha", type=float, default=1e-5,
                   help="spatial-split trigger: child-overlap area over "
                        "root area threshold")
    args = p.parse_args(argv)

    import numpy as np

    from aten_tpu_torch.accel.build import build_bvh, build_sbvh
    from aten_tpu_torch.scene.objloader import load_obj
    from aten_tpu_torch.scene.scene import SceneBuilder

    sb = SceneBuilder()
    load_obj(sb, args.obj)
    t0 = time.perf_counter()
    faces = sb._face_array()[:, :3]
    pos = sb._positions()
    p0, p1, p2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    bmin = np.minimum(np.minimum(p0, p1), p2) - 1e-5
    bmax = np.maximum(np.maximum(p0, p1), p2) + 1e-5
    if args.spatial_splits:
        bvh = build_sbvh(bmin, bmax, leaf_max=args.leaf_max, alpha=args.alpha)
    else:
        bvh = build_bvh(bmin, bmax, leaf_max=args.leaf_max)
    dt = time.perf_counter() - t0
    np.savez_compressed(args.output, **bvh)
    print(f"{len(faces)} tris -> {bvh['nodes_bmin'].shape[0]} nodes, "
          f"{bvh['prim_order'].shape[0]} references in {dt:.2f}s -> {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
