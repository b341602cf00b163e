"""The yardstick of the traversal kernel K1: bytes its work needs, and peaks.

Fixed here, in the benchmark, so that no change to the program moves it.
K1 is a BVH walk with a few operations per byte it reads, so its bound is
the memory one: each ray's record read once and its hit written once, and
the mesh's triangles read once a bounce.  Counts of rays come from the
benchmark's own reference trace of the render (benchmark/reference), never
from the program's counters, tensors or tree.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet, at the 700 W power limit
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3, at 700 W"

RAY_IN_BYTES = 28  # origin, direction (float3 each) and t_max
CLOSEST_OUT_BYTES = 16  # t, prim, u, v
ANY_OUT_BYTES = 8  # t, prim
TRI_BYTES = 36  # three float3 vertices


def k1_bytes(closest_rays, shadow_rays, num_tris, bounces):
    """Bytes K1 must move for `closest_rays` closest-hit and `shadow_rays`
    any-hit rays over a mesh of `num_tris` triangles read once in each of
    `bounces` bounces."""
    return (closest_rays * (RAY_IN_BYTES + CLOSEST_OUT_BYTES)
            + shadow_rays * (RAY_IN_BYTES + ANY_OUT_BYTES)
            + bounces * num_tris * TRI_BYTES)


def least_seconds(nbytes):
    """The least time in which the card moves `nbytes` at its peak."""
    return nbytes / PEAK_HBM_BYTES_PER_S
