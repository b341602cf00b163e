"""LBVH build on the scene's device (Morton codes, sort, Karras tree,
threaded links), for scenes whose geometry changes every frame.

Counterpart of aten_tpu/accel/lbvh.py, whose arrays it gives bitwise:

- the uint32 arithmetic of the Morton codes, `_popcount32`, `_clz32`
  and the augmented common-prefix length runs in int64 lanes; every
  constant mask is below 2^32, so each masked product keeps the low
  bits the uint32 product wraps to, and the one unmasked product
  (`_popcount32`'s) takes an explicit `& 0xFFFFFFFF`;
- `jnp.argsort` is `torch.sort(..., stable=True)`: JAX's sort is
  stable, and equal codes keep their index order;
- the Karras range and split searches are fixed-count, branch-free
  loops over all internal nodes at once (extra probes are no-ops, the
  predicates being monotone), and the bottom-up refit and the miss-link
  propagation run a fixed `depth_bound(P)` iterations.

Nothing in the build reads a value back to the host: no `.item()`, no
boolean-mask indexing, no `nonzero`; shapes follow from P alone.

Outputs the threaded node schema of accel/build.py: internal nodes at
[0, P-1), leaves at [P-1, 2P-1), one prim a leaf, root = node 0.
`rebuild_scene_bvh` replaces a scene's tree with one built from its
current triangles and spheres and attaches K1's packed records of it
(ops/bvh_layout.py::lbvh_layout, the tree renumbered into preorder).
"""
from __future__ import annotations

import torch

from aten_tpu_torch.ops import bvh_layout
from aten_tpu_torch.scene.scene import Scene, without_kernel_layouts

MORTON_BITS = 10  # 10 bits an axis -> 30-bit codes, as the reference's 32-bit keys
U32 = 0xFFFFFFFF


def _expand_bits32(v):
    """Interleave 10 bits of v with two zero bits (uint32 values)."""
    v = v & ((1 << MORTON_BITS) - 1)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(cent, bmin, bmax):
    """[P, 3] centroids -> [P] int64 Morton codes (uint32 values) within
    the box [bmin, bmax]."""
    ext = torch.clamp(bmax - bmin, min=1e-12)
    q = torch.clamp((cent - bmin) / ext, 0.0, 1.0 - 1e-7)
    ql = (q * (1 << MORTON_BITS)).to(torch.int64)
    return ((_expand_bits32(ql[:, 0]) << 2) | (_expand_bits32(ql[:, 1]) << 1)
            | _expand_bits32(ql[:, 2]))


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def _clz32(x):
    """Leading zeros of uint32 values (bit smear, then popcount)."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return 32 - _popcount32(x)


def search_steps(P):
    """The Karras searches' iterations for P prims."""
    return max(1, P.bit_length() + 1)


def depth_bound(P):
    """Iterations of the fixed-depth loops: the distinct-prefix chain (<=
    30) and a duplicate-code group's index subtree (<= log2 P)."""
    return min(64, 31 + search_steps(P))


def build_lbvh(bmin, bmax):
    """Threaded-BVH tensors over P >= 2 primitive boxes bmin, bmax [P, 3]
    float32, on their device: the node schema of accel/build.py, the
    node arrays int32."""
    P = bmin.shape[0]
    if P < 2:
        raise ValueError(f"build_lbvh needs at least 2 primitives, got {P}")
    dev = bmin.device
    cent = (bmin + bmax) * 0.5
    codes = morton3d(cent, torch.amin(bmin, 0), torch.amax(bmax, 0))
    codes, order = torch.sort(codes, stable=True)
    prim_order = order.to(torch.int32)

    n_int = P - 1
    i = torch.arange(n_int, dtype=torch.int64, device=dev)

    def delta(a, b):
        """Augmented common-prefix length (Karras: equal codes fall back
        to the index bits); -1 where b is out of range."""
        ok = (b >= 0) & (b < P)
        bc = torch.clamp(b, 0, P - 1)
        x = codes[a] ^ codes[bc]
        dup = 32 + _clz32(a ^ bc)
        return torch.where(ok, torch.where(x == 0, dup, _clz32(x)), -1)

    # Karras 2012: each node's direction, range length and split
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)
    steps = search_steps(P)
    # exponential upper bound on the range length (a failed probe stays
    # failed, so a fixed step count is safe)
    lmax = torch.full((n_int,), 2, dtype=torch.int64, device=dev)
    for _ in range(steps):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)
    # binary search of the exact length l (the predicate is monotone in l)
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(steps + 1):
        go = (t > 0) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(go, l + t, l)
        t = t // 2
    j = i + l * d
    delta_node = delta(i, j)
    # binary search of the split s: the largest s with delta(i, i+s*d) > delta_node
    s = torch.zeros_like(i)
    t = l
    for _ in range(steps + 1):
        t = (t + 1) // 2
        go = (delta(i, i + (s + t) * d) > delta_node) & (s + t < l)
        s = torch.where(go, s + t, s)
    gamma = i + s * d + torch.clamp(d, max=0)

    left = torch.where(torch.minimum(i, j) == gamma, n_int + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, n_int + gamma + 1, gamma + 1)

    K = 2 * P - 1
    parent = torch.full((K,), -1, dtype=torch.int64, device=dev)
    parent = parent.index_put((left,), i).index_put((right,), i)
    is_left = torch.zeros(K, dtype=torch.bool, device=dev).index_put(
        (left,), torch.ones_like(left, dtype=torch.bool))
    sibling = torch.full((K,), -1, dtype=torch.int64, device=dev)
    sibling = sibling.index_put((left,), right).index_put((right,), left)
    iters = depth_bound(P)

    # bottom-up box refit
    zeros = torch.zeros((n_int, 3), dtype=torch.float32, device=dev)
    nb_min = torch.cat([zeros, bmin[order]])
    nb_max = torch.cat([zeros, bmax[order]])
    for _ in range(iters):
        nb_min = torch.cat([torch.minimum(nb_min[left], nb_min[right]), nb_min[n_int:]])
        nb_max = torch.cat([torch.maximum(nb_max[left], nb_max[right]), nb_max[n_int:]])

    # threaded links: miss(n) = its sibling if a left child, else
    # miss(parent); hit(internal) = its left child, hit(leaf) = miss(leaf)
    miss = torch.full((K,), -1, dtype=torch.int64, device=dev)
    has_parent = parent >= 0
    take_sibling = is_left & (sibling >= 0)
    pidx = torch.clamp(parent, min=0)
    for _ in range(iters):
        miss = torch.where(take_sibling, sibling, torch.where(has_parent, miss[pidx], -1))
    node = torch.arange(K, dtype=torch.int64, device=dev)
    is_leaf = node >= n_int
    hit = torch.where(is_leaf, miss, left[torch.clamp(node, 0, n_int - 1)])
    return {
        "nodes_bmin": nb_min,
        "nodes_bmax": nb_max,
        "nodes_hit": hit.to(torch.int32),
        "nodes_miss": miss.to(torch.int32),
        "nodes_prim_start": torch.where(is_leaf, node - n_int, -1).to(torch.int32),
        "nodes_prim_count": is_leaf.to(torch.int32),
        "prim_order": prim_order,
    }


def tri_boxes(v0, e1, e2, pad=1e-5):
    """AABBs of triangles given the pre-expanded v0/e1/e2 scene arrays."""
    p1 = v0 + e1
    p2 = v0 + e2
    bmin = torch.minimum(torch.minimum(v0, p1), p2) - pad
    bmax = torch.maximum(torch.maximum(v0, p1), p2) + pad
    return bmin, bmax


def rebuild_scene_bvh(scene: Scene) -> Scene:
    """`scene`, a single-level scene, with an LBVH built on its device from
    its current triangle and sphere arrays in place of its tree (`nodes_*`,
    `prim_order`), and K1's packed records of that tree (`bvh_nodes`,
    `bvh_prims`).  Every other kernel layout and its statics (`plk_*`,
    `trl_*`, `traversal`, the windows) are dropped, so the scene runs K1
    and no kernel walks a layout of the old geometry."""
    if scene["num_instances"]:
        raise ValueError("rebuild_scene_bvh: only single-level scenes; this one has instances")
    if scene.get("has_voxel_lod"):
        raise ValueError("rebuild_scene_bvh: a voxel-LOD scene's annotation is of its old tree")
    num_tris, num_sph = scene["num_tris"], scene["num_spheres"]
    boxes = []
    if num_tris:
        boxes.append(tri_boxes(scene["tri_v0"][:num_tris], scene["tri_e1"][:num_tris],
                               scene["tri_e2"][:num_tris]))
    if num_sph:
        c = scene["sph_center"][:num_sph]
        r = scene["sph_radius"][:num_sph, None]
        boxes.append((c - r - 1e-5, c + r + 1e-5))
    tree = build_lbvh(torch.cat([b[0] for b in boxes]), torch.cat([b[1] for b in boxes]))
    layout = bvh_layout.lbvh_layout(
        tree, depth_bound(num_tris + num_sph), scene["tri_v0"], scene["tri_e1"],
        scene["tri_e2"], scene["sph_center"], scene["sph_radius"], num_tris)
    scene = without_kernel_layouts(scene)
    return Scene({**scene.arrays, **tree, **layout}, scene.static, scene.device)
