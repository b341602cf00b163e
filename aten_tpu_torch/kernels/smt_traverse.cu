// Closest-hit / any-hit traversal of the treelet-cut BVH along
// direction-ordered links, C rays ("chains") per thread.
//
// Replaces the TPU kernel `_make_smt_kernel`
// (aten_tpu/ops/traverse_pallas.py:1335, launched by `_traverse_smt_tiles`
// :1542, entry `traverse_pallas` :2136-2148).  The TPU kernel advances C
// independent 1024-ray tiles per grid step, each tile with one node
// cursor chosen by vote, so that the C dependent row loads of a step can
// overlap; a tile drains the fat leaf it latched on the previous step.
// Here one thread holds C rays and each loop iteration advances every
// live chain by one step: first the C node loads (a 32-byte node record
// and the ray's 8-byte link pair), which do not depend on each other, so
// the card can have them in flight together, then per chain the step in
// the plain version's order.  The TPU's tile vote and its `lax.cond`
// drain have no counterpart: each chain is one ray with its own cursor.
//
// What it computes is accel/traverse.py::_traverse_trl_plain, in the same
// operation order, built with --fmad=false so every float op rounds as
// the plain torch version does:
//   * each ray takes the link set of its ordering o = 2*axis + neg, the
//     dominant |component| with ties to x then y, `>= 0` positive;
//   * K4's safe inverse (1/d, or 1e12 for |d| <= 1e-12) and slab test;
//   * per step: the box test against the current t (any-hit rays that
//     already have a prim test no box); the drain of the leaf latched on
//     the previous step, slot by slot, Moller-Trumbore or the sphere test
//     with a strict `<`; the latch of this node's fat leaf if its box was
//     hit; the hit or miss link; an any-hit ray drops its cursor once it
//     has a prim, but still drains the leaf it latched;
//   * a ray with t0 <= t_min never walks.
// u/v come from accel/traverse.py::recompute_uv on the winner.
//
// Bound: each step is a dependent load of 40 B of node and links, then a
// fat leaf of up to 64 slot records of 48 B, read once per ray that
// drains it (the records of the 512k-prim scene, 26 MB, fit the 50 MB L2
// cache); ~25 operations per box test and ~53 per slot test.  The loads
// of the C chains are independent; the drain loops of the chains are
// not interleaved (each runs to its leaf's count), so a warp's time is
// set by its longest leaves.  Shared-memory leaf staging and persistent
// threads are later work.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;

// K4's safe inverse (traverse_pallas.py:1348-1351).
__device__ __forceinline__ float trl_safe_inv(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// _pick_ordering's rule (traverse_pallas.py:761-772) on one direction.
__device__ __forceinline__ int32_t pick_ordering(float dx, float dy, float dz) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const int32_t ox = dx >= 0.0f ? 0 : 1;
  const int32_t oy = dy >= 0.0f ? 2 : 3;
  const int32_t oz = dz >= 0.0f ? 4 : 5;
  return (ax >= ay && ax >= az) ? ox : (ay >= az ? oy : oz);
}

struct Chain {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t;
  int32_t cur, prim, pstart, pcount, ord;
};

// Tests slots ss .. ss+cnt-1 of the records in order; a hit with a
// smaller t than the ray's replaces it.  Record lanes: a = (v0 | centre,
// e1x | radius), b = (e1y e1z e2x e2y), c = (e2z, prim id, is_tri, 0).
__device__ __forceinline__ void drain_leaf(const float* __restrict__ recs,
                                           Chain& ch, float t_min) {
  const float4* rec =
      reinterpret_cast<const float4*>(recs) + 3 * static_cast<int64_t>(ch.pstart);
  for (int32_t j = 0; j < ch.pcount; ++j, rec += 3) {
    const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
    float tp = 0.0f, u, v;
    const bool hp =
        __float_as_int(c.z) > 0
            ? moller_trumbore_at(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ch.ox,
                                 ch.oy, ch.oz, ch.dx, ch.dy, ch.dz, t_min, tp, u, v)
            : sphere_at(a.x, a.y, a.z, a.w, ch.ox, ch.oy, ch.oz, ch.dx, ch.dy, ch.dz,
                        t_min, tp);
    if (hp && tp < ch.t) {
      ch.t = tp;
      ch.prim = __float_as_int(c.y);
    }
  }
}

template <bool kAnyHit, int C>
__global__ void __launch_bounds__(kBlock)
    smt_traverse_kernel(TrlView p, RayView r, float t_min) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kBlock * C) + threadIdx.x;
  const float4* __restrict__ nodes = reinterpret_cast<const float4*>(p.nodes);
  const int2* __restrict__ links = reinterpret_cast<const int2*>(p.links);
  Chain ch[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t i = base + static_cast<int64_t>(c) * kBlock;
    Chain& h = ch[c];
    h.cur = -1;
    h.prim = -1;
    h.pstart = -1;
    h.pcount = 0;
    if (i < r.n) {
      h.ox = r.ro[3 * i];
      h.oy = r.ro[3 * i + 1];
      h.oz = r.ro[3 * i + 2];
      h.dx = r.rd[3 * i];
      h.dy = r.rd[3 * i + 1];
      h.dz = r.rd[3 * i + 2];
      h.ix = trl_safe_inv(h.dx);
      h.iy = trl_safe_inv(h.dy);
      h.iz = trl_safe_inv(h.dz);
      h.ord = pick_ordering(h.dx, h.dy, h.dz);
      h.t = r.t0[i];
      h.cur = h.t > t_min ? 0 : -1;
    }
  }
  for (;;) {
    // the C node loads of this step, independent of each other
    float4 na[C], nb[C];
    int2 lk[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ch[c].cur >= 0) {
        const int64_t k = ch[c].cur;
        na[c] = __ldg(nodes + 2 * k);
        nb[c] = __ldg(nodes + 2 * k + 1);
        lk[c] = __ldg(links + 6 * k + ch[c].ord);
      }
    }
    bool live = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Chain& h = ch[c];
      const bool active = h.cur >= 0;
      if (!active && h.pstart < 0) continue;
      bool hitv = false;
      if (active && (!kAnyHit || h.prim < 0)) {
        // (bmin.xyz, bmax.x) (bmax.yz, slot start, count)
        const float tx0 = (na[c].x - h.ox) * h.ix, tx1 = (na[c].w - h.ox) * h.ix;
        const float ty0 = (na[c].y - h.oy) * h.iy, ty1 = (nb[c].x - h.oy) * h.iy;
        const float tz0 = (na[c].z - h.oz) * h.iz, tz1 = (nb[c].y - h.oz) * h.iz;
        const float t_enter =
            fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float t_exit =
            fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        hitv = t_enter <= t_exit && t_exit > 0.0f && t_enter < h.t;
      }
      if (h.pstart >= 0) drain_leaf(p.recs, h, t_min);
      const int32_t ss = active ? __float_as_int(nb[c].z) : -1;
      const bool enter = hitv && ss >= 0;
      h.pstart = enter ? ss : -1;
      h.pcount = enter ? __float_as_int(nb[c].w) : 0;
      if (active) h.cur = hitv ? lk[c].x : lk[c].y;
      if (kAnyHit && h.prim >= 0) h.cur = -1;
      live |= h.cur >= 0 || h.pstart >= 0;
    }
    if (!live) break;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t i = base + static_cast<int64_t>(c) * kBlock;
    if (i < r.n) {
      r.t[i] = ch[c].t;
      r.prim[i] = ch[c].prim;
    }
  }
}

template <bool kAnyHit>
int launch_chains(const TrlView& trl, const RayView& rays, float t_min,
                  int chains, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kBlock) * chains;
  const unsigned blocks = static_cast<unsigned>((rays.n + per_block - 1) / per_block);
  switch (chains) {
    case 1:
      smt_traverse_kernel<kAnyHit, 1><<<blocks, kBlock, 0, s>>>(trl, rays, t_min);
      break;
    case 2:
      smt_traverse_kernel<kAnyHit, 2><<<blocks, kBlock, 0, s>>>(trl, rays, t_min);
      break;
    case 4:
      smt_traverse_kernel<kAnyHit, 4><<<blocks, kBlock, 0, s>>>(trl, rays, t_min);
      break;
    case 8:
      smt_traverse_kernel<kAnyHit, 8><<<blocks, kBlock, 0, s>>>(trl, rays, t_min);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_smt_traverse(const TrlView& trl, const RayView& rays, float t_min,
                        bool any_hit, int chains, void* stream) {
  if (chains != 1 && chains != 2 && chains != 4 && chains != 8) return -1;
  if (rays.n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch_chains<true>(trl, rays, t_min, chains, s)
                 : launch_chains<false>(trl, rays, t_min, chains, s);
}

}  // namespace aten_tpu_torch
