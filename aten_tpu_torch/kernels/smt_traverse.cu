// Closest-hit / any-hit traversal of the treelet-cut BVH along
// direction-ordered links, C rays ("chains") per lane, in persistent warps
// that drain fat leaves together.
//
// Replaces the TPU kernel `_make_smt_kernel`
// (aten_tpu/ops/traverse_pallas.py:1335, launched by `_traverse_smt_tiles`
// :1542, entry `traverse_pallas` :2136-2148).  The TPU kernel advances C
// independent 1024-ray tiles per grid step, each tile with one node
// cursor chosen by vote, so that the C dependent row loads of a step can
// overlap; a tile drains the fat leaf it latched on the previous step.
// Here each lane holds C rays and issues the node loads of its walking
// chains together; the TPU's tile vote and its `lax.cond` drain have no
// counterpart: each chain is one ray with its own cursor.
//
// What it computes is accel/traverse.py::_traverse_trl_plain, in the same
// operation order, built with --fmad=false so every float op rounds as
// the plain torch version does:
//   * each ray takes the link set of its ordering o = 2*axis + neg, the
//     dominant |component| with ties to x then y, `>= 0` positive;
//   * K4's safe inverse (1/d, or 1e12 for |d| <= 1e-12) and slab test;
//   * one step, in this order: the box test of the current node against
//     the ray's t from before the drain (any-hit rays that already have a
//     prim test no box); the drain of the fat leaf latched on the step
//     before, Moller-Trumbore or the sphere test per slot; the latch of
//     this node's fat leaf if its box was hit; the hit or miss link; an
//     any-hit ray drops its cursor once it has a prim, but still drains
//     the leaf it latched;
//   * the drain keeps the least t of the leaf's hits, a tie to the smaller
//     slot, and merges it with a strict `<`: the slot-by-slot loop's
//     winner;
//   * a ray with t0 <= t_min never walks.
// u/v come from accel/traverse.py::recompute_uv on the winner.
//
// The kLod instantiations are the `has_lod=True` branch (:1489-1497) on
// the cut tree of a tree baked for voxel LOD (ops/lod_layout.py), whose
// voxel leaves hold kVoxelWord - id in the slot-start word.  Right after
// a step's box test, and so before the drain of the leaf latched on the
// step before, as in the reference, a voxel leaf whose box is hit past
// t_min with an entry t below the ray's t (or equal to it, with an id
// below the winner's) records (t_enter, id); the step takes the miss
// link, and an any-hit ray with a hit drops its cursor.  The !kLod
// instantiations are the kernels of before.
//
// The drain window W of the layout (any multiple of 8 up to 128) sets the
// slots each lane tests, kPerLane = 1 (W <= 32), 2 (W <= 64) or 4, a
// template parameter; the kernels with kPerLane = 2 are those of before,
// and a leaf's own slot count bounds the drain at every W.
//
// Bound: each step is a dependent load of 40 B of node and links, then a
// fat leaf of up to W slot records of 48 B (the records of the 512k-prim
// scene, 26 MB, fit the 50 MB L2 cache); ~25 operations per box test and
// ~53 per slot test.  The design, K3's (plk_traverse.cu):
//   * persistent warps taking rays from one counter (take_rays), C per
//     lane, so a lane whose ray is done takes another;
//   * each lane steps its chains, their node loads issued together, until
//     every chain waits for a drain or has ended.  A step that must drain
//     a leaf first runs its box test, then waits: so the box test sees the
//     t from before the drain, as in the plain version, while steps with
//     no leaf to drain run on;
//   * then the warp drains the waiting leaves one after another: the
//     leaf's owner hands its ray over with shuffles, lane l tests slots l,
//     l + 32, ... (neighbouring 48-byte records, coalesced loads), and two
//     __reduce_min_sync give the leaf's least t, as float bits (exact: a
//     hit's t > t_min >= 0), then its least slot with that t; the owner
//     merges the winner with `<`.  No warp waits on the lane with the
//     longest leaf, and idle lanes help drain.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;
constexpr int kMinIdle = 8;            // idle chains at which a warp takes rays
constexpr unsigned kNoHit = 0xFFFFFFFFu;  // above every hit's t bits

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
  int32_t ray;   // ray index, -1 when the chain is idle
  int32_t cur;   // node, -1 when the walk has no node left
  int32_t prim, ord;
  int32_t pend;  // fat leaf latched on the step before, start << 8 | count, or -1
  int32_t next;  // the latch of a tested step that waits for pend's drain
  bool tested;   // this step's box test is done; it waits for the drain
};

__device__ __forceinline__ void start_chain(Chain& h, const RayView& r, float t_min) {
  const int64_t i3 = 3 * static_cast<int64_t>(h.ray);
  h.ox = r.ro[i3], h.oy = r.ro[i3 + 1], h.oz = r.ro[i3 + 2];
  h.dx = r.rd[i3], h.dy = r.rd[i3 + 1], h.dz = r.rd[i3 + 2];
  h.ix = trl_safe_inv(h.dx), h.iy = trl_safe_inv(h.dy), h.iz = trl_safe_inv(h.dz);
  h.ord = pick_ordering(h.dx, h.dy, h.dz);
  h.t = r.t0[h.ray];
  h.prim = h.pend = h.next = -1;
  h.tested = false;
  h.cur = h.t > t_min ? 0 : -1;
}

// The test of the slot record `rec` against the ray (o, d): its t bits
// and prim id where it is hit, kNoHit else.  Record lanes: a = (v0 |
// centre, e1x | radius), b = (e1y e1z e2x e2y), c = (e2z, prim id,
// is_tri, 0).
__device__ __forceinline__ unsigned slot_key(const float4* __restrict__ rec, float ox,
                                             float oy, float oz, float dx, float dy,
                                             float dz, float t_min, int32_t& pid) {
  const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
  float tp = 0.0f, u, v;
  const bool hp =
      __float_as_int(c.z) > 0
          ? moller_trumbore_at(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz,
                               dx, dy, dz, t_min, tp, u, v)
          : sphere_at(a.x, a.y, a.z, a.w, ox, oy, oz, dx, dy, dz, t_min, tp);
  pid = __float_as_int(c.y);
  return hp ? __float_as_uint(tp) : kNoHit;
}

template <bool kAnyHit, int C, bool kLod, int kPerLane>
__global__ void __launch_bounds__(kBlock)
    smt_traverse_kernel(TrlView p, RayView r, float t_min, unsigned* next_ray) {
  const float4* __restrict__ nodes = reinterpret_cast<const float4*>(p.nodes);
  const int2* __restrict__ links = reinterpret_cast<const int2*>(p.links);
  const float4* __restrict__ recs = reinterpret_cast<const float4*>(p.recs);
  const int lane = threadIdx.x & 31;
  Chain ch[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ch[c] = Chain{};
    ch[c].ray = -1;
  }
  bool open = true;
  while (true) {
    bool live = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (take_rays(next_ray, r.n, kMinIdle, ch[c].ray, open)) start_chain(ch[c], r, t_min);
      live |= ch[c].ray >= 0;
    }
    if (!__any_sync(kFullWarp, live)) break;  // the queue is empty
    // step the chains until each waits for a drain or has ended
    while (true) {
      float4 na[C], nb[C];
      int2 lk[C];
      bool go[C], moved = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {  // the node loads, independent of each other
        go[c] = ch[c].ray >= 0 && ch[c].cur >= 0 && !ch[c].tested;
        if (go[c]) {
          const int64_t k = ch[c].cur;
          na[c] = __ldg(nodes + 2 * k);
          nb[c] = __ldg(nodes + 2 * k + 1);
          lk[c] = __ldg(links + 6 * k + ch[c].ord);
          moved = true;
        }
      }
      if (!moved) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!go[c]) continue;
        Chain& h = ch[c];
        bool hitv = false;
        if (!kAnyHit || h.prim < 0) {
          // (bmin.xyz, bmax.x) (bmax.yz, slot start, count)
          const float tx0 = (na[c].x - h.ox) * h.ix, tx1 = (na[c].w - h.ox) * h.ix;
          const float ty0 = (na[c].y - h.oy) * h.iy, ty1 = (nb[c].x - h.oy) * h.iy;
          const float tz0 = (na[c].z - h.oz) * h.iz, tz1 = (nb[c].y - h.oz) * h.iz;
          const float t_enter =
              fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
          const float t_exit =
              fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
          hitv = t_enter <= t_exit && t_exit > 0.0f && t_enter < h.t;
          if constexpr (kLod) {
            const int32_t word = __float_as_int(nb[c].z);
            if (word <= kVoxelWord &&
                voxel_wins(t_enter, t_exit, t_min, h.t, kVoxelWord - word, h.prim)) {
              h.t = t_enter;
              h.prim = kVoxelWord - word;
            }
          }
        }
        const int32_t ss = __float_as_int(nb[c].z);
        const int32_t latch =
            hitv && ss >= 0 ? (ss << kTreeletLeafShift) | __float_as_int(nb[c].w) : -1;
        h.cur = hitv ? lk[c].x : lk[c].y;
        if constexpr (kLod && kAnyHit) {
          if (h.prim >= 0) h.cur = -1;  // a voxel hit ends an any-hit walk
        }
        if (h.pend < 0) {
          h.pend = latch;  // nothing to drain first: the step is complete
        } else {
          h.next = latch;  // the latched leaf drains before this step ends
          h.tested = true;
        }
      }
    }
    // the warp drains the waiting leaves, chain slot by chain slot
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Chain& h = ch[c];
      const bool ready = h.ray >= 0 && h.pend >= 0 && (h.tested || h.cur < 0);
      unsigned todo = __ballot_sync(kFullWarp, ready);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int32_t sl = __shfl_sync(kFullWarp, h.pend, src);
        const float sox = __shfl_sync(kFullWarp, h.ox, src);
        const float soy = __shfl_sync(kFullWarp, h.oy, src);
        const float soz = __shfl_sync(kFullWarp, h.oz, src);
        const float sdx = __shfl_sync(kFullWarp, h.dx, src);
        const float sdy = __shfl_sync(kFullWarp, h.dy, src);
        const float sdz = __shfl_sync(kFullWarp, h.dz, src);
        const int32_t ss = sl >> kTreeletLeafShift, cnt = sl & kTreeletLeafCount;
        const float4* rec = recs + 3 * (static_cast<int64_t>(ss) + lane);
        unsigned key = kNoHit;
        int32_t j = lane, pid = -1;
        if (lane < cnt) key = slot_key(rec, sox, soy, soz, sdx, sdy, sdz, t_min, pid);
#pragma unroll
        for (int k = 1; k < kPerLane; ++k) {
          if (lane + 32 * k < cnt) {
            int32_t pid2;
            const unsigned key2 =
                slot_key(rec + 3 * 32 * k, sox, soy, soz, sdx, sdy, sdz, t_min, pid2);
            if (key2 < key) {  // a tie stays with the smaller slot
              key = key2;
              j = lane + 32 * k;
              pid = pid2;
            }
          }
        }
        const unsigned kmin = __reduce_min_sync(kFullWarp, key);
        const unsigned jmin =
            __reduce_min_sync(kFullWarp, key == kmin ? static_cast<unsigned>(j) : kNoHit);
        const int32_t wpid = __shfl_sync(kFullWarp, pid, static_cast<int>(jmin & 31u));
        if (lane == src) {
          const float bt = __uint_as_float(kmin);  // NaN when no slot is hit
          if (bt < h.t) {
            h.t = bt;
            h.prim = wpid;
          }
        }
      }
      if (ready) {  // the rest of the step that waited
        h.pend = h.tested ? h.next : -1;
        h.tested = false;
        if (kAnyHit && h.prim >= 0) h.cur = -1;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Chain& h = ch[c];
      if (h.ray >= 0 && h.cur < 0 && h.pend < 0) {
        r.t[h.ray] = h.t;
        r.prim[h.ray] = h.prim;
        h.ray = -1;
      }
    }
  }
}

template <bool kAnyHit, int C, bool kLod, int kPerLane>
void launch(const TrlView& trl, const RayView& rays, float t_min, unsigned* next_ray,
            cudaStream_t s) {
  const int64_t blocks = persistent_blocks(smt_traverse_kernel<kAnyHit, C, kLod, kPerLane>,
                                           kBlock, (rays.n + C - 1) / C);
  smt_traverse_kernel<kAnyHit, C, kLod, kPerLane>
      <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(trl, rays, t_min, next_ray);
}

template <bool kAnyHit, bool kLod, int kPerLane>
int launch_chains(const TrlView& trl, const RayView& rays, float t_min, int chains,
                  unsigned* next_ray, cudaStream_t s) {
  switch (chains) {
    case 1:
      launch<kAnyHit, 1, kLod, kPerLane>(trl, rays, t_min, next_ray, s);
      break;
    case 2:
      launch<kAnyHit, 2, kLod, kPerLane>(trl, rays, t_min, next_ray, s);
      break;
    case 4:
      launch<kAnyHit, 4, kLod, kPerLane>(trl, rays, t_min, next_ray, s);
      break;
    case 8:
      launch<kAnyHit, 8, kLod, kPerLane>(trl, rays, t_min, next_ray, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kPerLane>
int launch_drain(const TrlView& trl, const RayView& rays, float t_min, bool any_hit,
                 int chains, bool lod, unsigned* next_ray, cudaStream_t s) {
  if (lod) {
    return any_hit
               ? launch_chains<true, true, kPerLane>(trl, rays, t_min, chains, next_ray, s)
               : launch_chains<false, true, kPerLane>(trl, rays, t_min, chains, next_ray, s);
  }
  return any_hit
             ? launch_chains<true, false, kPerLane>(trl, rays, t_min, chains, next_ray, s)
             : launch_chains<false, false, kPerLane>(trl, rays, t_min, chains, next_ray, s);
}

}  // namespace

int launch_smt_traverse(const TrlView& trl, const RayView& rays, float t_min,
                        bool any_hit, int chains, bool lod, int window,
                        unsigned* next_ray, void* stream) {
  if (chains != 1 && chains != 2 && chains != 4 && chains != 8) return -1;
  if (window < 8 || window > 128 || window % 8 != 0) return -1;
  if (rays.n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window <= 32) return launch_drain<1>(trl, rays, t_min, any_hit, chains, lod, next_ray, s);
  if (window <= 64) return launch_drain<2>(trl, rays, t_min, any_hit, chains, lod, next_ray, s);
  return launch_drain<4>(trl, rays, t_min, any_hit, chains, lod, next_ray, s);
}

}  // namespace aten_tpu_torch
