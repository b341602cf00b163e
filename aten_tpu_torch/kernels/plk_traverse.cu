// Closest-hit / any-hit traversal of the treelet-cut BVH with the Plücker
// leaf test, one thread per ray, in persistent warps that drain fat
// leaves together.
//
// Replaces the TPU kernel `_make_plk_treelet_kernel`
// (aten_tpu/ops/traverse_pallas.py:1058, launched by `_traverse_plk_tiles`
// :1276, entry `traverse_pallas` :2099-2124).  The TPU kernel walks a
// 2048-ray tile down a VMEM-resident cut tree by vote and, at each fat
// leaf, multiplies the leaf's [16, 256] constant block with the tile's
// ray matrix on the MXU.  Here each thread walks the cut tree's default
// threaded links without a stack and, at a fat leaf, the same Plücker
// test runs slot by slot on the leaf's compact records
// (ops/plk_layout.py: 16 floats per slot, read as four float4s).
//
// What it computes is accel/traverse.py::_traverse_plk_plain, in the same
// operation order, built with --fmad=false so every float op rounds as
// the plain torch version does:
//   * K3's slab test with its safe inverse (1/d, or 1e12 for |d| <= 1e-12);
//   * per slot s0, s1 (edge sides), den = n.rd and numn = -n.ro + n.v0 as
//     dot products with the ray's (rd, ro x rd, ro, 1), s2 = den - s0 - s1,
//     inside when all three sides share den's sign bit, tt = numn * (1/den)
//     with an IEEE reciprocal, valid when tt > t_min;
//   * the winner code (bits(tt) & ~(W - 1)) | j minimised over the leaf,
//     W the layout's drain window (a power of two, 8 to 128), so t keeps
//     23 - log2(W) mantissa bits (17 at W = 64) and a tie in a leaf goes
//     to the smaller slot;
//     codes order as the floats do because tt > t_min > 0, and an integer
//     minimum is exact whichever lanes take which slots;
//   * a strict `<` merge of the leaf's winner into the ray's t;
//   * any-hit stops after the leaf that found a hit; a ray with
//     t0 <= t_min never walks.
// The slot goes through slot2prim at the end; u/v come from
// accel/traverse.py::recompute_uv on the winner.
//
// The kLod instantiations are the `has_lod=True` branch (:1214-1224) on
// the cut tree of a tree baked for voxel LOD (ops/lod_layout.py), whose
// voxel leaves hold kVoxelWord - id in the leaf word.  The per-lane walk
// tests a voxel leaf's box as K1's does and records its raw entry t with
// the id shifted above the slots (id + n_slots), so ties compare in one
// namespace as in the reference; it takes the miss link, before any warp
// drain.  The shift is undone at the end (the reference's wrapper,
// :2113-2117).  The !kLod instantiations are the kernels of before.
//
// The kStats instantiations are the `stats=True` variant (:1087-1090,
// :1264-1266, :1289-1294), which counts node iterations and drains per
// 1024-ray tile.  Each ray here counts its own: node steps (every node
// its walk visits, voxel leaves included), fat leaves entered, and slot
// tests (each leaf's slot count, whichever lanes of the warp test them),
// stored once where the ray retires (CountView).  Their plain version is
// _traverse_plk_plain(stats=True)'s "counts"; the hits are the !kStats
// instantiation's, bit for bit.
//
// The drain window W is a template parameter (instantiations at 8, 16,
// 32, 64 and 128): it sets the code's slot bits and the slots each lane
// tests, ceil(W / 32).  The kernels at W = 64 are those of before.
//
// Bound: a dependent walk of the cut tree, then up to W records of 64 B
// per fat leaf entered, each read once per ray.  On the 512k-prim scene
// the records' 35 MB fit the 50 MB L2, so the latency of the walk's
// dependent loads and the ~48 operations per slot, run for every slot of
// every leaf entered, set the time.  The design:
//   * packed 32-byte node records (ops/bvh_layout.py::pack_nodes), two
//     128-bit loads per step, the fat leaf's slot range in the leaf word;
//   * persistent warps taking rays from one counter (take_rays), and a
//     while-while loop: each lane walks until it stands on a fat leaf
//     whose box it hits, or its walk ends;
//   * then the warp drains the leaves its lanes stand on, one leaf after
//     another: the leaf's owner hands its ray to the warp with shuffles,
//     lane l tests slots l, l + 32, ... below the leaf's count, whose
//     records are neighbours (coalesced 16-byte loads), and
//     __reduce_min_sync gives the leaf's
//     least code to the owner, which merges it.  Lanes whose own ray is
//     done or walking help drain instead of idling, and no warp waits on
//     the lane with the longest leaf.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;
constexpr int kMinIdle = 8;                // idle lanes at which a warp takes rays
constexpr int32_t kNoHit = 0x7F800000;     // +inf, slot 0

// K3's safe inverse (traverse_pallas.py:1094-1097).
__device__ __forceinline__ float plk_safe_inv(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// The winner code of slot j of a leaf whose record is `rec`, kNoHit when
// the ray (o, d, m = o x d) misses it; kSlotMask = W - 1.
template <int32_t kSlotMask>
__device__ __forceinline__ int32_t slot_code(const float4* __restrict__ rec,
                                             int32_t j, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float mx, float my,
                                             float mz, float t_min) {
  // (m0, d0, m1, d1, n, n.v0) as (m0x m0y m0z d0x) (d0y d0z m1x m1y)
  // (m1z d1x d1y d1z) (nx ny nz nv0)
  const float4 a = __ldg(rec), b = __ldg(rec + 1);
  const float4 c = __ldg(rec + 2), e = __ldg(rec + 3);
  const float s0 =
      ((((a.x * dx + a.y * dy) + a.z * dz) + a.w * mx) + b.x * my) + b.y * mz;
  const float s1 =
      ((((b.z * dx + b.w * dy) + c.x * dz) + c.y * mx) + c.z * my) + c.w * mz;
  const float den = (e.x * dx + e.y * dy) + e.z * dz;
  const float numn = (((-e.x) * ox + (-e.y) * oy) + (-e.z) * oz) + e.w;
  const float s2 = (den - s0) - s1;
  const int32_t idn = __float_as_int(den);
  const bool signok = ((__float_as_int(s0) ^ idn) | (__float_as_int(s1) ^ idn) |
                       (__float_as_int(s2) ^ idn)) >= 0;
  const float tt = numn * (1.0f / den);  // den = 0: inf or NaN, never valid
  return signok && tt > t_min ? (__float_as_int(tt) & ~kSlotMask) | j : kNoHit;
}

template <bool kAnyHit, bool kLod, bool kStats, int kWindow>
__global__ void __launch_bounds__(kBlock)
    plk_traverse_kernel(PlkView p, RayView r, CountView c, float t_min,
                        unsigned* next_ray) {
  constexpr int32_t kSlotMask = kWindow - 1;  // slot bits of a code
  constexpr int kPerLane = (kWindow + 31) / 32;
  const float4* __restrict__ nodes = reinterpret_cast<const float4*>(p.nodes);
  const float4* __restrict__ recs = reinterpret_cast<const float4*>(p.consts);
  const int lane = threadIdx.x & 31;
  int ray = -1;
  bool open = true;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, mx = 0.0f, my = 0.0f, mz = 0.0f;
  float t = 0.0f;
  int32_t slot = -1, cur = -1;
  int32_t steps = 0, leaves = 0, tests = 0;  // kStats: this ray's counts
  while (true) {
    if (take_rays(next_ray, r.n, kMinIdle, ray, open)) {
      const int64_t i3 = 3 * static_cast<int64_t>(ray);
      ox = r.ro[i3], oy = r.ro[i3 + 1], oz = r.ro[i3 + 2];
      dx = r.rd[i3], dy = r.rd[i3 + 1], dz = r.rd[i3 + 2];
      ix = plk_safe_inv(dx), iy = plk_safe_inv(dy), iz = plk_safe_inv(dz);
      // ro x rd in the reference kernel's order (traverse_pallas.py:1107-1109)
      mx = oy * dz - oz * dy;
      my = oz * dx - ox * dz;
      mz = ox * dy - oy * dx;
      const float t0 = r.t0[ray];
      t = t0;
      slot = -1;
      cur = t0 > t_min ? 0 : -1;
      if constexpr (kStats) steps = leaves = tests = 0;
    }
    if (!__any_sync(kFullWarp, ray >= 0)) break;  // the queue is empty
    // the cut tree's inner nodes until a fat leaf whose box the ray hits
    int32_t leaf = -1;
    if (ray >= 0) {
      while (cur >= 0) {
        if constexpr (kStats) ++steps;
        const float4 lo = __ldg(nodes + 2 * cur), hi = __ldg(nodes + 2 * cur + 1);
        const int32_t miss = __float_as_int(lo.w);
        if constexpr (kLod) {
          const int32_t word = __float_as_int(hi.w);
          if (word <= kVoxelWord) {  // a voxel leaf
            const int32_t vid = kVoxelWord - word + p.n_slots;
            float te, tx;
            slab_enter_exit(lo, hi, ox, oy, oz, ix, iy, iz, te, tx);
            if (voxel_wins(te, tx, t_min, t, vid, slot)) {
              t = te;
              slot = vid;
            }
            cur = (kAnyHit && slot >= 0) ? -1 : miss;
            continue;
          }
        }
        if (!slab_hit_box(lo, hi, ox, oy, oz, ix, iy, iz, t)) {
          cur = miss;
          continue;
        }
        leaf = __float_as_int(hi.w);
        if (leaf < 0) {
          ++cur;  // an inner node's hit link: its first child, next in preorder
          continue;
        }
        cur = miss;  // a fat leaf's hit link is its miss link
        if constexpr (kStats) {
          ++leaves;
          tests += leaf & kTreeletLeafCount;
        }
        break;
      }
    }
    // the warp drains each lane's leaf in turn
    unsigned todo = __ballot_sync(kFullWarp, leaf >= 0);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int32_t sl = __shfl_sync(kFullWarp, leaf, src);
      const float sox = __shfl_sync(kFullWarp, ox, src);
      const float soy = __shfl_sync(kFullWarp, oy, src);
      const float soz = __shfl_sync(kFullWarp, oz, src);
      const float sdx = __shfl_sync(kFullWarp, dx, src);
      const float sdy = __shfl_sync(kFullWarp, dy, src);
      const float sdz = __shfl_sync(kFullWarp, dz, src);
      const float smx = __shfl_sync(kFullWarp, mx, src);
      const float smy = __shfl_sync(kFullWarp, my, src);
      const float smz = __shfl_sync(kFullWarp, mz, src);
      const int32_t ss = sl >> kTreeletLeafShift, cnt = sl & kTreeletLeafCount;
      const float4* rec = recs + 4 * (static_cast<int64_t>(ss) + lane);
      int32_t best = kNoHit;
      if (lane < cnt) {
        best = slot_code<kSlotMask>(rec, lane, sox, soy, soz, sdx, sdy, sdz, smx, smy,
                                    smz, t_min);
      }
#pragma unroll
      for (int k = 1; k < kPerLane; ++k) {
        if (lane + 32 * k < cnt) {
          best = min(best, slot_code<kSlotMask>(rec + 4 * 32 * k, lane + 32 * k, sox, soy,
                                                soz, sdx, sdy, sdz, smx, smy, smz, t_min));
        }
      }
      best = __reduce_min_sync(kFullWarp, best);
      if (lane == src) {
        const float bt = __int_as_float(best & ~kSlotMask);
        if (bt < t) {
          t = bt;
          slot = ss + (best & kSlotMask);
        }
      }
    }
    if (kAnyHit && slot >= 0) cur = -1;
    if (ray >= 0 && cur < 0) {
      r.t[ray] = t;
      if constexpr (kLod) {
        r.prim[ray] = slot >= p.n_slots ? slot - p.n_slots
                                        : (slot >= 0 ? __ldg(p.slot2prim + slot) : -1);
      } else {
        r.prim[ray] = slot >= 0 ? __ldg(p.slot2prim + slot) : -1;
      }
      if constexpr (kStats) {
        c.steps[ray] = steps;
        c.leaves[ray] = leaves;
        c.tests[ray] = tests;
      }
      ray = -1;
    }
  }
}

template <bool kAnyHit, bool kLod, bool kStats, int kWindow>
void launch(const PlkView& plk, const RayView& rays, const CountView& counts,
            float t_min, unsigned* next_ray, cudaStream_t s) {
  const int64_t blocks = persistent_blocks(
      plk_traverse_kernel<kAnyHit, kLod, kStats, kWindow>, kBlock, rays.n);
  plk_traverse_kernel<kAnyHit, kLod, kStats, kWindow>
      <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(plk, rays, counts, t_min,
                                                        next_ray);
}

template <bool kAnyHit, bool kLod, int kWindow>
void launch(const PlkView& plk, const RayView& rays, const CountView& counts,
            float t_min, unsigned* next_ray, cudaStream_t s) {
  if (counts.steps) {
    launch<kAnyHit, kLod, true, kWindow>(plk, rays, counts, t_min, next_ray, s);
  } else {
    launch<kAnyHit, kLod, false, kWindow>(plk, rays, counts, t_min, next_ray, s);
  }
}

template <int kWindow>
void launch_window(const PlkView& plk, const RayView& rays, const CountView& counts,
                   float t_min, bool any_hit, bool lod, unsigned* next_ray,
                   cudaStream_t s) {
  if (lod) {
    if (any_hit) {
      launch<true, true, kWindow>(plk, rays, counts, t_min, next_ray, s);
    } else {
      launch<false, true, kWindow>(plk, rays, counts, t_min, next_ray, s);
    }
  } else if (any_hit) {
    launch<true, false, kWindow>(plk, rays, counts, t_min, next_ray, s);
  } else {
    launch<false, false, kWindow>(plk, rays, counts, t_min, next_ray, s);
  }
}

}  // namespace

int launch_plk_traverse(const PlkView& plk, const RayView& rays, const CountView& counts,
                        float t_min, bool any_hit, bool lod, int window,
                        unsigned* next_ray, void* stream) {
  if (window != 8 && window != 16 && window != 32 && window != 64 && window != 128) return -1;
  if (rays.n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 8:
      launch_window<8>(plk, rays, counts, t_min, any_hit, lod, next_ray, s);
      break;
    case 16:
      launch_window<16>(plk, rays, counts, t_min, any_hit, lod, next_ray, s);
      break;
    case 32:
      launch_window<32>(plk, rays, counts, t_min, any_hit, lod, next_ray, s);
      break;
    case 64:
      launch_window<64>(plk, rays, counts, t_min, any_hit, lod, next_ray, s);
      break;
    default:
      launch_window<128>(plk, rays, counts, t_min, any_hit, lod, next_ray, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace aten_tpu_torch
