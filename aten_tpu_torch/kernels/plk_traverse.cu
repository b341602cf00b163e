// Closest-hit / any-hit traversal of the treelet-cut BVH with the Plücker
// leaf test, one thread per ray.
//
// Replaces the TPU kernel `_make_plk_treelet_kernel`
// (aten_tpu/ops/traverse_pallas.py:1058, launched by `_traverse_plk_tiles`
// :1276, entry `traverse_pallas` :2099-2124).  The TPU kernel walks a
// 2048-ray tile down a VMEM-resident cut tree by vote and, at each fat
// leaf, multiplies the leaf's [16, 256] constant block with the tile's
// ray matrix on the MXU.  Here each thread walks the cut tree's default
// threaded links without a stack and, at a fat leaf, runs the same
// Plücker test slot by slot on the leaf's compact records
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
//   * the winner code (bits(tt) & ~63) | j minimised over the leaf, so t
//     keeps 17 mantissa bits and a tie in a leaf goes to the smaller slot;
//     codes order as the floats do because tt > t_min > 0;
//   * a strict `<` merge of the leaf's winner into the ray's t;
//   * any-hit stops after the leaf that found a hit; a ray with
//     t0 <= t_min never walks.
// The slot goes through slot2prim at the end; u/v come from
// accel/traverse.py::recompute_uv on the winner.
//
// Bound: a dependent walk of the cut tree (24 B of box and 16 B of links
// and ranges per step), then up to 64 records of 64 B per fat leaf
// entered, each read once per ray: on the 512k-prim scene the records'
// 35 MB fit the 50 MB L2 cache, so leaf reads are L2 traffic, and the
// ~45 fp32 and integer operations per slot, executed slot after slot
// by each thread, with divergent leaf counts in a warp, set the time.
// This first version does nothing about it; staging a leaf's records in
// shared memory per warp, or the leaf test as a tensor-core product with
// 3xTF32 accuracy, is later work.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;
constexpr int32_t kSlotMask = 63;          // WINDOW - 1: slot bits of a code
constexpr int32_t kNoHit = 0x7F800000;     // +inf, slot 0

// K3's safe inverse (traverse_pallas.py:1094-1097).
__device__ __forceinline__ float plk_safe_inv(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    plk_traverse_kernel(PlkView p, RayView r, float t_min) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  const float ox = r.ro[3 * i], oy = r.ro[3 * i + 1], oz = r.ro[3 * i + 2];
  const float dx = r.rd[3 * i], dy = r.rd[3 * i + 1], dz = r.rd[3 * i + 2];
  const float ix = plk_safe_inv(dx), iy = plk_safe_inv(dy), iz = plk_safe_inv(dz);
  // ro x rd in the reference kernel's order (traverse_pallas.py:1107-1109)
  const float mx = oy * dz - oz * dy;
  const float my = oz * dx - ox * dz;
  const float mz = ox * dy - oy * dx;
  const float4* __restrict__ recs = reinterpret_cast<const float4*>(p.consts);
  const float t0 = r.t0[i];
  float t = t0;
  int32_t slot = -1;
  int32_t cur = t0 > t_min ? 0 : -1;
  while (cur >= 0) {
    if (!slab_hit(p.bmin, p.bmax, cur, ox, oy, oz, ix, iy, iz, t)) {
      cur = __ldg(p.miss + cur);
      continue;
    }
    const int32_t ss = __ldg(p.slot_start + cur);
    if (ss >= 0) {
      const int32_t cnt = __ldg(p.count + cur);
      int32_t best = kNoHit;
      const float4* rec = recs + 4 * static_cast<int64_t>(ss);
      for (int32_t j = 0; j < cnt; ++j, rec += 4) {
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
        if (signok && tt > t_min) {
          best = min(best, (__float_as_int(tt) & ~kSlotMask) | j);
        }
      }
      const float bt = __int_as_float(best & ~kSlotMask);
      if (bt < t) {
        t = bt;
        slot = ss + (best & kSlotMask);
      }
      if (kAnyHit && slot >= 0) break;
    }
    cur = __ldg(p.hit + cur);
  }
  r.t[i] = t;
  r.prim[i] = slot >= 0 ? __ldg(p.slot2prim + slot) : -1;
}

}  // namespace

int launch_plk_traverse(const PlkView& plk, const RayView& rays, float t_min,
                        bool any_hit, void* stream) {
  if (rays.n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rays.n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    plk_traverse_kernel<true><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        plk, rays, t_min);
  } else {
    plk_traverse_kernel<false><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        plk, rays, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace aten_tpu_torch
