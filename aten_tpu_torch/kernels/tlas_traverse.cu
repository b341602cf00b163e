// Closest-hit / any-hit traversal of the two-level (TLAS/BLAS) instanced
// pool, one thread per ray, in persistent warps.
//
// Replaces the TPU instanced-treelet kernel `_make_tlas_treelet_kernel`
// (aten_tpu/ops/traverse_pallas.py:1750, launched by
// `_traverse_tlas_treelet_tiles`, entry `traverse_pallas_tlas`).  The TPU
// kernel votes per ray tile over a VMEM-resident cut of the pool and
// streams prim rows from HBM; here each thread walks the oracle's own
// flat pool (accel/tlas.py::build_two_level) without a stack, as the
// reference's CUDA hitTest walks its two-level threaded BVH.
//
// What it computes is the oracle `traverse_two_level`
// (aten_tpu/accel/tlas.py:242-303), step for step:
//   * cur == -2 pops back to the top level: cur = resume, inst = -1 and
//     the world ray and its safe inverse are restored; cur == -1 after
//     that ends the walk;
//   * the slab test uses the current-space ray and its safe inverse;
//   * a BLAS leaf tests all its prims in tl_prim_order order with a
//     strict `<` on t: Moller-Trumbore for triangles, the general
//     quadratic for spheres (object-space directions are not unit); the
//     winner latches the current instance;
//   * a TLAS leaf whose box is hit latches resume = miss and the instance,
//     and moves the world ray into object space by its 3x4 W2L matrix
//     (the instance index clamped to the instances), summed in the fixed
//     order ((m0*x + m1*y) + m2*z) + m3 and without renormalising, so t
//     stays world-parameterised;
//   * any-hit stops after the leaf that found a hit (every prim of that
//     leaf is tested); a ray with t0 <= t_min never walks.
// Built with --fmad=false, every float op rounds as in the plain torch
// walk (accel/tlas.py::_traverse_two_level_plain), so the two agree bit
// for bit on t, prim, inst, u and v.
//
// Bound: a dependent pointer chase.  The pool fits the 50 MB L2 cache, so
// the latency of each dependent load, not bandwidth or arithmetic, sets
// the time, and rays of a warp that enter different instances or leave
// them at different steps diverge.  The design, K1's (bvh_traverse.cu):
//   * packed records (ops/tlas_layout.py): a node step is two 128-bit
//     loads of one 32-byte record with the hit link implicit; entering an
//     instance is four independent 128-bit loads of its 64-byte record
//     (W2L rows and BLAS root); a BLAS leaf's prims are 48-byte records in
//     leaf order, so no load goes through tl_prim_order;
//   * persistent warps taking rays from one counter (take_rays);
//   * a while-while loop: each lane walks inner nodes, pops and instance
//     entries as it meets them, until it stands on a BLAS leaf whose box
//     it hits or its walk ends; then the lanes on leaves test their prims
//     together.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;
constexpr int kMinIdle = 8;  // idle lanes at which a warp takes new rays

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    tlas_traverse_kernel(TlasView b, TlasRayView rays, float t_min, unsigned* next_ray) {
  const RayView& r = rays.ray;
  const float4* __restrict__ nodes = reinterpret_cast<const float4*>(b.nodes);
  const float4* __restrict__ insts = reinterpret_cast<const float4*>(b.insts);
  const float4* __restrict__ prims = reinterpret_cast<const float4*>(b.prims);
  int ray = -1;
  bool open = true;
  // the world ray, and the current-space ray (the object-space one inside
  // a BLAS) with its safe inverse
  float wox = 0.0f, woy = 0.0f, woz = 0.0f, wdx = 0.0f, wdy = 0.0f, wdz = 0.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, t = 0.0f, bu = 0.0f, bv = 0.0f;
  int32_t prim = -1, best_inst = -1, inst = -1, resume = -1, cur = -1;
  while (true) {
    if (take_rays(next_ray, r.n, kMinIdle, ray, open)) {
      const int64_t i3 = 3 * static_cast<int64_t>(ray);
      wox = r.ro[i3], woy = r.ro[i3 + 1], woz = r.ro[i3 + 2];
      wdx = r.rd[i3], wdy = r.rd[i3 + 1], wdz = r.rd[i3 + 2];
      ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
      ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
      const float t0 = r.t0[ray];
      t = t0;
      prim = best_inst = inst = resume = -1;
      bu = bv = 0.0f;
      // a ray with t0 <= t_min can never hit (any prim needs t_min < t < t0)
      cur = t0 > t_min ? 0 : -1;
    }
    if (!__any_sync(kFullWarp, ray >= 0)) break;  // the queue is empty
    // nodes, pops and instance entries until a BLAS leaf whose box the ray
    // hits, or the walk's end
    int32_t leaf = -1;
    if (ray >= 0) {
      while (true) {
        if (cur == -2) {  // the object's tree is done: back to the world ray
          cur = resume;
          inst = -1;
          ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
          ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
        }
        if (cur < 0) break;
        const float4 lo = __ldg(nodes + 2 * cur), hi = __ldg(nodes + 2 * cur + 1);
        const int32_t miss = __float_as_int(lo.w);
        if (!slab_hit_box(lo, hi, ox, oy, oz, ix, iy, iz, t)) {
          cur = miss;
          continue;
        }
        const int32_t word = __float_as_int(hi.w);
        if (word == -1) {
          ++cur;  // an inner node's hit link: its first child, next in preorder
          continue;
        }
        if (word < -1) {  // TLAS leaf: enter the instance's object
          const int32_t li = -2 - word;
          const float4* m = insts + 4 * min(max(li, 0), b.num_instances - 1);
          const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
          const float4 root = __ldg(m + 3);
          ox = m0.x * wox + m0.y * woy + m0.z * woz + m0.w;
          oy = m1.x * wox + m1.y * woy + m1.z * woz + m1.w;
          oz = m2.x * wox + m2.y * woy + m2.z * woz + m2.w;
          dx = m0.x * wdx + m0.y * wdy + m0.z * wdz;
          dy = m1.x * wdx + m1.y * wdy + m1.z * wdz;
          dz = m2.x * wdx + m2.y * wdy + m2.z * wdz;
          ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
          resume = miss;
          inst = li;
          cur = __float_as_int(root.x);  // the TLAS leaf's hit link
          continue;
        }
        leaf = word;
        cur = miss;  // a BLAS leaf's hit link is its miss link
        break;
      }
    }
    // the BLAS leaf's prims, in their order, every one of them
    if (leaf >= 0) {
      const float4* rec = prims + 3 * static_cast<int64_t>(leaf >> kLeafShift);
      const int32_t pc = leaf & kLeafCount;
      for (int32_t k = 0; k < pc; ++k, rec += 3) {
        const float4 a = __ldg(rec), e1 = __ldg(rec + 1);
        const int32_t pid = __float_as_int(a.w);
        float tp, tu = 0.0f, tv = 0.0f;
        bool h;
        if (pid < b.num_tris) {
          const float4 e2 = __ldg(rec + 2);
          h = moller_trumbore_at(a.x, a.y, a.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
                                 ox, oy, oz, dx, dy, dz, t_min, tp, tu, tv);
        } else {
          h = sphere_general_at(a.x, a.y, a.z, e1.x, ox, oy, oz, dx, dy, dz, t_min, tp);
        }
        if (h && tp < t) {
          t = tp;
          prim = pid;
          best_inst = inst;
          bu = tu;
          bv = tv;
        }
      }
      if (kAnyHit && prim >= 0) cur = -1;
    }
    if (ray >= 0 && cur == -1) {  // -2 still pops back to the top level
      r.t[ray] = t;
      r.prim[ray] = prim;
      rays.inst[ray] = best_inst;
      r.u[ray] = bu;
      r.v[ray] = bv;
      ray = -1;
    }
  }
}

template <bool kAnyHit>
void launch(const TlasView& tlas, const TlasRayView& rays, float t_min,
            unsigned* next_ray, cudaStream_t s) {
  const int64_t blocks =
      persistent_blocks(tlas_traverse_kernel<kAnyHit>, kBlock, rays.ray.n);
  tlas_traverse_kernel<kAnyHit><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
      tlas, rays, t_min, next_ray);
}

}  // namespace

int launch_tlas_traverse(const TlasView& tlas, const TlasRayView& rays,
                         float t_min, bool any_hit, unsigned* next_ray,
                         void* stream) {
  if (rays.ray.n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    launch<true>(tlas, rays, t_min, next_ray, s);
  } else {
    launch<false>(tlas, rays, t_min, next_ray, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace aten_tpu_torch
