// Closest-hit / any-hit traversal of the two-level (TLAS/BLAS) instanced
// pool, one thread per ray.
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
//     the world ray is restored; cur == -1 after that ends the walk;
//   * the slab test uses the current-space ray and its safe inverse;
//   * a BLAS leaf tests its prims in tl_prim_order order with a strict
//     `<` on t: Moller-Trumbore for triangles, the general quadratic for
//     spheres (object-space directions are not unit);
//   * a TLAS leaf whose box is hit latches resume = miss and the instance,
//     and moves the world ray into object space by its 3x4 W2L matrix,
//     summed in the fixed order ((m0*x + m1*y) + m2*z) + m3 and without
//     renormalising, so t stays world-parameterised;
//   * any-hit stops after the leaf that found a hit.
// Built with --fmad=false, every float op rounds as in the plain torch
// walk (accel/tlas.py::_traverse_two_level_plain), so the two agree bit
// for bit.
//
// Bound: a dependent pointer chase.  Each step loads one node (24 B of
// box, 20 B of links, ranges and instance), a TLAS leaf loads a 48 B
// matrix, and a BLAS leaf up to four 36 B triangles; the latency of
// these dependent loads, not arithmetic, sets the time.  Rays of one
// warp that enter different instances, or leave them at different
// steps, diverge and serialise.  This first version does nothing about
// that beyond read-only cached loads; packed node records, ray sorting
// and persistent threads are later work.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    tlas_traverse_kernel(TlasView b, TlasRayView rays, float t_min) {
  const RayView& r = rays.ray;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  const float wox = r.ro[3 * i], woy = r.ro[3 * i + 1], woz = r.ro[3 * i + 2];
  const float wdx = r.rd[3 * i], wdy = r.rd[3 * i + 1], wdz = r.rd[3 * i + 2];
  // current-space ray: the world ray, or the object-space one inside a BLAS
  float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
  float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float t0 = r.t0[i];
  float t = t0;
  int32_t prim = -1, best_inst = -1;
  float bu = 0.0f, bv = 0.0f;
  int32_t inst = -1, resume = -1;
  // a ray with t0 <= t_min can never hit (any prim needs t_min < t < t0)
  int32_t cur = t0 > t_min ? 0 : -1;
  while (true) {
    if (cur == -2) {  // the object's tree is done: back to the world ray
      cur = resume;
      inst = -1;
      ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
      ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    }
    if (cur < 0) break;
    if (!slab_hit(b.tl_bmin, b.tl_bmax, cur, ox, oy, oz, ix, iy, iz, t)) {
      cur = __ldg(b.tl_miss + cur);
      continue;
    }
    const int32_t ps = __ldg(b.tl_ps + cur);
    if (ps >= 0) {
      const int32_t pc = __ldg(b.tl_pc + cur);
      for (int32_t k = 0; k < pc; ++k) {
        const int32_t pid = __ldg(b.tl_prim_order + ps + k);
        float tp, tu = 0.0f, tv = 0.0f;
        bool h;
        if (pid < b.num_tris) {
          h = moller_trumbore(b.tri_v0 + 3 * pid, b.tri_e1 + 3 * pid,
                              b.tri_e2 + 3 * pid, ox, oy, oz, dx, dy, dz,
                              t_min, tp, tu, tv);
        } else {
          const int32_t s = pid - b.num_tris;
          h = sphere_general(b.sph_center + 3 * s, __ldg(b.sph_radius + s),
                             ox, oy, oz, dx, dy, dz, t_min, tp);
        }
        if (h && tp < t) {
          t = tp;
          prim = pid;
          best_inst = inst;
          bu = tu;
          bv = tv;
        }
      }
    }
    const int32_t leaf_inst = __ldg(b.tl_inst + cur);
    if (leaf_inst >= 0) {  // TLAS leaf: enter the instance's object
      const int32_t e = min(max(leaf_inst, 0), b.num_instances - 1);
      const float* m = b.inst_w2l + 12 * e;
      const float m00 = __ldg(m), m01 = __ldg(m + 1), m02 = __ldg(m + 2), m03 = __ldg(m + 3);
      const float m10 = __ldg(m + 4), m11 = __ldg(m + 5), m12 = __ldg(m + 6), m13 = __ldg(m + 7);
      const float m20 = __ldg(m + 8), m21 = __ldg(m + 9), m22 = __ldg(m + 10), m23 = __ldg(m + 11);
      ox = m00 * wox + m01 * woy + m02 * woz + m03;
      oy = m10 * wox + m11 * woy + m12 * woz + m13;
      oz = m20 * wox + m21 * woy + m22 * woz + m23;
      dx = m00 * wdx + m01 * wdy + m02 * wdz;
      dy = m10 * wdx + m11 * wdy + m12 * wdz;
      dz = m20 * wdx + m21 * wdy + m22 * wdz;
      ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
      resume = __ldg(b.tl_miss + cur);
      inst = leaf_inst;
    }
    cur = __ldg(b.tl_hit + cur);
    if (kAnyHit && prim >= 0) break;
  }
  r.t[i] = t;
  r.prim[i] = prim;
  rays.inst[i] = best_inst;
  r.u[i] = bu;
  r.v[i] = bv;
}

}  // namespace

int launch_tlas_traverse(const TlasView& tlas, const TlasRayView& rays,
                         float t_min, bool any_hit, void* stream) {
  if (rays.ray.n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rays.ray.n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    tlas_traverse_kernel<true><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        tlas, rays, t_min);
  } else {
    tlas_traverse_kernel<false><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        tlas, rays, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace aten_tpu_torch
