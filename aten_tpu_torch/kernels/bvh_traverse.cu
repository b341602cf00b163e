// Closest-hit / any-hit traversal of a threaded BVH, one thread per ray.
//
// Replaces the TPU treelet kernel `_make_treelet_kernel`
// (aten_tpu/ops/traverse_pallas.py:785, launched by
// `_traverse_treelet_tiles`, winner u/v by `_recompute_uv`) and covers
// the function of the uncut-tree kernel `_make_kernel` (:102).  The TPU
// kernels vote per 2048-ray tile over treelets sized to VMEM; on Hopper
// each thread walks the plain threaded hit/miss links without a stack,
// the shape of the reference's CUDA hitTest.
//
// What it computes is the oracle `traverse(impl="jax")`
// (aten_tpu/accel/traverse.py:189-351, without voxel LOD): the same node
// order, the same slab test, Möller-Trumbore and sphere test in the same
// operation order, and a strict `<` on t, so ties break the same way.
// u/v of the winner come out of the same pass.  Built with --fmad=false:
// without FMA contraction every float op rounds as in the plain torch
// walk, so the two agree prim for prim on the card.
//
// Bound: a data-dependent pointer chase.  Each step loads one node (24 B
// of box, 4 B of links) and, at a leaf, up to four 36 B triangles; the
// latency of these dependent loads, not arithmetic, sets the time, and
// divergent rays in a warp serialise.  This first version does nothing
// about it beyond keeping the walk stackless and the node loads read-only
// through the cache; packed node records, direction-ordered links, ray
// sorting and persistent threads are later work.
#include <cuda_runtime.h>

#include "bvh_traverse.h"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;

// _safe_inv of the oracle: 1/d, or sign(d)*1e12 + 1e12 for |d| <= 1e-12.
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) > 1e-12f) return 1.0f / d;
  const float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
  return s * 1e12f + 1e12f;
}

__device__ __forceinline__ bool moller_trumbore(
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, float ox, float oy, float oz, float dx,
    float dy, float dz, float t_min, float& t, float& u, float& v) {
  const float e1x = __ldg(e1), e1y = __ldg(e1 + 1), e1z = __ldg(e1 + 2);
  const float e2x = __ldg(e2), e2y = __ldg(e2 + 1), e2z = __ldg(e2 + 2);
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv = 1.0f / det;
  const float sx = ox - __ldg(v0), sy = oy - __ldg(v0 + 1), sz = oz - __ldg(v0 + 2);
  u = (sx * px + sy * py + sz * pz) * inv;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min;
}

__device__ __forceinline__ bool sphere(const float* __restrict__ c, float r,
                                       float ox, float oy, float oz, float dx,
                                       float dy, float dz, float t_min,
                                       float& t) {
  const float sx = ox - __ldg(c), sy = oy - __ldg(c + 1), sz = oz - __ldg(c + 2);
  const float b = sx * dx + sy * dy + sz * dz;
  const float cq = sx * sx + sy * sy + sz * sz - r * r;
  const float disc = b * b - cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float ta = -b - sq;
  const float tb = -b + sq;
  t = ta > t_min ? ta : tb;
  return disc > 0.0f && t > t_min;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    bvh_traverse_kernel(BvhView b, RayView r, float t_min) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  const float ox = r.ro[3 * i], oy = r.ro[3 * i + 1], oz = r.ro[3 * i + 2];
  const float dx = r.rd[3 * i], dy = r.rd[3 * i + 1], dz = r.rd[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float t0 = r.t0[i];
  float t = t0;
  int32_t prim = -1;
  float bu = 0.0f, bv = 0.0f;
  // a ray with t0 <= t_min can never hit (any prim needs t_min < t < t0)
  int32_t cur = t0 > t_min ? 0 : -1;
  while (cur >= 0) {
    const float* lo = b.nodes_bmin + 3 * cur;
    const float* hi = b.nodes_bmax + 3 * cur;
    const float tx0 = (__ldg(lo) - ox) * ix, tx1 = (__ldg(hi) - ox) * ix;
    const float ty0 = (__ldg(lo + 1) - oy) * iy, ty1 = (__ldg(hi + 1) - oy) * iy;
    const float tz0 = (__ldg(lo + 2) - oz) * iz, tz1 = (__ldg(hi + 2) - oz) * iz;
    const float t_enter =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float t_exit =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    if (!(t_enter <= t_exit && t_exit > 0.0f && t_enter < t)) {
      cur = __ldg(b.nodes_miss + cur);
      continue;
    }
    const int32_t ps = __ldg(b.nodes_prim_start + cur);
    if (ps >= 0) {
      const int32_t pc = __ldg(b.nodes_prim_count + cur);
      for (int32_t k = 0; k < pc; ++k) {
        const int32_t pid = __ldg(b.prim_order + ps + k);
        float tp, tu = 0.0f, tv = 0.0f;
        bool h;
        if (pid < b.num_tris) {
          h = moller_trumbore(b.tri_v0 + 3 * pid, b.tri_e1 + 3 * pid,
                              b.tri_e2 + 3 * pid, ox, oy, oz, dx, dy, dz,
                              t_min, tp, tu, tv);
        } else {
          const int32_t s = pid - b.num_tris;
          h = sphere(b.sph_center + 3 * s, __ldg(b.sph_radius + s), ox, oy, oz,
                     dx, dy, dz, t_min, tp);
        }
        if (h && tp < t) {
          t = tp;
          prim = pid;
          bu = tu;
          bv = tv;
          if (kAnyHit) break;
        }
      }
      if (kAnyHit && prim >= 0) break;
    }
    cur = __ldg(b.nodes_hit + cur);
  }
  r.t[i] = t;
  r.prim[i] = prim;
  r.u[i] = bu;
  r.v[i] = bv;
}

}  // namespace

int launch_bvh_traverse(const BvhView& bvh, const RayView& rays, float t_min,
                        bool any_hit, void* stream) {
  if (rays.n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rays.n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    bvh_traverse_kernel<true><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        bvh, rays, t_min);
  } else {
    bvh_traverse_kernel<false><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        bvh, rays, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace aten_tpu_torch
