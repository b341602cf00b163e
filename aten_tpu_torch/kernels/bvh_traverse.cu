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
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;

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
    if (!slab_hit(b.nodes_bmin, b.nodes_bmax, cur, ox, oy, oz, ix, iy, iz, t)) {
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
