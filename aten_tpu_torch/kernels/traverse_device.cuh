// Device-side tests shared by the traversal kernels (bvh_traverse.cu,
// plk_traverse.cu, tlas_traverse.cu, smt_traverse.cu), and the ray queue
// of the persistent ones.  Each repeats the oracle's operation order
// (aten_tpu/accel/traverse.py, aten_tpu/accel/tlas.py) so that, built
// with --fmad=false, every float op rounds as in the plain torch walks.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace aten_tpu_torch {

// _safe_inv of the oracle: 1/d, or sign(d)*1e12 + 1e12 for |d| <= 1e-12.
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) > 1e-12f) return 1.0f / d;
  const float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
  return s * 1e12f + 1e12f;
}

// Slab test of a packed node record's box, lo = (bmin.xyz, .) and
// hi = (bmax.xyz, .) (ops/bvh_layout.py), against the ray (o, 1/d) with
// best t `t`.
__device__ __forceinline__ bool slab_hit_box(float4 lo, float4 hi, float ox,
                                             float oy, float oz, float ix,
                                             float iy, float iz, float t) {
  const float tx0 = (lo.x - ox) * ix, tx1 = (hi.x - ox) * ix;
  const float ty0 = (lo.y - oy) * iy, ty1 = (hi.y - oy) * iy;
  const float tz0 = (lo.z - oz) * iz, tz1 = (hi.z - oz) * iz;
  const float t_enter =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_exit =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return t_enter <= t_exit && t_exit > 0.0f && t_enter < t;
}

// (t_enter, t_exit) of the same slab test, for the voxel-LOD variants,
// which also need a box whose entry t ties the best t.
__device__ __forceinline__ void slab_enter_exit(float4 lo, float4 hi, float ox,
                                                float oy, float oz, float ix,
                                                float iy, float iz,
                                                float& t_enter, float& t_exit) {
  const float tx0 = (lo.x - ox) * ix, tx1 = (hi.x - ox) * ix;
  const float ty0 = (lo.y - oy) * iy, ty1 = (hi.y - oy) * iy;
  const float tz0 = (lo.z - oz) * iz, tz1 = (hi.z - oz) * iz;
  t_enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  t_exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// A voxel leaf of a tree baked for voxel LOD (ops/lod_layout.py) holds
// kVoxelWord - id where a leaf holds its range (<= kVoxelWord).
constexpr int32_t kVoxelWord = -2;

// The voxel hit rule (accel/traverse.py::_voxel_hit, the reference's
// traverse.py:260-291): the box [t_enter, t_exit] is hit past t_min and
// its entry t beats the best t, or ties it with a smaller id than the
// winner's.
__device__ __forceinline__ bool voxel_wins(float t_enter, float t_exit, float t_min,
                                           float t, int32_t vid, int32_t best) {
  return t_enter <= t_exit && t_exit > 0.0f && t_enter > t_min &&
         (t_enter < t || (t_enter == t && vid < best));
}

constexpr unsigned kFullWarp = 0xffffffffu;

// The ray queue of a persistent kernel: each lane of the calling warp
// whose `ray` is negative takes the next ray index from `next_ray`, with
// one atomicAdd for the warp, once at least `min_idle` lanes are idle;
// indices at or past n leave the lane idle.  `open` (warp-uniform) says
// whether the queue may still hold rays and is cleared once it is empty.
// Returns whether this lane took a new ray.  Every lane of the warp
// calls it.
__device__ __forceinline__ bool take_rays(unsigned* next_ray, int64_t n,
                                          int min_idle, int& ray,
                                          bool& open) {
  if (!open) return false;
  const unsigned idle = __ballot_sync(kFullWarp, ray < 0);
  const int n_idle = __popc(idle);
  if (n_idle < min_idle) return false;
  const unsigned lane = threadIdx.x & 31u;
  unsigned base = 0;
  if (lane == 0) base = atomicAdd(next_ray, static_cast<unsigned>(n_idle));
  base = __shfl_sync(kFullWarp, base, 0);
  open = static_cast<int64_t>(base) + n_idle < n;
  if (ray >= 0) return false;
  const unsigned k = base + __popc(idle & ((1u << lane) - 1u));
  if (static_cast<int64_t>(k) >= n) return false;
  ray = static_cast<int>(k);
  return true;
}

// Blocks of `block` threads for a persistent launch of `kernel` over n
// rays: as many as the card holds at once, and no more than the rays
// fill.
template <typename Kernel>
int64_t persistent_blocks(Kernel kernel, int block, int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t need = (n + block - 1) / block;
  return need < full ? need : full;
}

// Moller-Trumbore of the triangle (v0, e1 = v1 - v0, e2 = v2 - v0).
__device__ __forceinline__ bool moller_trumbore_at(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float t_min, float& t, float& u, float& v) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv = 1.0f / det;
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  u = (sx * px + sy * py + sz * pz) * inv;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min;
}

// Nearest root past t_min for a unit direction (traverse.py's _sphere).
__device__ __forceinline__ bool sphere_at(float cx, float cy, float cz, float r,
                                          float ox, float oy, float oz, float dx,
                                          float dy, float dz, float t_min,
                                          float& t) {
  const float sx = ox - cx, sy = oy - cy, sz = oz - cz;
  const float b = sx * dx + sy * dy + sz * dz;
  const float cq = sx * sx + sy * sy + sz * sz - r * r;
  const float disc = b * b - cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float ta = -b - sq;
  const float tb = -b + sq;
  t = ta > t_min ? ta : tb;
  return disc > 0.0f && t > t_min;
}

// The same for a non-unit (object-space) direction: a t^2 + 2 b t + c
// (tlas.py's _isect_sphere_general).
__device__ __forceinline__ bool sphere_general_at(float cx, float cy, float cz,
                                                  float r, float ox, float oy,
                                                  float oz, float dx, float dy,
                                                  float dz, float t_min,
                                                  float& t) {
  const float sx = ox - cx, sy = oy - cy, sz = oz - cz;
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = sx * dx + sy * dy + sz * dz;
  const float cq = sx * sx + sy * sy + sz * sz - r * r;
  const float disc = b * b - a * cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float inv_a = 1.0f / fmaxf(a, 1e-20f);
  const float ta = (-b - sq) * inv_a;
  const float tb = (-b + sq) * inv_a;
  t = ta > t_min ? ta : tb;
  return disc > 0.0f && t > t_min;
}

}  // namespace aten_tpu_torch
