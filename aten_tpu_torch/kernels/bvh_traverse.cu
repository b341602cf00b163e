// Closest-hit / any-hit traversal of a threaded BVH, one thread per ray,
// in persistent warps.
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
// walk (accel/traverse.py::_traverse_plain), so the two agree bit for bit.
//
// The kLod instantiations are the `has_lod=True` branch (:922-923,
// :950-963) on a tree baked for voxel LOD (ops/lod_layout.py): a voxel
// leaf's leaf word holds kVoxelWord - id.  The walk tests its box, and
// where it is hit past t_min with an entry t below the best t (or equal
// to it, with an id below the winner's) records (t_enter, id, u = v = 0);
// either way it takes the miss link, and an any-hit ray with a hit ends.
// Its plain version is _traverse_plain(baked=True).  Voxel leaves are
// handled inside the node loop, as inner nodes are: they test no prims.
// The !kLod instantiations are the kernels of before, unchanged.
//
// The kStats instantiations are the `stats=True` variant of the TPU
// kernel (:813-816, :911-913, :1000-1002, :1026-1032), which counts node
// iterations and leaf rows per 1024-ray tile for one tile-wide vote.
// Here each thread walks its own ray, so each ray counts its own work:
// node steps (every node the inner loop visits, voxel leaves included)
// and prim tests (the leaf loop's tests, an any-hit ray's up to its
// first accepted hit), stored once where the ray retires (CountView).
// Their plain version is _traverse_plain(stats=True)'s "counts"; the
// hits are the !kStats instantiation's, bit for bit.
//
// Bound: a data-dependent pointer chase.  The whole pool fits the 50 MB
// L2 cache, so the latency of each dependent load, not bandwidth or
// arithmetic, sets the time, and divergent rays in a warp serialise.
// The design spends on that:
//   * packed records (ops/bvh_layout.py): a node step is two 128-bit
//     loads of one 32-byte record, (bmin, miss) and (bmax, leaf), with
//     the hit link implicit (i + 1 inside, the miss link at a leaf).  A
//     leaf's prims are 48-byte records in leaf order, so the walk makes
//     no dependent load through prim_order;
//   * persistent warps: about as many blocks as fit the card at once,
//     each warp taking rays from one global counter (take_rays), so a
//     lane whose ray is done takes another instead of idling until the
//     grid's last block;
//   * a while-while loop (Aila and Laine, HPG 2009): each lane walks
//     inner nodes until it stands on a leaf whose box it hits or its
//     walk ends, and then the lanes on leaves test their prims together,
//     so node code and prim code do not interleave within a warp.
#include <cuda_runtime.h>

#include "bvh_traverse.h"
#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kBlock = 128;
constexpr int kMinIdle = 8;  // idle lanes at which a warp takes new rays

template <bool kAnyHit, bool kLod, bool kStats>
__global__ void __launch_bounds__(kBlock)
    bvh_traverse_kernel(BvhView b, RayView r, CountView c, float t_min,
                        unsigned* next_ray) {
  const float4* __restrict__ nodes = reinterpret_cast<const float4*>(b.nodes);
  const float4* __restrict__ prims = reinterpret_cast<const float4*>(b.prims);
  int ray = -1;
  bool open = true;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, t = 0.0f, bu = 0.0f, bv = 0.0f;
  int32_t prim = -1, cur = -1;
  int32_t steps = 0, tests = 0;  // kStats: this ray's node steps, prim tests
  while (true) {
    if (take_rays(next_ray, r.n, kMinIdle, ray, open)) {
      const int64_t i3 = 3 * static_cast<int64_t>(ray);
      ox = r.ro[i3], oy = r.ro[i3 + 1], oz = r.ro[i3 + 2];
      dx = r.rd[i3], dy = r.rd[i3 + 1], dz = r.rd[i3 + 2];
      ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
      const float t0 = r.t0[ray];
      t = t0;
      prim = -1;
      bu = bv = 0.0f;
      if constexpr (kStats) steps = tests = 0;
      // a ray with t0 <= t_min can never hit (any prim needs t_min < t < t0)
      cur = t0 > t_min ? 0 : -1;
    }
    if (!__any_sync(kFullWarp, ray >= 0)) break;  // the queue is empty
    // inner nodes until a leaf whose box the ray hits, or the walk's end
    int32_t leaf = -1;
    if (ray >= 0) {
      while (cur >= 0) {
        if constexpr (kStats) ++steps;
        const float4 lo = __ldg(nodes + 2 * cur), hi = __ldg(nodes + 2 * cur + 1);
        const int32_t miss = __float_as_int(lo.w);
        if constexpr (kLod) {
          const int32_t word = __float_as_int(hi.w);
          if (word <= kVoxelWord) {  // a voxel leaf
            const int32_t vid = kVoxelWord - word;
            float te, tx;
            slab_enter_exit(lo, hi, ox, oy, oz, ix, iy, iz, te, tx);
            if (voxel_wins(te, tx, t_min, t, vid, prim)) {
              t = te;
              prim = vid;
              bu = bv = 0.0f;
            }
            cur = (kAnyHit && prim >= 0) ? -1 : miss;
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
        cur = miss;  // a leaf's hit link is its miss link
        break;
      }
    }
    // the leaf's prims, in their order
    if (leaf >= 0) {
      const float4* rec = prims + 3 * static_cast<int64_t>(leaf >> kLeafShift);
      const int32_t pc = leaf & kLeafCount;
      for (int32_t k = 0; k < pc; ++k, rec += 3) {
        if constexpr (kStats) ++tests;
        const float4 a = __ldg(rec), e1 = __ldg(rec + 1);
        const int32_t pid = __float_as_int(a.w);
        float tp, tu = 0.0f, tv = 0.0f;
        bool h;
        if (pid < b.num_tris) {
          const float4 e2 = __ldg(rec + 2);
          h = moller_trumbore_at(a.x, a.y, a.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
                                 ox, oy, oz, dx, dy, dz, t_min, tp, tu, tv);
        } else {
          h = sphere_at(a.x, a.y, a.z, e1.x, ox, oy, oz, dx, dy, dz, t_min, tp);
        }
        if (h && tp < t) {
          t = tp;
          prim = pid;
          bu = tu;
          bv = tv;
          if (kAnyHit) break;
        }
      }
      if (kAnyHit && prim >= 0) cur = -1;
    }
    if (ray >= 0 && cur < 0) {
      r.t[ray] = t;
      r.prim[ray] = prim;
      r.u[ray] = bu;
      r.v[ray] = bv;
      if constexpr (kStats) {
        c.steps[ray] = steps;
        c.tests[ray] = tests;
      }
      ray = -1;
    }
  }
}

template <bool kAnyHit, bool kLod, bool kStats>
void launch(const BvhView& bvh, const RayView& rays, const CountView& counts,
            float t_min, unsigned* next_ray, cudaStream_t s) {
  const int64_t blocks =
      persistent_blocks(bvh_traverse_kernel<kAnyHit, kLod, kStats>, kBlock, rays.n);
  bvh_traverse_kernel<kAnyHit, kLod, kStats>
      <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(bvh, rays, counts, t_min,
                                                        next_ray);
}

template <bool kAnyHit, bool kLod>
void launch(const BvhView& bvh, const RayView& rays, const CountView& counts,
            float t_min, unsigned* next_ray, cudaStream_t s) {
  if (counts.steps) {
    launch<kAnyHit, kLod, true>(bvh, rays, counts, t_min, next_ray, s);
  } else {
    launch<kAnyHit, kLod, false>(bvh, rays, counts, t_min, next_ray, s);
  }
}

}  // namespace

int launch_bvh_traverse(const BvhView& bvh, const RayView& rays, const CountView& counts,
                        float t_min, bool any_hit, bool lod, unsigned* next_ray,
                        void* stream) {
  if (rays.n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lod) {
    if (any_hit) {
      launch<true, true>(bvh, rays, counts, t_min, next_ray, s);
    } else {
      launch<false, true>(bvh, rays, counts, t_min, next_ray, s);
    }
  } else if (any_hit) {
    launch<true, false>(bvh, rays, counts, t_min, next_ray, s);
  } else {
    launch<false, false>(bvh, rays, counts, t_min, next_ray, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace aten_tpu_torch
