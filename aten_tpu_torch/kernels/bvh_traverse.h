// Shared declarations of the traversal kernels (bvh_traverse.cu, the
// threaded BVH; tlas_traverse.cu, the two-level instanced pool;
// plk_traverse.cu, the Plücker treelet layout; smt_traverse.cu, the
// direction-ordered treelet layout) and their C interface (bindings.cpp).
#pragma once

#include <cstdint>

namespace aten_tpu_torch {

// The packed records of ops/bvh_layout.py; device pointers, 16-byte
// aligned (read as float4).
struct BvhView {
  const float* nodes;   // [K,8] (bmin.xyz, miss) (bmax.xyz, leaf), links
                        //       as int bits; leaf = start << 7 | count of
                        //       the leaf's prim records, -1 when internal,
                        //       kVoxelWord - id at a voxel leaf
  const float* prims;   // [P,12] prim records in leaf order:
                        //       (v0.xyz, id) (e1.xyz, 0) (e2.xyz, 0), or
                        //       (centre.xyz, id) (radius, 0, 0, 0) (0...)
  int32_t num_tris;     // prims below this id are triangles
};

// Bits of a packed leaf word (ops/bvh_layout.py: LEAF_SHIFT, LEAF_COUNT):
// K1's and K5's prim ranges, and (kTreelet*) the fat leaves' slot ranges
// of K3 and K4, whose counts reach 128 (TREELET_LEAF_SHIFT).
constexpr int kLeafShift = 7;
constexpr int32_t kLeafCount = (1 << kLeafShift) - 1;
constexpr int kTreeletLeafShift = 8;
constexpr int32_t kTreeletLeafCount = (1 << kTreeletLeafShift) - 1;

// Rays in, hits out; all device pointers, n entries each.
struct RayView {
  const float* ro;   // [n,3]
  const float* rd;   // [n,3] unit directions
  const float* t0;   // [n]   t_max per ray
  float* t;          // [n]   out: closest t (t0 on a miss)
  int32_t* prim;     // [n]   out: global prim id, -1 on a miss
  float* u;          // [n]   out: barycentric u of the winner (0 else)
  float* v;          // [n]   out: barycentric v of the winner (0 else)
  int64_t n;
};

// Per-ray work counts of the kStats instantiations, written where each
// ray retires; all null for the plain instantiations.  K1 fills `steps`
// (node steps, voxel leaves included) and `tests` (prim tests); K3 fills
// `steps`, `leaves` (fat leaves entered) and `tests` (slot tests).
struct CountView {
  int32_t* steps;   // [n]
  int32_t* leaves;  // [n]
  int32_t* tests;   // [n]
};

// Enqueues the walk on `stream`; returns the cudaError_t of the launch.
// `next_ray` is one zeroed counter from which the persistent warps take
// their rays; rays.n < 2^31.  `lod`: the voxel-LOD variant, for a tree
// baked for voxel LOD, whose voxel leaves hold kVoxelWord - id
// (traverse_device.cuh) in the leaf word.  counts.steps non-null: the
// kStats instantiation, which also writes counts.steps and counts.tests.
int launch_bvh_traverse(const BvhView& bvh, const RayView& rays,
                        const CountView& counts, float t_min, bool any_hit,
                        bool lod, unsigned* next_ray, void* stream);

// The packed records of ops/tlas_layout.py; device pointers, 16-byte
// aligned (read as float4).
struct TlasView {
  const float* nodes;     // [K,8] (bmin.xyz, miss) (bmax.xyz, leaf), links
                          //       as int bits, -2 back to the top level;
                          //       leaf -1 when inner, start << 7 | count
                          //       at a BLAS leaf, -2 - instance at a TLAS
                          //       leaf
  const float* insts;     // [I,16] W2L rows (3 x (m0, m1, m2, m3)), then
                          //        (BLAS root as int bits, 0, 0, 0)
  const float* prims;     // [P,12] BvhView's prim records, object-local, in
                          //        tl_prim_order order
  int32_t num_tris;       // prims below this id are triangles
  int32_t num_instances;  // I
};

// RayView plus the instance of each hit.
struct TlasRayView {
  RayView ray;
  int32_t* inst;  // [n] out: instance of the winner, -1 on a miss
};

// As launch_bvh_traverse.
int launch_tlas_traverse(const TlasView& tlas, const TlasRayView& rays,
                         float t_min, bool any_hit, unsigned* next_ray,
                         void* stream);

// The Plücker treelet layout of ops/plk_layout.py; device pointers,
// `nodes` and `consts` 16-byte aligned (read as float4).
struct PlkView {
  const float* nodes;         // [Kt,8] packed cut-tree records as BvhView's,
                              //        leaf = slot start << 8 | slot count
  const float* consts;        // [S,16] slot records
  const int32_t* slot2prim;   // [S] global prim id of each slot
  int32_t n_slots;            // S: the voxel-LOD variant's winners at or
                              // above it are voxel ids + S
};

// Writes rays.t and rays.prim; rays.u and rays.v are not used.  As
// launch_bvh_traverse; the kStats instantiation writes all three counts.
// `window`: the layout's drain window, 8, 16, 32, 64 or 128 (-1 for any
// other).
int launch_plk_traverse(const PlkView& plk, const RayView& rays,
                        const CountView& counts, float t_min, bool any_hit,
                        bool lod, int window, unsigned* next_ray, void* stream);

// The treelet layout of ops/trl_layout.py; device pointers.
// `nodes` and `recs` are 16-byte aligned (read as float4), `links`
// 8-byte aligned (read as int2).
struct TrlView {
  const float* nodes;    // [Kt,8] bmin, bmax, first slot of a fat leaf
                         //        (or -1; kVoxelWord - id at a voxel
                         //        leaf) and its slot count as int bits
  const int32_t* links;  // [Kt,12] (hit, miss) per ordering 2*axis + neg
  const float* recs;     // [S,12] slot records (ops/trl_layout.py)
};

// Writes rays.t and rays.prim with `chains` rays per lane (1, 2, 4 or 8;
// -1 for any other) at the layout's drain window `window` (a multiple of 8
// up to 128; -1 for any other); rays.u and rays.v are not used.  As
// launch_bvh_traverse; slot starts < 2^23 and t_min >= 0 (the drain orders
// a hit's t by its bits).
int launch_smt_traverse(const TrlView& trl, const RayView& rays, float t_min,
                        bool any_hit, int chains, bool lod, int window,
                        unsigned* next_ray, void* stream);

const char* cuda_error_string(int code);

}  // namespace aten_tpu_torch
