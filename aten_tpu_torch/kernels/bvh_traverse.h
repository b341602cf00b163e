// Shared declarations of the traversal kernels (bvh_traverse.cu, the
// threaded BVH; tlas_traverse.cu, the two-level instanced pool;
// plk_traverse.cu, the Plücker treelet layout; smt_traverse.cu, the
// direction-ordered treelet layout) and their C interface (bindings.cpp).
#pragma once

#include <cstdint>

namespace aten_tpu_torch {

// The scene arrays the walk reads; all device pointers, row-major.
struct BvhView {
  const float* nodes_bmin;        // [K,3]
  const float* nodes_bmax;        // [K,3]
  const int32_t* nodes_hit;       // [K]  next node when the box is hit
  const int32_t* nodes_miss;      // [K]  next node when it is missed
  const int32_t* nodes_prim_start;  // [K] -1 for internal nodes
  const int32_t* nodes_prim_count;  // [K] <= LEAF_MAX
  const int32_t* prim_order;      // [P] leaf ranges -> global prim id
  const float* tri_v0;            // [T,3]
  const float* tri_e1;            // [T,3]
  const float* tri_e2;            // [T,3]
  const float* sph_center;        // [S,3]
  const float* sph_radius;        // [S]
  int32_t num_tris;               // prims below this id are triangles
};

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

// Enqueues the walk on `stream`; returns the cudaError_t of the launch.
int launch_bvh_traverse(const BvhView& bvh, const RayView& rays,
                        float t_min, bool any_hit, void* stream);

// The two-level pool of accel/tlas.py::build_two_level; device pointers.
struct TlasView {
  const float* tl_bmin;         // [K,3]
  const float* tl_bmax;         // [K,3]
  const int32_t* tl_hit;        // [K] next node when the box is hit; -1
                                //     done, -2 back to the top level
  const int32_t* tl_miss;       // [K] next node when it is missed
  const int32_t* tl_ps;         // [K] BLAS leaf range start, else -1
  const int32_t* tl_pc;         // [K] <= LEAF_MAX
  const int32_t* tl_inst;       // [K] instance at TLAS leaves, else -1
  const int32_t* tl_prim_order;  // [P] leaf ranges -> global prim id
  const float* inst_w2l;        // [I+1,3,4] world-to-local rows
  const float* tri_v0;          // [T,3] object-local
  const float* tri_e1;          // [T,3]
  const float* tri_e2;          // [T,3]
  const float* sph_center;      // [S,3]
  const float* sph_radius;      // [S]
  int32_t num_tris;             // prims below this id are triangles
  int32_t num_instances;        // I
};

// RayView plus the instance of each hit.
struct TlasRayView {
  RayView ray;
  int32_t* inst;  // [n] out: instance of the winner, -1 on a miss
};

int launch_tlas_traverse(const TlasView& tlas, const TlasRayView& rays,
                         float t_min, bool any_hit, void* stream);

// The Plücker treelet layout of ops/plk_layout.py; device pointers.
struct PlkView {
  const float* bmin;          // [Kt,3] cut-tree boxes
  const float* bmax;          // [Kt,3]
  const int32_t* hit;         // [Kt] next node when the box is hit
  const int32_t* miss;        // [Kt] next node when it is missed
  const int32_t* slot_start;  // [Kt] first slot of a fat leaf, else -1
  const int32_t* count;       // [Kt] slots of a fat leaf, <= 64
  const float* consts;        // [S,16] slot records, 16-byte aligned
  const int32_t* slot2prim;   // [S] global prim id of each slot
};

// Writes rays.t and rays.prim; rays.u and rays.v are not used.
int launch_plk_traverse(const PlkView& plk, const RayView& rays,
                        float t_min, bool any_hit, void* stream);

// The treelet layout of ops/trl_layout.py; device pointers.
// `nodes` and `recs` are 16-byte aligned (read as float4), `links`
// 8-byte aligned (read as int2).
struct TrlView {
  const float* nodes;    // [Kt,8] bmin, bmax, first slot of a fat leaf
                         //        (or -1) and its slot count as int bits
  const int32_t* links;  // [Kt,12] (hit, miss) per ordering 2*axis + neg
  const float* recs;     // [S,12] slot records (ops/trl_layout.py)
};

// Writes rays.t and rays.prim with `chains` rays per thread (1, 2, 4 or
// 8; -1 for any other); rays.u and rays.v are not used.
int launch_smt_traverse(const TrlView& trl, const RayView& rays, float t_min,
                        bool any_hit, int chains, void* stream);

const char* cuda_error_string(int code);

}  // namespace aten_tpu_torch
