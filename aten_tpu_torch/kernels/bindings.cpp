// Plain C interface of the traversal kernels, loaded from Python with
// ctypes (aten_tpu_torch/ops/traverse_cuda.py, ops/tlas_cuda.py,
// ops/plk_cuda.py, ops/smt_cuda.py).  It includes no PyTorch
// header, so the whole library builds in seconds.  Pointers are device
// addresses of contiguous tensors the caller has checked; `stream` is
// the caller's current CUDA stream.
#include <cstdint>

#include "bvh_traverse.h"

namespace {

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rays the persistent kernels' 32-bit ray queue takes.
constexpr int64_t kMaxRays = int64_t{1} << 31;

}  // namespace

extern "C" {

// Returns 0, a cudaError_t of the launch (> 0), or -1 for bad arguments.
// `next_ray` is one zeroed counter in device memory.  `steps` and `tests`
// [n] are both null (the plain instantiations) or both set (the kStats
// ones, which write each ray's node steps and prim tests there).
int aten_bvh_traverse(const float* nodes, const float* prims, int32_t num_tris,
                      const float* ro, const float* rd, const float* t0,
                      float* t, int32_t* prim, float* u, float* v, int64_t n,
                      float t_min, int32_t any_hit, int32_t lod,
                      int32_t* steps, int32_t* tests,
                      unsigned* next_ray, void* stream) {
  if (n < 0 || n >= kMaxRays || num_tris < 0) return -1;
  if (n > 0 && (!ro || !rd || !t0 || !t || !prim || !u || !v || !next_ray))
    return -1;
  if (!nodes || !prims || !aligned16(nodes) || !aligned16(prims)) return -1;
  if (!steps != !tests) return -1;
  const aten_tpu_torch::BvhView bvh{nodes, prims, num_tris};
  const aten_tpu_torch::RayView rays{ro, rd, t0, t, prim, u, v, n};
  const aten_tpu_torch::CountView counts{steps, nullptr, tests};
  return aten_tpu_torch::launch_bvh_traverse(bvh, rays, counts, t_min, any_hit != 0,
                                             lod != 0, next_ray, stream);
}

// The two-level walk; returns as aten_bvh_traverse does.
int aten_tlas_traverse(const float* nodes, const float* insts, const float* prims,
                       int32_t num_tris, int32_t num_instances, const float* ro,
                       const float* rd, const float* t0, float* t, int32_t* prim,
                       int32_t* inst, float* u, float* v, int64_t n, float t_min,
                       int32_t any_hit, unsigned* next_ray, void* stream) {
  if (n < 0 || n >= kMaxRays || num_tris < 0 || num_instances <= 0) return -1;
  if (n > 0 && (!ro || !rd || !t0 || !t || !prim || !inst || !u || !v || !next_ray))
    return -1;
  if (!nodes || !insts || !prims || !aligned16(nodes) || !aligned16(insts) ||
      !aligned16(prims))
    return -1;
  const aten_tpu_torch::TlasView tlas{nodes, insts, prims, num_tris, num_instances};
  const aten_tpu_torch::TlasRayView rays{{ro, rd, t0, t, prim, u, v, n}, inst};
  return aten_tpu_torch::launch_tlas_traverse(tlas, rays, t_min, any_hit != 0,
                                              next_ray, stream);
}

// The Plücker treelet walk at drain window `window` (8, 16, 32, 64 or
// 128); returns as aten_bvh_traverse does.  `steps`, `leaves` and `tests`
// [n] are all null or all set (the kStats instantiations: node steps, fat
// leaves entered, slot tests per ray).
int aten_plk_traverse(const float* nodes, const float* consts,
                      const int32_t* slot2prim, int32_t n_slots, const float* ro,
                      const float* rd, const float* t0, float* t,
                      int32_t* prim, int64_t n, float t_min, int32_t any_hit,
                      int32_t lod, int32_t window, int32_t* steps, int32_t* leaves,
                      int32_t* tests, unsigned* next_ray, void* stream) {
  if (n < 0 || n >= kMaxRays || n_slots < 0) return -1;
  if (n > 0 && (!ro || !rd || !t0 || !t || !prim || !next_ray)) return -1;
  if (!nodes || !consts || !slot2prim || !aligned16(nodes) || !aligned16(consts))
    return -1;
  if (!steps != !leaves || !steps != !tests) return -1;
  const aten_tpu_torch::PlkView plk{nodes, consts, slot2prim, n_slots};
  const aten_tpu_torch::RayView rays{ro, rd, t0, t, prim, nullptr, nullptr, n};
  const aten_tpu_torch::CountView counts{steps, leaves, tests};
  return aten_tpu_torch::launch_plk_traverse(plk, rays, counts, t_min, any_hit != 0,
                                             lod != 0, window, next_ray, stream);
}

// The multi-chain treelet walk at drain window `window` (a multiple of 8
// up to 128); returns as aten_bvh_traverse does.
int aten_smt_traverse(const float* nodes, const int32_t* links,
                      const float* recs, const float* ro, const float* rd,
                      const float* t0, float* t, int32_t* prim, int64_t n,
                      float t_min, int32_t any_hit, int32_t chains,
                      int32_t lod, int32_t window, unsigned* next_ray, void* stream) {
  if (n < 0 || n >= kMaxRays || !(t_min >= 0.0f)) return -1;
  if (n > 0 && (!ro || !rd || !t0 || !t || !prim || !next_ray)) return -1;
  if (!nodes || !links || !recs) return -1;
  if (!aligned16(nodes) || !aligned16(recs) ||
      reinterpret_cast<uintptr_t>(links) % 8 != 0)
    return -1;
  const aten_tpu_torch::TrlView trl{nodes, links, recs};
  const aten_tpu_torch::RayView rays{ro, rd, t0, t, prim, nullptr, nullptr, n};
  return aten_tpu_torch::launch_smt_traverse(trl, rays, t_min, any_hit != 0,
                                             chains, lod != 0, window, next_ray, stream);
}

const char* aten_cuda_error_string(int code) {
  return aten_tpu_torch::cuda_error_string(code);
}

}  // extern "C"
