// Pointer-chase latency microbenchmark (L3), one 1024-thread block.
//
// Replaces the TPU lab kernel `make_kernel` of tools/chase_lab.py:41
// (launched by `run` :181).  The TPU kernel walks a 16,384-row table
// (8 MiB, 128 float32 lanes per row, the next row's index in lane 7) for
// `steps` dependent steps over an (8,128) tile and times one step; its
// variants add what a treelet-walk step does around the load (a vector
// compare reduced to one flag, lane extracts, branches, interleaved
// chases).  Here one block of 1024 threads stands for the tile: thread
// tid holds element (tid / 128, tid % 128), the chase index is uniform
// over the block, and the tile's `jnp.any` becomes `__syncthreads_or`.
// Each variant is its own instantiation, as each is its own TPU program.
// The output is x + last + acc, as the reference computes it, so it is
// checked bit for bit against aten_tpu_torch/tools/chase_lab.py's plain
// version.
//
// Bound: none that a throughput roofline gives.  A step is one dependent
// load (an L1 or L2 hit once the table is warm) plus a few operations;
// the time per step is the latency of that chain.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // the (8, 128) tile
constexpr int kLanes = 128;     // floats per table row
constexpr int32_t kRows = 1 << 14;

enum Variant : int {
  kChase = 0,
  kReduce,
  kExtracts,
  kSmt4,
  kScalar,
  kCond,
  kSmt4Cond,
  kVec2Scalar,
  kRedKd,
  kRed11,
  kFori,
  kUnroll8,
  kNumVariants
};

__device__ __forceinline__ int32_t lane_int(const float* __restrict__ rows,
                                            int32_t row, int lane) {
  return __float_as_int(__ldg(rows + static_cast<int64_t>(row) * kLanes + lane));
}

__device__ __forceinline__ float lane_f(const float* __restrict__ rows,
                                       int32_t row, int lane) {
  return __ldg(rows + static_cast<int64_t>(row) * kLanes + lane);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    chase_lab_kernel(const float* __restrict__ rows, const float* __restrict__ x_in,
                     float* __restrict__ out, int32_t steps) {
  __shared__ int32_t warp_flags[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const float x = x_in[tid];
  int32_t cur = 0, acc = 0;
  if (V == kFori) {
    for (int32_t k = 0; k < steps; ++k) cur = lane_int(rows, cur, 7);
  } else if (V == kSmt4 || V == kSmt4Cond) {
    int32_t c0 = 0, c1 = 1, c2 = 2, c3 = 3;
    for (int32_t i = 0; i < steps; ++i) {
      const int32_t n0 = lane_int(rows, c0, 7), n1 = lane_int(rows, c1, 7);
      const int32_t n2 = lane_int(rows, c2, 7), n3 = lane_int(rows, c3, 7);
      if (V == kSmt4Cond) {
        if (n0 > kRows) acc += 1;
        if (n1 > kRows) acc += 1;
        if (n2 > kRows) acc += 1;
        if (n3 > kRows) acc += 1;
      }
      c0 = n0;
      c1 = n1;
      c2 = n2;
      c3 = n3;
    }
    cur = c0;
  } else if (V == kUnroll8) {
    for (int32_t i = 0; i < steps; i += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) cur = lane_int(rows, cur, 7);
    }
  } else {
    for (int32_t i = 0; i < steps; ++i) {
      if (V == kChase) {
        cur = lane_int(rows, cur, 7);
      } else if (V == kReduce) {
        const int32_t nxt = lane_int(rows, cur, 7);
        const float v = (lane_f(rows, cur, 0) - x) * (lane_f(rows, cur, 3) - x);
        acc += __syncthreads_or(v > 0.2f) ? 1 : 0;
        cur = nxt;
      } else if (V == kExtracts) {
        int32_t s = lane_int(rows, cur, 7);
        for (int k = 1; k < 6; ++k) {
          if (i == -k) s = lane_int(rows, cur, 7 + 2 * k);
          acc += lane_int(rows, cur, 6 + 2 * k);
        }
        cur = s;
      } else if (V == kScalar) {
        cur = static_cast<int32_t>(
            (static_cast<uint32_t>(cur) * 1103515245u + 12345u) & (kRows - 1));
      } else if (V == kCond) {
        const int32_t nxt = lane_int(rows, cur, 7);
        if (nxt > kRows) acc += 1;
        cur = nxt;
      } else if (V == kVec2Scalar) {
        const int32_t nxt = lane_int(rows, cur, 7);
        acc += __syncthreads_or(lane_f(rows, cur, lane) - x > 0.5f) ? 1 : 0;
        cur = nxt;
      } else if (V == kRedKd) {
        // one flag per warp, then an OR of the 32 flags through shared
        // memory (the TPU reduces to (8,1) and ORs the 8 in scalar)
        const int32_t nxt = lane_int(rows, cur, 7);
        const bool w = __any_sync(0xffffffffu, lane_f(rows, cur, lane) - x > 0.5f);
        if (tid % 32 == 0) warp_flags[tid / 32] = w ? 1 : 0;
        __syncthreads();
        int32_t h = 0;
        for (int g = 0; g < kThreads / 32; ++g) h |= warp_flags[g];
        __syncthreads();
        acc += h > 0 ? 1 : 0;
        cur = nxt;
      } else if (V == kRed11) {
        const int32_t nxt = lane_int(rows, cur, 7);
        acc += __syncthreads_count(lane_f(rows, cur, lane) - x > 0.5f) > 0 ? 1 : 0;
        cur = nxt;
      }
    }
  }
  out[tid] = (x + static_cast<float>(cur)) + static_cast<float>(acc);
}

template <int V>
int launch_variant(const float* rows, const float* x, float* out, int32_t steps,
                   cudaStream_t s) {
  chase_lab_kernel<V><<<1, kThreads, 0, s>>>(rows, x, out, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueues variant `variant` (the order of tools/chase_lab.py's VARIANTS)
// on `stream`.  rows [16384,128], x and out [8,128], float32 device
// pointers.  Returns 0, a cudaError_t (> 0), or -1 for bad arguments.
int aten_chase_lab(const float* rows, const float* x, float* out, int32_t steps,
                   int32_t variant, void* stream) {
  if (!rows || !x || !out || steps < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kChase: return launch_variant<kChase>(rows, x, out, steps, s);
    case kReduce: return launch_variant<kReduce>(rows, x, out, steps, s);
    case kExtracts: return launch_variant<kExtracts>(rows, x, out, steps, s);
    case kSmt4: return launch_variant<kSmt4>(rows, x, out, steps, s);
    case kScalar: return launch_variant<kScalar>(rows, x, out, steps, s);
    case kCond: return launch_variant<kCond>(rows, x, out, steps, s);
    case kSmt4Cond: return launch_variant<kSmt4Cond>(rows, x, out, steps, s);
    case kVec2Scalar: return launch_variant<kVec2Scalar>(rows, x, out, steps, s);
    case kRedKd: return launch_variant<kRedKd>(rows, x, out, steps, s);
    case kRed11: return launch_variant<kRed11>(rows, x, out, steps, s);
    case kFori: return launch_variant<kFori>(rows, x, out, steps, s);
    case kUnroll8: return launch_variant<kUnroll8>(rows, x, out, steps, s);
    default: return -1;
  }
}

}  // extern "C"
