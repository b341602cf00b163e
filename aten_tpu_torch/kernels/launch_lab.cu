// Launch and loop overhead microbenchmark (L2).
//
// Replaces the TPU lab kernel `make_kernel` of tools/launch_lab.py:18
// (launched by `run` :32): an (8,128) block plus the result of `steps`
// iterations of a scalar LCG, cur = (cur * 1103515245 + 12345) & 1023,
// written by every step of a `grid`-step grid to the same output block.
// On the TPU the grid steps run one after another on one core, so the
// lab prices a grid step; here the `grid` blocks of 1024 threads run in
// parallel on the card's SMs and all write the same value, so it prices
// a block.  The LCG runs in unsigned arithmetic (the TPU's int32
// wraparound has the same low ten bits).
//
// Bound: none that a throughput roofline gives; the lab measures the
// fixed cost of a launch, a block and a dependent loop iteration.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // the (8, 128) block

__global__ void __launch_bounds__(kThreads)
    launch_lab_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int32_t steps) {
  uint32_t cur = 0;
  for (int32_t i = 0; i < steps; ++i) cur = (cur * 1103515245u + 12345u) & 1023u;
  out[threadIdx.x] = x[threadIdx.x] + static_cast<float>(cur);
}

}  // namespace

extern "C" {

// Enqueues one launch of `grid` blocks on `stream`; x and out [8,128]
// float32 device pointers.  Returns 0, a cudaError_t (> 0), or -1 for
// bad arguments.
int aten_launch_lab(const float* x, float* out, int32_t steps, int32_t grid,
                    void* stream) {
  if (!x || !out || steps < 0 || grid <= 0) return -1;
  launch_lab_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, steps);
  return static_cast<int>(cudaGetLastError());
}

const char* aten_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
