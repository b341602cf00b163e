// Treelet-walk microbenchmark (L1): one block per tile of R x 128 rays,
// the tile walked with one node cursor moved by the tile's vote.
//
// Replaces the TPU lab kernels of tools/kernel_lab.py: `make_nodes_kernel`
// :36 and `make_leafu_kernel` :96 (launched by `run` :194),
// `make_wide_kernel` :343 (`run_wide` :451), `make_spec_kernel` :468
// (`run_spec` :578) and `make_plk_kernel` :661 (`run_plk` :783).  Each TPU
// kernel walks an (R, 128) tile of rays with one cursor over the cut tree:
// a node row is loaded, every ray runs the slab test, `jnp.any` of the
// hits picks the hit or the miss link for the whole tile, and fat leaves
// are drained for every ray of the tile.  That tile walk is what the lab
// measures, and each kernel here computes it unchanged: the same rays in
// the same tiles, the same vote, the same drains, in the order of the
// plain version (aten_tpu_torch/tools/kernel_lab.py::run_plain), so the
// two agree bit for bit.  A block of B threads walks one tile, K = R x
// 128 / B rays a thread: ray i of the tile is ray k of thread i % B, k =
// i / B.  The vote is `__syncthreads_or`, and the cursor, the latched
// leaf and the link ordering are the same in every thread.  The ordering
// comes from the tile's summed direction, a pairwise tree (element i plus
// element i + h, h halving): its first levels add a thread's own rays in
// registers, the rest run in shared memory.
//
// Node records (32 B), link pairs (8 B) and slot records (48 B) of the
// port's K4 layout (ops/trl_layout.py) are read by every thread at the
// same address, through the read-only path.  The slot test is
// moller_trumbore_at.  Built with --fmad=false, every float op rounds as in
// the plain version.
//
//   nodes, nodir  node walk only; a hit fat leaf records its t_enter and
//                 row start (nodir: ordering 0's links)
//   leafu         one row of 8 slots per iteration while slots are left,
//                 the cursor frozen; the row test runs every iteration,
//                 masked (no branch around it, as in the TPU kernel)
//   wide          the leaf latched on one step is drained on the next:
//                 behind a block-uniform branch, or (nc) every step, masked
//   spec          wide, with both successors' records loaded before the
//                 slab math of the current node
//   plk           on entering a leaf, its 8 KB block E [8, 256] is copied
//                 into shared memory with cp.async (the TPU's DMA start)
//                 and waited for on the next step (the DMA wait), into two
//                 buffers in turn, so the next leaf's copy runs under this
//                 leaf's drain; each thread forms its rays' columns of
//                 S = E^T R6 and NUM = E[:, 192:]^T R4 as fixed-order fp32
//                 sums (no tensor cores: TF32 would round the products,
//                 and Hopper has no fp32 matrix instruction), each column's
//                 block entries read once for its K rays, then the slot
//                 tests of tools/kernel_lab.py:709-724
//
// Bound: what these walks compute is a closest hit (or, for nodes, the
// nearest fat-leaf box), whose least work is a per-ray walk (~25
// operations a node step, ~53 a slot test) over a pool that fits the L2
// cache.  A tile walk does more: every ray of the tile steps through the
// union of the nodes its rays need, and drains every leaf any of them
// enters, its fixed window of slots masked (run_plain(stats=True) counts
// it), so the masked drains are instruction-bound.  The mapping: B = 1024
// threads (K = 1, or 2 for 16-row tiles) in every kernel but plk, whose
// block entries K = 4 rays share (B = 512).  Persistent blocks taking
// tiles from a counter, and K = 2, 4 or 8 in the other kernels, ran no
// faster on the H100 (PERF.md §6).
#include <cuda_runtime.h>

#include <cstdint>

#include "traverse_device.cuh"

namespace aten_tpu_torch {
namespace {

constexpr int kThreads = 1024;         // threads a tile, plk's aside
constexpr int kPlkRays = 4;            // plk: rays a thread
constexpr int kPlkThreads = 16 * 128 / kPlkRays;
constexpr int kPack = 8;
constexpr int kWindow = 64;            // plk's block: 64 slots a treelet
constexpr int kEWidth = 4 * kWindow;   // E block columns
constexpr float kTMin = 1e-4f;

enum Kind : int { kNodes = 0, kNodir, kLeafu, kWide, kSpec, kPlk };

struct LabArgs {
  const float4* nodes;   // [Kt] x 2: (bmin, bmax.x) (bmax.yz, first slot, count)
  const int2* links;     // [Kt] x 6: (hit, miss) per ordering
  const float4* recs;    // [n_slots] x 3: (v0, e1.x) (e1.yz, e2.xy) (e2.z, id, tri, 0)
  int64_t n_slots;
  const float* emat;     // [NT * 8, 256]
  const int32_t* pids;   // [NT, 64]
  const int32_t* tre;    // [Kt] treelet id, -1 off fat leaves
  const float* ro;
  const float* rd;
  const float* t0;
  float* t;
  int32_t* prim;
  int32_t drain_slots;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t;
  int32_t prim;
};

struct Node {
  float4 a, b;
  int2 lk;
};

// The lab's safe inverse (tools/kernel_lab.py:44-46).
__device__ __forceinline__ float lab_safe_inv(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// Ray k of this thread is ray threadIdx.x + k * B of the block's tile.
template <int K, int B>
__device__ __forceinline__ void load_rays(const LabArgs& p, Ray (&ray)[K]) {
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * (K * B);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t i = tile0 + threadIdx.x + k * B;
    Ray& y = ray[k];
    y.ox = p.ro[3 * i];
    y.oy = p.ro[3 * i + 1];
    y.oz = p.ro[3 * i + 2];
    y.dx = p.rd[3 * i];
    y.dy = p.rd[3 * i + 1];
    y.dz = p.rd[3 * i + 2];
    y.ix = lab_safe_inv(y.dx);
    y.iy = lab_safe_inv(y.dy);
    y.iz = lab_safe_inv(y.dz);
    y.t = p.t0[i];
    y.prim = -1;
  }
}

template <int K, int B>
__device__ __forceinline__ void store_rays(const LabArgs& p, const Ray (&ray)[K]) {
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * (K * B);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t i = tile0 + threadIdx.x + k * B;
    p.t[i] = ray[k].t;
    p.prim[i] = ray[k].prim;
  }
}

// The tile's ordering: `_pick_ordering`'s rule (traverse_pallas.py:761-772)
// on the pairwise-tree sum of the tile's directions.  The levels h = T/2
// .. B add a thread's rays k and k + h / B in registers; the levels below
// run in shared memory.
template <int K, int B>
__device__ int32_t tile_ordering(const Ray (&ray)[K]) {
  __shared__ float sx[B], sy[B], sz[B];
  const int tid = threadIdx.x;
  float x[K], y[K], z[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = ray[k].dx;
    y[k] = ray[k].dy;
    z[k] = ray[k].dz;
  }
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) {
      x[k] = x[k] + x[k + h];
      y[k] = y[k] + y[k + h];
      z[k] = z[k] + z[k + h];
    }
  }
  sx[tid] = x[0];
  sy[tid] = y[0];
  sz[tid] = z[0];
  __syncthreads();
#pragma unroll
  for (int h = B / 2; h > 0; h >>= 1) {
    if (tid < h) {
      sx[tid] = sx[tid] + sx[tid + h];
      sy[tid] = sy[tid] + sy[tid + h];
      sz[tid] = sz[tid] + sz[tid + h];
    }
    __syncthreads();
  }
  const float X = sx[0], Y = sy[0], Z = sz[0];
  const float ax = fabsf(X), ay = fabsf(Y), az = fabsf(Z);
  const int32_t ox = X >= 0.0f ? 0 : 1;
  const int32_t oy = Y >= 0.0f ? 2 : 3;
  const int32_t oz = Z >= 0.0f ? 4 : 5;
  return (ax >= ay && ax >= az) ? ox : (ay >= az ? oy : oz);
}

__device__ __forceinline__ Node load_node(const LabArgs& p, int32_t k, int32_t ord) {
  const int64_t kk = k < 0 ? 0 : k;
  Node n;
  n.a = __ldg(p.nodes + 2 * kk);
  n.b = __ldg(p.nodes + 2 * kk + 1);
  n.lk = __ldg(p.links + 6 * kk + ord);
  return n;
}

__device__ __forceinline__ int32_t first_slot(const Node& n) { return __float_as_int(n.b.z); }
__device__ __forceinline__ int32_t slot_count(const Node& n) { return __float_as_int(n.b.w); }

// Slab test of the node's box against the ray with its current t.
__device__ __forceinline__ bool slab(const Node& n, const Ray& y, float& t_enter) {
  const float tx0 = (n.a.x - y.ox) * y.ix, tx1 = (n.a.w - y.ox) * y.ix;
  const float ty0 = (n.a.y - y.oy) * y.iy, ty1 = (n.b.x - y.oy) * y.iy;
  const float tz0 = (n.a.z - y.oz) * y.iz, tz1 = (n.b.y - y.oz) * y.iz;
  t_enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return t_enter <= t_exit && t_exit > 0.0f && t_enter < y.t;
}

// Whether any ray of the tile hits the node's box (the tile's vote).
template <int K>
__device__ __forceinline__ bool vote(const Node& n, const Ray (&ray)[K]) {
  bool h = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float te;
    h |= slab(n, ray[k], te);
  }
  return __syncthreads_or(h) != 0;
}

// Moller-Trumbore of one slot for the thread's K rays, kept where `ok`:
// one record load for K tests.
template <int K>
__device__ __forceinline__ void test_slot(const LabArgs& p, int64_t slot, bool ok,
                                          Ray (&ray)[K]) {
  slot = slot < p.n_slots ? slot : p.n_slots - 1;
  const float4 a = __ldg(p.recs + 3 * slot), b = __ldg(p.recs + 3 * slot + 1);
  const float4 c = __ldg(p.recs + 3 * slot + 2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Ray& y = ray[k];
    float tt = 0.0f, u, v;
    const bool hp = moller_trumbore_at(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, y.ox,
                                       y.oy, y.oz, y.dx, y.dy, y.dz, kTMin, tt, u, v);
    if (hp && ok && tt < y.t) {
      y.t = tt;
      y.prim = __float_as_int(c.y);
    }
  }
}

// The drain of tools/kernel_lab.py:390-397: drain_slots slots from the
// leaf's first slot, those past its count masked.
template <int K>
__device__ __forceinline__ void drain_mt(const LabArgs& p, int32_t pstart, int32_t pcount,
                                         Ray (&ray)[K]) {
  const int64_t base = pstart < 0 ? 0 : pstart;
  for (int32_t s = 0; s < p.drain_slots; ++s) test_slot<K>(p, base + s, s < pcount, ray);
}

template <bool kDirectional>
__global__ void __launch_bounds__(kThreads) nodes_kernel(LabArgs p) {
  Ray ray[1];
  load_rays<1, kThreads>(p, ray);
  const int32_t ord = kDirectional ? tile_ordering<1, kThreads>(ray) : 0;
  int32_t cur = 0;
  while (cur >= 0) {
    const Node n = load_node(p, cur, ord);
    float te;
    const bool hv = slab(n, ray[0], te);
    const bool any = __syncthreads_or(hv) != 0;
    const int32_t first = first_slot(n);
    const int32_t start = first >= 0 ? first / kPack : -1;
    if (hv && start >= 0 && te > kTMin && te < ray[0].t) {
      ray[0].t = te;
      ray[0].prim = start;
    }
    cur = any ? n.lk.x : n.lk.y;
  }
  store_rays<1, kThreads>(p, ray);
}

__global__ void __launch_bounds__(kThreads) leafu_kernel(LabArgs p) {
  Ray ray[1];
  load_rays<1, kThreads>(p, ray);
  const int32_t ord = tile_ordering<1, kThreads>(ray);
  int32_t cur = 0, pnext = -1, pleft = 0;
  while (cur >= 0 || pleft > 0) {
    const bool busy = pleft > 0;
    const Node n = load_node(p, cur, ord);
    const bool any = vote(n, ray) && cur >= 0 && !busy;
    const int32_t first = first_slot(n), count = slot_count(n);
    const bool enter = any && first >= 0 && count > 0;
    const int32_t nxt = (busy || cur < 0) ? cur : (any ? n.lk.x : n.lk.y);
    if (enter) {
      pnext = first;
      pleft = count;
    }
    const int64_t row = pnext < 0 ? 0 : pnext;
#pragma unroll
    for (int j = 0; j < kPack; ++j) test_slot<1>(p, row + j, busy && j < pleft, ray);
    if (busy) {
      pnext += kPack;
      pleft = pleft > kPack ? pleft - kPack : 0;
    }
    cur = nxt;
  }
  store_rays<1, kThreads>(p, ray);
}

template <int K, bool kCond>
__global__ void __launch_bounds__(kThreads) wide_kernel(LabArgs p) {
  Ray ray[K];
  load_rays<K, kThreads>(p, ray);
  const int32_t ord = tile_ordering<K, kThreads>(ray);
  int32_t cur = 0, pstart = -1, pcount = 0;
  while (cur >= 0 || pstart >= 0) {
    const bool active = cur >= 0;
    const Node n = load_node(p, cur, ord);
    const bool any = vote(n, ray) && active;
    const bool enter = first_slot(n) >= 0 && any;
    if (!kCond || pstart >= 0) drain_mt<K>(p, pstart, pcount, ray);
    pstart = enter ? first_slot(n) : -1;
    pcount = enter ? slot_count(n) : 0;
    if (active) cur = any ? n.lk.x : n.lk.y;
  }
  store_rays<K, kThreads>(p, ray);
}

template <int K>
__global__ void __launch_bounds__(kThreads) spec_kernel(LabArgs p) {
  Ray ray[K];
  load_rays<K, kThreads>(p, ray);
  const int32_t ord = tile_ordering<K, kThreads>(ray);
  Node nh = load_node(p, 0, ord), nm = nh;
  bool take_hit = true;
  int32_t cur = 0, pstart = -1, pcount = 0;
  while (cur >= 0 || pstart >= 0) {
    const bool active = cur >= 0;
    const Node n = take_hit ? nh : nm;
    // both successors' records, in flight during the math below
    nh = load_node(p, n.lk.x, ord);
    nm = load_node(p, n.lk.y, ord);
    const bool any = vote(n, ray) && active;
    const bool enter = first_slot(n) >= 0 && any;
    if (pstart >= 0) drain_mt<K>(p, pstart, pcount, ray);
    pstart = enter ? first_slot(n) : -1;
    pcount = enter ? slot_count(n) : 0;
    if (active) cur = any ? n.lk.x : n.lk.y;
    take_hit = any;
  }
  store_rays<K, kThreads>(p, ray);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for all of this thread's copies but the `newer` most recent groups.
__device__ __forceinline__ void cp_async_wait(bool newer) {
  if (newer) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// The lab's Plücker drain (tools/kernel_lab.py:696-725) of the block in
// shared memory for the thread's rays (m = ro x rd): per slot j, the
// block's entries of its columns are read once, then each ray's sums
// S = ((((e0 dx + e1 dy) + e2 dz) + e3 mx) + e4 my) + e5 mz and
// NUM = ((q0 ox + q1 oy) + q2 oz) + q3, in plk_products' order.
template <int K>
__device__ __forceinline__ void drain_plk(const float* __restrict__ e,
                                          const int32_t* __restrict__ pids, Ray (&ray)[K],
                                          const float (&m)[K][3]) {
  for (int j = 0; j < kWindow; ++j) {
    const int32_t pid = __ldg(pids + j);
    float c[4][6];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < 6; ++r) c[g][r] = e[r * kEWidth + g * kWindow + j];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Ray& y = ray[k];
      float s[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        s[g] = ((((c[g][0] * y.dx + c[g][1] * y.dy) + c[g][2] * y.dz) + c[g][3] * m[k][0]) +
                c[g][4] * m[k][1]) +
               c[g][5] * m[k][2];
      }
      const float num = ((c[3][0] * y.ox + c[3][1] * y.oy) + c[3][2] * y.oz) + c[3][3];
      const float s0 = s[0], s1 = s[1], s2 = s[2], den = s[3];
      const bool inside = (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) ||
                          (s0 <= 0.0f && s1 <= 0.0f && s2 <= 0.0f);
      const bool dok = fabsf(den) > 1e-12f;
      const float tt = -num / (dok ? den : 1e12f);
      if (inside && dok && tt > kTMin && pid >= 0 && tt < y.t) {
        y.t = tt;
        y.prim = pid;
      }
    }
  }
}

__global__ void __launch_bounds__(kPlkThreads) plk_kernel(LabArgs p) {
  constexpr int K = kPlkRays, B = kPlkThreads;
  __shared__ __align__(16) float eblk[2][8 * kEWidth];
  constexpr int kChunks = 8 * kEWidth / 4;  // 16-byte copies of one block
  Ray ray[K];
  load_rays<K, B>(p, ray);
  const int32_t ord = tile_ordering<K, B>(ray);
  float m[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Ray& y = ray[k];
    m[k][0] = y.oy * y.dz - y.oz * y.dy;
    m[k][1] = y.oz * y.dx - y.ox * y.dz;
    m[k][2] = y.ox * y.dy - y.oy * y.dx;
  }
  int32_t cur = 0, pend = -1, pbuf = 0;
  while (cur >= 0 || pend >= 0) {
    const bool active = cur >= 0;
    const Node n = load_node(p, cur, ord);
    const int32_t tre = __ldg(p.tre + (cur < 0 ? 0 : cur));
    // the vote's barrier also orders the last drain of a buffer before
    // the copy that reuses it
    const bool any = vote(n, ray) && active;
    const bool enter = first_slot(n) >= 0 && any && tre >= 0;
    const int nbuf = pbuf ^ 1;
    if (enter) {
      const float* src = p.emat + static_cast<int64_t>(tre) * 8 * kEWidth;
      for (int q = threadIdx.x; q < kChunks; q += B) {
        cp_async16(eblk[nbuf] + 4 * q, src + 4 * q);
      }
      cp_async_commit();
    }
    if (pend >= 0) {
      cp_async_wait(enter);  // the pending block's copy, not the one just started
      __syncthreads();
      drain_plk<K>(eblk[pbuf], p.pids + static_cast<int64_t>(pend) * kWindow, ray, m);
    }
    pend = enter ? tre : -1;
    pbuf = enter ? nbuf : pbuf;
    if (active) cur = any ? n.lk.x : n.lk.y;
  }
  store_rays<K, B>(p, ray);
}

// Launches kind `kind` over n / (tile_rows x 128) tiles, one block each.
int launch(int32_t kind, int32_t tile_rows, bool leaf_cond, const LabArgs& p,
           unsigned blocks, cudaStream_t s) {
  const bool r16 = tile_rows == 16;
  switch (kind) {
    case kNodes:
      if (r16) return -1;
      nodes_kernel<true><<<blocks, kThreads, 0, s>>>(p);
      break;
    case kNodir:
      if (r16) return -1;
      nodes_kernel<false><<<blocks, kThreads, 0, s>>>(p);
      break;
    case kLeafu:
      if (r16) return -1;
      leafu_kernel<<<blocks, kThreads, 0, s>>>(p);
      break;
    case kWide:
      if (r16 && leaf_cond) wide_kernel<2, true><<<blocks, kThreads, 0, s>>>(p);
      else if (r16) wide_kernel<2, false><<<blocks, kThreads, 0, s>>>(p);
      else if (leaf_cond) wide_kernel<1, true><<<blocks, kThreads, 0, s>>>(p);
      else wide_kernel<1, false><<<blocks, kThreads, 0, s>>>(p);
      break;
    case kSpec:
      if (r16) spec_kernel<2><<<blocks, kThreads, 0, s>>>(p);
      else spec_kernel<1><<<blocks, kThreads, 0, s>>>(p);
      break;
    case kPlk:
      if (!r16) return -1;
      plk_kernel<<<blocks, kPlkThreads, 0, s>>>(p);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aten_tpu_torch

extern "C" {

// Enqueues lab kernel `kind` (the order of tools/kernel_lab.py's KINDS) on
// `stream` for n rays in tiles of tile_rows x 128 (8 or 16; nodes, nodir
// and leafu take 8, plk 16), each drain of drain_slots (>= 1) slots:
// nodes [Kt,8] f32, links [Kt,12] i32, recs [n_slots,12] f32, emat
// [NT*8,256] f32, pids [NT,64] i32, tre [Kt] i32, ro and rd [n,3] f32, t0
// [n] f32; outputs t [n] f32 and prim [n] i32.  Returns 0, a cudaError_t
// (> 0), or -1 for bad arguments.
int aten_kernel_lab(int32_t kind, int32_t tile_rows, int32_t leaf_cond, int32_t drain_slots,
                    const float* nodes, const int32_t* links, const float* recs,
                    const float* emat, const int32_t* pids, const int32_t* tre,
                    int64_t n_slots, const float* ro, const float* rd, const float* t0,
                    float* t, int32_t* prim, int64_t n, void* stream) {
  using namespace aten_tpu_torch;
  const int64_t tile = static_cast<int64_t>(tile_rows) * 128;
  if ((tile_rows != 8 && tile_rows != 16) || n <= 0 || n % tile != 0 || n_slots <= 0 ||
      drain_slots < 1 || !nodes || !links || !recs || !emat || !pids || !tre || !ro ||
      !rd || !t0 || !t || !prim || n / tile >= (int64_t{1} << 31))
    return -1;
  LabArgs p{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const int2*>(links),
            reinterpret_cast<const float4*>(recs), n_slots, emat, pids, tre, ro, rd, t0, t,
            prim, drain_slots};
  return launch(kind, tile_rows, leaf_cond != 0, p, static_cast<unsigned>(n / tile),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
