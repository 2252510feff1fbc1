// Sliding length-window aggregation step for NVIDIA Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/windowed_agg.py:185 build_wagg_step_pallas (the
// TPU kernel, pl.pallas_call at :275) and, on the public path, the jnp scan
// twin the JAX package runs there instead (:53 build_wagg_step).  Contract
// (siddhi_tpu_torch/ops/windowed_agg.py): per partition lane p, for each of
// the block's T events in order, evict-one/append-one on a length-W ring,
// Kahan-compensated running sum, count, and optionally min/max over the live
// slots [0, cnt), emitted after every event.  Events with ok == 0 change
// nothing and repeat the previous output.
//
// Layout: the JAX package's public row-major layout, ring [P, W] and blocks
// [P, T].  (The Pallas kernel's lanes-last transpose is a TPU tiling
// artefact.)  The carry (ring, pos, cnt, runsum, comp) is updated in place.
//
// Arithmetic: the Kahan lines are the reference's, in the same order, in
// float32; built without --use_fast_math and with --fmad=false (see
// ops/_kernels.py), so the results equal the plain PyTorch version exactly.
// The evicted value is read from its slot, as the Pallas kernel does (the
// jnp twin's sum(ring * onehot) would turn NaN next to a live +-inf slot).
//
// Two paths, one entry point:
//   sum/count (want_minmax == 0): one thread per lane runs its T events in
//     order, touching only the evicted/written slot of the ring.
//   min/max: one warp per lane; every thread computes the scalar update,
//     the lane's ring row is staged in shared memory (4 KB at W = 1000), and
//     after each accepted event the warp reduces the live slots with
//     __shfl_xor_sync.  An event with ok == 0 changes no slot, so it repeats
//     the previous min/max without a rescan.  NaN propagates as in
//     jnp.min/jnp.max; an empty window gives +inf/-inf.  A row too large for
//     shared memory is read from global memory by the same kernel.
//
// What bounds it on this card.  The function moves P*T*(4+1+4+4) bytes for
// values, ok, sums and counts, plus T slot reads and writes per lane on the
// sum path; with min/max also P*T*8 for mins/maxs and P*W*4 read + written
// for the ring.  Its operations are a few per accepted event: the Kahan
// update, and O(1) amortized compares for each of min and max (a monotonic
// deque or van Herk/Gil-Werman blocks).  At the main path's shape
// (P = 1024, W = 1000, T ~ 300) that is ~15 MB against a few million
// operations: bound by bytes, ~4.5 us on HBM3.  This first version is far
// above it.  Each lane's events are a sequential chain; the sum path gives
// one thread per lane (threads stride by T through values/sums, so loads
// are uncoalesced); and the min/max path rescans all live slots after each
// accepted event, ~P*T*cnt compares in place of the O(P*T) the function
// needs.  A later version should stage [P-tile, T] blocks through shared
// memory (cp.async) for coalesced access, and replace the rescan by an
// incremental extremum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumThreads = 32;           // lanes per block, sum path
constexpr int kMaxWarps = 4;              // lanes per block, min/max path
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may use

// jnp.min / jnp.max propagate NaN; fminf / fmaxf would drop it.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// One event of one lane: the JAX package's evict/append and Kahan lines.
__device__ __forceinline__ void lane_update(float x, bool ok, float old,
                                            int W, float& runsum,
                                            float& comp, int& pos,
                                            int& cnt) {
  const float delta = x - (cnt == W ? old : 0.0f);
  const float y = delta - comp;
  const float t = runsum + y;
  if (ok) {
    comp = (t - runsum) - y;
    runsum = t;
    pos = (pos + 1) % W;
    cnt = min(cnt + 1, W);
  }
}

__global__ void wagg_sum_kernel(const float* __restrict__ values,
                                const uint8_t* __restrict__ ok,
                                float* __restrict__ ring,
                                int* __restrict__ pos_io,
                                int* __restrict__ cnt_io,
                                float* __restrict__ runsum_io,
                                float* __restrict__ comp_io,
                                float* __restrict__ sums,
                                int* __restrict__ counts, int P, int T,
                                int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float runsum = runsum_io[p], comp = comp_io[p];
  int pos = pos_io[p], cnt = cnt_io[p];
  float* row = ring + (size_t)p * W;
  const size_t base = (size_t)p * T;
  for (int t = 0; t < T; ++t) {
    const float x = values[base + t];
    const bool acc = ok[base + t] != 0;
    const int slot = pos;
    const float old = (cnt == W) ? row[slot] : 0.0f;
    lane_update(x, acc, old, W, runsum, comp, pos, cnt);
    if (acc) row[slot] = x;
    sums[base + t] = runsum;
    counts[base + t] = cnt;
  }
  pos_io[p] = pos;
  cnt_io[p] = cnt;
  runsum_io[p] = runsum;
  comp_io[p] = comp;
}

__global__ void wagg_minmax_kernel(const float* __restrict__ values,
                                   const uint8_t* __restrict__ ok,
                                   float* __restrict__ ring,
                                   int* __restrict__ pos_io,
                                   int* __restrict__ cnt_io,
                                   float* __restrict__ runsum_io,
                                   float* __restrict__ comp_io,
                                   float* __restrict__ sums,
                                   int* __restrict__ counts,
                                   float* __restrict__ mins,
                                   float* __restrict__ maxs, int P, int T,
                                   int W, int use_smem) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;                     // whole warp leaves together
  float* grow = ring + (size_t)p * W;
  float* row = use_smem ? smem + (size_t)warp * W : grow;
  if (use_smem) {
    for (int j = lid; j < W; j += 32) row[j] = grow[j];
    __syncwarp();
  }
  float runsum = runsum_io[p], comp = comp_io[p];
  int pos = pos_io[p], cnt = cnt_io[p];
  const size_t base = (size_t)p * T;
  // the warp-wide min/max of the live slots; every thread holds it after
  // the butterfly, and it stays valid until an accepted event moves a slot
  float mn = INFINITY, mx = -INFINITY;
  bool have = false;
  for (int t = 0; t < T; ++t) {
    const float x = values[base + t];
    const bool acc = ok[base + t] != 0;   // the same in every thread
    const int slot = pos;
    const float old = row[slot];
    lane_update(x, acc, old, W, runsum, comp, pos, cnt);
    if (acc || !have) {
      __syncwarp();                       // every thread has read `old`
      if (acc && lid == 0) row[slot] = x;
      __syncwarp();
      mn = INFINITY;
      mx = -INFINITY;
      for (int j = lid; j < cnt; j += 32) {
        const float r = row[j];
        mn = nan_min(mn, r);
        mx = nan_max(mx, r);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mn = nan_min(mn, __shfl_xor_sync(kFull, mn, off));
        mx = nan_max(mx, __shfl_xor_sync(kFull, mx, off));
      }
      have = true;
    }
    if (lid == 0) {
      sums[base + t] = runsum;
      counts[base + t] = cnt;
      mins[base + t] = mn;
      maxs[base + t] = mx;
    }
  }
  if (use_smem) {
    __syncwarp();
    for (int j = lid; j < W; j += 32) grow[j] = row[j];
  }
  if (lid == 0) {
    pos_io[p] = pos;
    cnt_io[p] = cnt;
    runsum_io[p] = runsum;
    comp_io[p] = comp;
  }
}

}  // namespace

// Launch one step on `stream`.  Returns cudaGetLastError() after the launch
// (0 = cudaSuccess); the caller raises on anything else.
extern "C" int wagg_length_step(const float* values, const uint8_t* ok,
                                float* ring, int* pos, int* cnt,
                                float* runsum, float* comp, float* sums,
                                int* counts, float* mins, float* maxs,
                                int P, int T, int W, int want_minmax,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || T <= 0) return 0;
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!want_minmax) {
    const int blocks = (P + kSumThreads - 1) / kSumThreads;
    wagg_sum_kernel<<<blocks, kSumThreads, 0, s>>>(
        values, ok, ring, pos, cnt, runsum, comp, sums, counts, P, T, W);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t row_bytes = static_cast<size_t>(W) * sizeof(float);
  const int use_smem = row_bytes <= kSmemBudget ? 1 : 0;
  int warps = kMaxWarps;
  while (use_smem && warps > 1 && warps * row_bytes > kSmemBudget) --warps;
  const size_t smem = use_smem ? warps * row_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wagg_minmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (P + warps - 1) / warps;
  wagg_minmax_kernel<<<blocks, warps * 32, smem, s>>>(
      values, ok, ring, pos, cnt, runsum, comp, sums, counts, mins, maxs, P,
      T, W, use_smem);
  return static_cast<int>(cudaGetLastError());
}
