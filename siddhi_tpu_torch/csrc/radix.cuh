// CTA-wide building blocks of the port's stable sorts and compactions
// (csrc/dwin_step.cu, csrc/iagg_fold.cu, csrc/join_probe.cu).
//
//   cta_digit_rank   a stable rank of each thread's digit among the CTA's
//                    threads of that digit (one radix pass's local step);
//   cta_exclusive_scan
//                    one CTA's in-place exclusive scan of an int array of
//                    any length, a carry across chunks of kThreads.
//
// Both must be reached by every thread of the CTA (they synchronise it).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace radix {

constexpr unsigned kFullMask = 0xffffffffu;

// The CTA's stable rank of each thread's digit d (d < bins <= kMaxBins;
// d == bins: no item) among the CTA's threads of that digit, in thread
// order; the CTA's count of each digit into cnt[bins] (shared memory).
template <int kThreads, int kMaxBins>
__device__ int cta_digit_rank(int d, int bins, int* cnt) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int wc[kWarps][kMaxBins];
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  for (int i = tid; i < kWarps * kMaxBins; i += kThreads)
    wc[i / kMaxBins][i % kMaxBins] = 0;
  __syncthreads();
  const unsigned m = __match_any_sync(kFullMask, d);
  const int lr = __popc(m & ((1u << lid) - 1u));
  if (lr == 0 && d < bins) wc[wid][d] = __popc(m);
  __syncthreads();
  int before = 0;
  if (d < bins)
    for (int w = 0; w < wid; ++w) before += wc[w][d];
  if (tid < bins) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += wc[w][tid];
    cnt[tid] = t;
  }
  __syncthreads();
  return before + lr;
}

// c[0..n) becomes its exclusive prefix sums, in place; every thread gets
// the total.  One CTA of kThreads threads.
template <int kThreads>
__device__ int cta_exclusive_scan(int* c, int n) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int ws[kWarps];
  __shared__ int carry_in;
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  if (tid == 0) carry_in = 0;
  __syncthreads();
  for (int b0 = 0; b0 < n; b0 += kThreads) {
    const int b = b0 + tid;
    const int v = b < n ? c[b] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullMask, inc, o);
      if (lid >= o) inc += u;
    }
    if (lid == 31) ws[wid] = inc;
    __syncthreads();
    int pre = 0, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < wid) pre += ws[w];
      tot += ws[w];
    }
    if (b < n) c[b] = carry_in + pre + inc - v;
    __syncthreads();
    if (tid == 0) carry_in += tot;
    __syncthreads();
  }
  return carry_in;
}

}  // namespace radix
