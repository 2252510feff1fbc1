// CTA-wide building blocks of the port's stable sorts and compactions
// (csrc/dwin_step.cu, csrc/iagg_fold.cu, csrc/join_probe.cu).
//
//   cta_digit_rank   a stable rank of each thread's digit among the CTA's
//                    threads of that digit (one radix pass's local step);
//   cta_exclusive_scan
//                    one CTA's in-place exclusive scan of an int array of
//                    any length, a carry across chunks of kThreads;
//   lookback         a tile's exclusive prefix across the CTAs of one
//                    launch by decoupled look-back (Merrill and Garland,
//                    2016), one thread a value (warp_lookback: one warp);
//   warp_striped_rank
//                    the stable rank of a warp's items among its items of
//                    the same digit, items k * 32 + lane in order.
//
// The first two must be reached by every thread of the CTA (they
// synchronise it); warp_striped_rank by every lane of the warp.

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

// Decoupled look-back over status words, one a tile (status[k * stride]
// for tile k; zero before the launch): the top two bits say what the
// word holds, the rest its value (below 2^(bits - 2)).  Tile `tile`
// publishes its aggregate `agg`, adds the tiles before it walking back
// until one holds an inclusive prefix, publishes its own inclusive
// prefix and returns its exclusive one.  It spins only on tiles before
// its own, so tiles must be handed out in the order CTAs start (an
// atomic counter, not blockIdx): a CTA then never waits on one that is
// not resident.  A word is written whole, so its flag and value are
// seen together.
template <typename Word>
__device__ Word lookback(Word* status, size_t stride, int tile, Word agg) {
  constexpr Word kAggregate = Word(1) << (sizeof(Word) * 8 - 2);
  constexpr Word kPrefix = Word(2) << (sizeof(Word) * 8 - 2);
  constexpr Word kValue = kAggregate - 1;
  volatile Word* st = status;
  if (tile == 0) {
    st[0] = agg | kPrefix;
    return 0;
  }
  st[static_cast<size_t>(tile) * stride] = agg | kAggregate;
  Word excl = 0;
  // a window of kLook words read at once (independent loads in flight),
  // taken nearest first; an unpublished word restarts the window there
  constexpr int kLook = 8;
  for (int k = tile - 1; k >= 0;) {
    Word w[kLook];
#pragma unroll
    for (int j = 0; j < kLook; ++j)
      w[j] = k - j >= 0 ? st[static_cast<size_t>(k - j) * stride] : kPrefix;
    bool done = false;
#pragma unroll
    for (int j = 0; j < kLook; ++j) {
      if (done) break;
      if (w[j] == 0) {                   // not yet published
        k -= j;
        done = true;
        __nanosleep(100);
        break;
      }
      excl += w[j] & kValue;
      if (w[j] & kPrefix) {
        k = -1;
        done = true;
      }
    }
    if (!done) k -= kLook;
  }
  st[static_cast<size_t>(tile) * stride] = (excl + agg) | kPrefix;
  return excl;
}

// lookback by one warp (every lane calls it): the lanes read 32 words
// at once, nearest first in lane order, and add the values up to the
// nearest inclusive prefix; a window with an unpublished word before that
// prefix is read again.  Returns the exclusive prefix on every lane.
template <typename Word>
__device__ Word warp_lookback(Word* status, int tile, Word agg) {
  constexpr Word kAggregate = Word(1) << (sizeof(Word) * 8 - 2);
  constexpr Word kPrefix = Word(2) << (sizeof(Word) * 8 - 2);
  constexpr Word kValue = kAggregate - 1;
  volatile Word* st = status;
  const int lid = threadIdx.x & 31;
  if (tile == 0) {
    if (lid == 0) st[0] = agg | kPrefix;
    return 0;
  }
  if (lid == 0) st[tile] = agg | kAggregate;
  Word excl = 0;
  for (int k = tile - 1;;) {
    const int i = k - lid;
    const Word w = i >= 0 ? st[i] : kPrefix;
    const unsigned pre = __ballot_sync(kFullMask, (w & kPrefix) != 0);
    const unsigned none = __ballot_sync(kFullMask, w == 0);
    const int first = pre ? __ffs(static_cast<int>(pre)) - 1 : 31;
    const unsigned upto = first == 31 ? kFullMask : (2u << first) - 1u;
    if (none & upto) {                   // not yet published: read again
      __nanosleep(100);
      continue;
    }
    Word v = lid <= first ? (w & kValue) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    excl += v;
    if (pre) break;
    k -= 32;
  }
  if (lid == 0) st[tile] = (excl + agg) | kPrefix;
  return excl;
}

// The value of a status word once it holds an inclusive prefix (spins
// until then).
template <typename Word>
__device__ Word wait_prefix(Word* status) {
  constexpr Word kPrefix = Word(2) << (sizeof(Word) * 8 - 2);
  constexpr Word kValue = (Word(1) << (sizeof(Word) * 8 - 2)) - 1;
  volatile Word* st = status;
  Word w;
  do {
    w = *st;
  } while (!(w & kPrefix));
  return w & kValue;
}

// A warp's items are warp-striped: item k of lane l is the warp's item
// k * 32 + l, and the items are ranked in that order.  For item k of this
// lane (digit d < kBins; d == kBins: no item), the number of the warp's
// earlier items of digit d: `run` (shared memory, kBins counters, zero
// before the first item) counts the warp's items a digit so far.  Call
// for k = 0, 1, ... in turn, every lane each time.
template <int kBins>
__device__ int warp_striped_rank(int d, int* run) {
  const int lid = threadIdx.x & 31;
  const unsigned m = __match_any_sync(kFullMask, d);
  const int before = d < kBins ? run[d] : 0;
  const int r = before + __popc(m & ((1u << lid) - 1u));
  __syncwarp();
  if (d < kBins && (m & ((1u << lid) - 1u)) == 0u) run[d] = before + __popc(m);
  __syncwarp();
  return r;
}

}  // namespace radix
