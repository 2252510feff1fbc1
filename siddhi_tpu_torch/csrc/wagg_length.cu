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
// Every carry the step or the JAX package produces has pos == cnt while
// cnt < W (the ring fills from slot 0); the min/max path relies on it.
//
// Arithmetic: the Kahan lines are the reference's, in the same order, in
// float32; built without --use_fast_math and with --fmad=false (see
// ops/_kernels.py), so the results equal the plain PyTorch version exactly.
// The evicted value is read from its slot, as the Pallas kernel does (the
// jnp twin's sum(ring * onehot) would turn NaN next to a live +-inf slot).
//
// What bounds it on this card.  The function moves P*T*(4+1+4+4) bytes for
// values, ok, sums and counts, plus, per lane, the min(a, W) ring slots that
// change (the evicted value read, the new one written) on the sum path; with
// min/max also P*T*8 for mins/maxs and P*W*4 for the whole ring read once
// (only the changed slots are written).  Its operations are a few per
// accepted event: the Kahan update and O(1) amortized compares for each of
// min and max.  At the main path's shape (P = 1024, W = 1000, T ~ 300, 75%
// accepted) that is ~12 MB against a few million operations: bound by
// bytes, ~3.5 us on HBM3 (chip_smoke.py phase 2 computes it per run).  What
// stands in the way is the one thing the function cannot parallelise: each
// lane's running sum is a serial chain of 4 dependent float adds per
// accepted event, which must stay in the reference's order to stay exact.
//
// The design, one CTA of 128 threads per lane (a grid-stride loop over
// lanes; 8 CTAs an SM, so P = 1024 runs in one wave):
//   0. staging: the CTA loads the lane's contiguous values/ok rows
//      (neighbouring threads on neighbouring addresses; rows need no
//      alignment) and the entry-ring slots the block reads, in batches of
//      loads issued together, into shared memory: with min/max the live
//      ring in logical order, else only the slots accepted events evict;
//   1. compaction: one block scan of per-thread chunk counts gives k(t),
//      the accepted events up to t, and gathers the a accepted values in
//      order into N[0:a];
//   2. evictions in parallel: the j-th accepted event evicts iff
//      c0 + j >= W, slot (pos0 + j) % W of the entry ring for j < W and
//      the block's own N[j - W] beyond (both are S[c0 + j - W] with
//      min/max); delta[j] = N[j] - old (or - 0.0f);
//   3. the Kahan chain: warp 0's first thread runs the reference's lines
//      over the a deltas only (rejected events cost nothing), from shared
//      memory, while
//   4. the other three warps compute min/max (van Herk / Gil-Werman): S =
//      entry ring in logical order ++ N, cut into blocks of W;
//      block-segmented prefix and suffix extrema by parallel scans (named
//      barrier 1).  The window of event j is S[s..e], e = c0 + j,
//      s = max(0, e - W + 1): its extremum is pre[e] when s starts a
//      block, else ext(suf[s], pre[e]).  O(W + T) work per lane, no rescan;
//      NaN-propagating min/max are associative, so the result is exact;
//   5. fill forward: out[t] = the chain's/scan's value at k(t) - 1, or the
//      entry state when k(t) = 0; stores are coalesced rows;
//   6. write-back: only the last min(a, W) ring slots, pos, cnt, runsum,
//      comp.
// A lane's working set (k, delta, S or N and the evicted slots, the four
// kept scan ranges) lives in shared memory: 4 * (7T + W + 4) bytes with
// min/max (12.8 KB at W = 1000, T = 314), 16T without.  Above the budget
// the same kernel (instantiated for device memory) works from scratch the
// wrapper allocates (wagg_length_scratch_bytes), with a capped grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;               // one CTA per lane
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 8;                 // 1,056 lanes in one wave
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may use
constexpr int kScratchCtas = 4 * 132;       // grid when working from memory

// jnp.min / jnp.max propagate NaN; fminf / fmaxf would drop it.  One
// instruction each (sm_80+); a NaN result is the canonical NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// words (4 bytes) of one lane's working set; see the layout in the kernel
__host__ __device__ __forceinline__ size_t lane_words(int T, int W,
                                                      bool minmax) {
  return minmax ? 7 * static_cast<size_t>(T) + W + 4
                : 4 * static_cast<size_t>(T);
}

// Threads [first, first + n) of the CTA (n a multiple of 32), synchronised
// by named barrier `id` (not 0, which __syncthreads uses).
struct Group {
  int id, n, rank;
};

__device__ __forceinline__ void group_sync(const Group& g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g.id), "r"(g.n) : "memory");
}

// Exclusive sum of one int per thread over the whole CTA; *total gets the
// sum of all.
__device__ int block_exclusive_sum(int v, int* warp_sum, int* total) {
  const int lid = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lid >= off) inc += o;
  }
  if (lid == 31) warp_sum[wid] = inc;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < wid ? warp_sum[w] : 0;
    tot += warp_sum[w];
  }
  __syncthreads();                          // warp_sum may be reused
  *total = tot;
  return before + inc - v;
}

// A run of a block-segmented extremum scan: `head` says the run restarted.
struct Ext {
  int head;
  float mn, mx;
};

__device__ __forceinline__ Ext ext_identity() {
  return Ext{0, INFINITY, -INFINITY};
}

// b follows a
__device__ __forceinline__ Ext ext_combine(Ext a, Ext b) {
  Ext r;
  r.head = a.head | b.head;
  r.mn = b.head ? b.mn : nan_min(a.mn, b.mn);
  r.mx = b.head ? b.mx : nan_max(a.mx, b.mx);
  return r;
}

// Exclusive scan of one Ext per thread of the group, in rank order.
__device__ Ext group_exclusive_scan(Ext v, Ext* warp_tot, const Group& g) {
  const int lid = g.rank & 31;
  const int wid = g.rank >> 5;
  Ext inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Ext o;
    o.head = __shfl_up_sync(kFull, inc.head, off);
    o.mn = __shfl_up_sync(kFull, inc.mn, off);
    o.mx = __shfl_up_sync(kFull, inc.mx, off);
    if (lid >= off) inc = ext_combine(o, inc);
  }
  Ext prev;
  prev.head = __shfl_up_sync(kFull, inc.head, 1);
  prev.mn = __shfl_up_sync(kFull, inc.mn, 1);
  prev.mx = __shfl_up_sync(kFull, inc.mx, 1);
  if (lid == 31) warp_tot[wid] = inc;
  group_sync(g);
  Ext carry = ext_identity();
  for (int w = 0; w < wid; ++w) carry = ext_combine(carry, warp_tot[w]);
  group_sync(g);                            // warp_tot may be reused
  return lid == 0 ? carry : ext_combine(carry, prev);
}

// Prefix (fwd) or suffix (!fwd) min/max of s[lo, hi) inside blocks of W
// (van Herk / Gil-Werman), kept for indices [keep_lo, keep_hi) at
// out_*[i - keep_lo].  fwd needs lo % W == 0; a suffix run also restarts
// at hi - 1.  Each thread scans a contiguous chunk; chunk aggregates are
// combined by one group scan and each chunk is rescanned from its carry.
// Every thread of the group must call it (it holds barriers).
__device__ void block_scan(const float* s, int lo, int hi, int W, bool fwd,
                           int keep_lo, int keep_hi, float* out_mn,
                           float* out_mx, Ext* warp_tot, const Group& g) {
  const int n = hi > lo ? hi - lo : 0;
  const int per = (n + g.n - 1) / g.n;
  const int r0 = min(n, g.rank * per);
  const int r1 = min(n, r0 + per);
  // m = i % W, kept incrementally (one division per chunk, not per element)
  const int m0 = (fwd ? lo + r0 : hi - 1 - r0) % W;
  Ext agg = ext_identity();
  for (int r = r0, m = m0; r < r1; ++r) {
    const int i = fwd ? lo + r : hi - 1 - r;
    const float x = s[i];
    if (fwd ? m == 0 : (m == W - 1 || i == hi - 1)) {
      agg = Ext{1, x, x};
    } else {
      agg.mn = nan_min(agg.mn, x);
      agg.mx = nan_max(agg.mx, x);
    }
    m = fwd ? (m == W - 1 ? 0 : m + 1) : (m == 0 ? W - 1 : m - 1);
  }
  const Ext c = group_exclusive_scan(agg, warp_tot, g);
  float mn = c.mn, mx = c.mx;
  for (int r = r0, m = m0; r < r1; ++r) {
    const int i = fwd ? lo + r : hi - 1 - r;
    const float x = s[i];
    if (fwd ? m == 0 : (m == W - 1 || i == hi - 1)) {
      mn = x;
      mx = x;
    } else {
      mn = nan_min(mn, x);
      mx = nan_max(mx, x);
    }
    m = fwd ? (m == W - 1 ? 0 : m + 1) : (m == 0 ? W - 1 : m - 1);
    if (i >= keep_lo && i < keep_hi) {
      out_mn[i - keep_lo] = mn;
      out_mx[i - keep_lo] = mx;
    }
  }
}

// Loads of up to kBatch iterations of a strided loop are issued before
// any of them is used, so a thread waits on memory once per batch.
constexpr int kBatch = 8;

template <bool kMinMax, bool kSmem>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    wagg_lane_kernel(const float* __restrict__ values,
                     const uint8_t* __restrict__ ok, float* __restrict__ ring,
                     int* __restrict__ pos_io, int* __restrict__ cnt_io,
                     float* __restrict__ runsum_io,
                     float* __restrict__ comp_io, float* __restrict__ sums,
                     int* __restrict__ counts, float* __restrict__ mins,
                     float* __restrict__ maxs, int P, int T, int W,
                     float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem_dyn[];
  __shared__ Ext warp_tot[kWarps];
  __shared__ int warp_sum[kWarps];
  // one lane's working set, in shared memory (kSmem: the compiler then
  // addresses it as such) or in this CTA's slice of scratch:
  //   kk [T] i32   ok(t) staged, then k(t) = accepted events in [0, t]
  //   d  [T]       values staged, then the delta of the j-th accepted
  //                event, then its running sum
  //   s  [W + T]   min/max: entry ring in logical order, then N
  //      [2T]      sum only: N, then the entry-ring value the j-th
  //                accepted event evicts (ev)
  //   pre_mn, pre_mx [T + 1]  prefix extrema of S at [pre_lo, c0 + a)
  //   suf_mn, suf_mx [T + 1]  suffix extrema of S at [0, suf_hi]
  float* base = kSmem ? smem_dyn
                      : scratch + blockIdx.x * lane_words(T, W, kMinMax);
  int* kk = reinterpret_cast<int*>(base);
  float* d = base + T;
  float* s = base + 2 * static_cast<size_t>(T);
  float* ev = s + T;
  float* pre_mn = s + (static_cast<size_t>(W) + T);
  float* pre_mx = pre_mn + (T + 1);
  float* suf_mn = pre_mx + (T + 1);
  float* suf_mx = suf_mn + (T + 1);
  const int tid = threadIdx.x;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t row = static_cast<size_t>(p) * T;
    float* rrow = ring + static_cast<size_t>(p) * W;
    const int pos0 = pos_io[p];
    const int c0 = cnt_io[p];
    const float runsum0 = runsum_io[p];
    const float comp0 = comp_io[p];
    float* nv = kMinMax ? s + c0 : s;      // N, the accepted values

    // 0. stage the lane's rows and the entry-ring slots the block reads,
    //    coalesced, in batches of loads issued together
    for (int t0 = tid; t0 < T; t0 += kBatch * kThreads) {
      float v[kBatch];
      int o[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u * kThreads;
        v[u] = t < T ? values[row + t] : 0.0f;
        o[u] = t < T ? ok[row + t] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u * kThreads;
        if (t < T) {
          d[t] = v[u];
          kk[t] = o[u];
        }
      }
    }
    // min/max: S[0:c0] = the live ring in logical order.  Sum only: the
    // j-th accepted event evicts entry slot (pos0 + j) % W when
    // W - c0 <= j < min(T, W) (with min/max that is S[c0 + j - W]).
    const int start = kMinMax ? (c0 == W ? pos0 : 0) : pos0;
    const int lo = kMinMax ? 0 : max(0, W - c0);
    const int hi = kMinMax ? c0 : min(T, W);
    float* dst = kMinMax ? s : ev;
    for (int i0 = lo + tid; i0 < hi; i0 += kBatch * kThreads) {
      float r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int slot = start + i;
        r[u] = i < hi ? rrow[slot < W ? slot : slot - W] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < hi) dst[i] = r[u];
      }
    }
    __syncthreads();

    // 1. compaction: k(t) and N in order, one block scan of chunk counts
    int a;                                  // accepted events of the block
    {
      const int per = (T + kThreads - 1) / kThreads;
      const int t0 = min(T, tid * per);
      const int t1 = min(T, t0 + per);
      int c = 0;
      for (int t = t0; t < t1; ++t) c += kk[t];
      int k = block_exclusive_sum(c, warp_sum, &a);
      for (int t = t0; t < t1; ++t) {
        if (kk[t]) nv[k++] = d[t];
        kk[t] = k;
      }
    }
    __syncthreads();

    // 2. the delta of every accepted event, in parallel
    for (int j = tid; j < a; j += kThreads) {
      float old = 0.0f;
      if (c0 + j >= W) old = kMinMax ? s[c0 + j - W] : (j < W ? ev[j]
                                                           : nv[j - W]);
      d[j] = nv[j] - old;
    }
    __syncthreads();

    // 3. warp 0: the Kahan chain over the accepted events only, in order;
    // 4. warps 1..: min/max by block-segmented prefix and suffix scans of S.
    //    Prefix extrema are kept from pre_lo: the first event's window end
    //    c0, or c0 - 1 for the entry ring's extremum when it is partly
    //    filled.  A full entry ring is block 0 of S whole: its extremum is
    //    the suffix at 0, and the prefix scan starts at block 1.  Suffix
    //    extrema are kept at [0, suf_hi], the last start of a full window.
    const bool full = c0 == W;
    const int L = c0 + a;
    const int pre_lo = full ? W : (c0 > 0 ? c0 - 1 : 0);
    const int suf_hi = max(L - W, 0);
    const bool want_suf = full || L - W >= 1;
    if (tid < 32) {
      if (tid == 0 && a > 0) {
        float rs = runsum0, cp = comp0;
        int j = 0;
        for (; j + 8 <= a; j += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = d[j + u];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float y = v[u] - cp;
            const float t = rs + y;
            cp = (t - rs) - y;
            rs = t;
            v[u] = rs;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) d[j + u] = v[u];
        }
        for (; j < a; ++j) {
          const float y = d[j] - cp;
          const float t = rs + y;
          cp = (t - rs) - y;
          rs = t;
          d[j] = rs;
        }
        runsum_io[p] = rs;
        comp_io[p] = cp;
        pos_io[p] = (pos0 + a) % W;
        cnt_io[p] = min(c0 + a, W);
      }
    } else if (kMinMax) {
      const Group g{1, kThreads - 32, tid - 32};
      block_scan(s, full ? W : 0, L, W, true, pre_lo, L, pre_mn, pre_mx,
                 warp_tot, g);
      if (want_suf)
        block_scan(s, 0, min(L, (suf_hi / W + 1) * W), W, false, 0,
                   suf_hi + 1, suf_mn, suf_mx, warp_tot, g);
    }
    __syncthreads();

    // 5. fill forward, coalesced rows
    float ent_mn = INFINITY, ent_mx = -INFINITY;
    if (kMinMax && c0 > 0) {                // the extremum of S[0..c0-1]
      ent_mn = full ? suf_mn[0] : pre_mn[0];
      ent_mx = full ? suf_mx[0] : pre_mx[0];
    }
    for (int t = tid; t < T; t += kThreads) {
      const int k = kk[t];
      if (k == 0) {
        sums[row + t] = runsum0;
        counts[row + t] = c0;
        if (kMinMax) {
          mins[row + t] = ent_mn;
          maxs[row + t] = ent_mx;
        }
        continue;
      }
      const int j = k - 1;
      sums[row + t] = d[j];
      counts[row + t] = min(c0 + k, W);
      if (kMinMax) {
        const int e = c0 + j;
        const int s0 = max(0, e - W + 1);
        float mn = pre_mn[e - pre_lo], mx = pre_mx[e - pre_lo];
        if (s0 % W != 0) {
          mn = nan_min(suf_mn[s0], mn);
          mx = nan_max(suf_mx[s0], mx);
        }
        mins[row + t] = mn;
        maxs[row + t] = mx;
      }
    }

    // 6. the ring slots that changed: the last writer of each
    for (int j = max(0, a - W) + tid; j < a; j += kThreads) {
      const int slot = (pos0 + j) % W;
      rrow[slot] = nv[j];
    }
    __syncthreads();                        // the working set is reused
  }
}

struct LaunchPlan {
  size_t lane_bytes;
  bool in_smem;
  int grid;
};

LaunchPlan plan_launch(int P, int T, int W, int want_minmax) {
  LaunchPlan pl;
  pl.lane_bytes = lane_words(T, W, want_minmax != 0) * sizeof(float);
  pl.in_smem = pl.lane_bytes <= kSmemBudget;
  pl.grid = pl.in_smem ? P : (P < kScratchCtas ? P : kScratchCtas);
  return pl;
}

template <bool kMinMax>
int launch(const float* values, const uint8_t* ok, float* ring, int* pos,
           int* cnt, float* runsum, float* comp, float* sums, int* counts,
           float* mins, float* maxs, int P, int T, int W, float* scratch,
           cudaStream_t s) {
  const LaunchPlan pl = plan_launch(P, T, W, kMinMax);
  if (!pl.in_smem) {
    wagg_lane_kernel<kMinMax, false><<<pl.grid, kThreads, 0, s>>>(
        values, ok, ring, pos, cnt, runsum, comp, sums, counts, mins, maxs,
        P, T, W, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  if (pl.lane_bytes > 48 * 1024) {
    static bool raised = false;             // per instantiation
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          wagg_lane_kernel<kMinMax, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemBudget));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  wagg_lane_kernel<kMinMax, true><<<pl.grid, kThreads, pl.lane_bytes, s>>>(
      values, ok, ring, pos, cnt, runsum, comp, sums, counts, mins, maxs, P,
      T, W, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of device scratch one step needs (0 when a lane's working set fits
// in shared memory).  The wrapper allocates them and passes the pointer.
extern "C" long long wagg_length_scratch_bytes(int P, int T, int W,
                                               int want_minmax) {
  if (P <= 0 || T <= 0 || W <= 0) return 0;
  const LaunchPlan pl = plan_launch(P, T, W, want_minmax);
  return pl.in_smem ? 0
                    : static_cast<long long>(pl.lane_bytes) * pl.grid;
}

// Launch one step on `stream`.  Returns cudaGetLastError() after the launch
// (0 = cudaSuccess); the caller raises on anything else.  `scratch` holds
// wagg_length_scratch_bytes(P, T, W, want_minmax) bytes, or is null when
// that is 0.
extern "C" int wagg_length_step(const float* values, const uint8_t* ok,
                                float* ring, int* pos, int* cnt,
                                float* runsum, float* comp, float* sums,
                                int* counts, float* mins, float* maxs,
                                int P, int T, int W, int want_minmax,
                                void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || T <= 0) return 0;
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* scr = static_cast<float*>(scratch);
  if (scr == nullptr && wagg_length_scratch_bytes(P, T, W, want_minmax) > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (want_minmax)
    return launch<true>(values, ok, ring, pos, cnt, runsum, comp, sums,
                        counts, mins, maxs, P, T, W, scr, s);
  return launch<false>(values, ok, ring, pos, cnt, runsum, comp, sums, counts,
                       nullptr, nullptr, P, T, W, scr, s);
}
