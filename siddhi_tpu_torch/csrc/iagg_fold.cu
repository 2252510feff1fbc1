// Incremental-aggregation batch fold (K10) for NVIDIA Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/incremental_agg.py:64 build_slab_update (an XLA
// program: one segment_sum / segment_min / segment_max a base column into
// the duration's bucket slab, TwoSum error lanes in compensated mode).
// Contract: siddhi_tpu_torch/ops/incremental_agg.py slab_update_plain, bit
// for bit (a NaN sum compared by position: the card's arithmetic writes
// its canonical NaN).  The slab is updated in place.
//
// Why not atomics: a float sum depends on the order of its additions.  The
// JAX package's segment_sum on the CPU, and the twin's index_add_, add a
// slot's rows one at a time in batch order, from 0.0.  So the kernel
// orders each slot's rows by batch position and one thread folds them:
//   1. a stable LSD radix sort of the rows by slot (a masked row, seg < 0
//      or >= S, has the key S and sorts last): per 4-bit digit one pass of
//      three launches (per-CTA digit counts; one CTA a digit scans its
//      counts; a stable scatter, in-CTA ranks by __match_any_sync), the
//      keys and the row indices moved together, ceil(bits(S) / 4) passes;
//   2. walk: the first position of each run of equal keys starts a thread;
//      it finds the run's end (a galloping search over the sorted keys),
//      then for each base column folds the run's rows in order from the
//      reduction's identity, loading kUnroll rows ahead of the chain (a
//      run of kLongRun rows or more goes on a list instead, and a warp of
//      iagg_walk_long folds it: the lanes load chunks of kDepth x 32 rows,
//      two chunks ahead, and each lane folds a chunk in order from
//      shuffles):
//        sum   acc = acc + v           (from 0.0f)
//        sumsq acc = acc + (v * v)     (the product rounded first)
//        min   IEEE minimum            (from +inf; NaN propagates as the
//        max   IEEE maximum             canonical 0x7fc00000, -0.0 < +0.0)
//        last  the run's last row (its largest batch index)
//        count the run's length into the int32 lane, wrapping
//      and combines the partial with the slab row: cur + acc, or TwoSum
//      (s, err) with s to vals and comp + err to comp; it flags the slot;
//   3. settle: the twin (and the JAX program) combine every slot, an
//      untouched one with a partial of 0.0f.  That changes a sum column's
//      bits only where cur is -0.0 (to +0.0) or, in compensated mode, not
//      finite (comp becomes NaN) or comp is -0.0: one thread a slot
//      applies it to the unflagged slots' sum columns, writing only the
//      words whose value changes (a NaN stays as it is).
// --fmad=false keeps every product and sum rounded as the twin's are.
//
// The design's floor is the longest chain: one slot holding the whole
// batch (an ungrouped aggregation's coarsest bucket) is one warp's walk
// over n rows a column, 32 dependent folds a chunk.  chip_smoke phase 22
// times it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "radix.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kB = 256;                 // threads a CTA
constexpr int kScanThreads = 1024;
constexpr int kDigitBits = 4;
constexpr int kBins = 1 << kDigitBits;
constexpr int kMaxBases = 32;           // ops/incremental_agg.MAX_BASES
constexpr int kUnroll = 8;              // rows a thread loads ahead
constexpr int kLongRun = 64;            // runs at least this long: a warp
constexpr int kDepth = 8;               // 32-row parts of a warp's chunk
constexpr unsigned kCanonicalNan = 0x7fc00000u;

// base functions (ops/incremental_agg.FN_CODES)
enum Fn { F_SUM = 0, F_SUMSQ = 1, F_MIN = 2, F_MAX = 3, F_COUNT = 4,
          F_LAST = 5 };

struct Fold {
  int n, S, B;
  int folds;             // a sum, sumsq, min or max column exists
  int fn[kMaxBases];
};

struct Sort {
  int n, S, nb, shift;
  const int* seg;        // the first pass reads keys from seg, items i
  const int* in_key;     // later passes: the previous pass's output
  const int* in_item;
  int* out_key;
  int* out_item;
  int* rcnt;             // [kBins][nb] digit counts, then offsets
  int* rtot;             // [kBins] digit totals
};

__device__ __forceinline__ void item_at(const Sort& a, int i, int* key,
                                        int* item) {
  if (a.in_key == nullptr) {
    const int s = a.seg[i];
    *key = (s >= 0 && s < a.S) ? s : a.S;
    *item = i;
  } else {
    *key = a.in_key[i];
    *item = a.in_item[i];
  }
}

__global__ void __launch_bounds__(kB) iagg_radix_count(Sort a) {
  __shared__ int cnt[kBins];
  const int i = blockIdx.x * kB + threadIdx.x;
  int d = kBins;
  if (i < a.n) {
    int key, item;
    item_at(a, i, &key, &item);
    d = (key >> a.shift) & (kBins - 1);
  }
  radix::cta_digit_rank<kB, kBins>(d, kBins, cnt);
  if (threadIdx.x < kBins)
    a.rcnt[threadIdx.x * a.nb + blockIdx.x] = cnt[threadIdx.x];
}

// one CTA a digit: its per-CTA counts to exclusive offsets, its total
__global__ void __launch_bounds__(kScanThreads) iagg_radix_scan(Sort a) {
  int* c = a.rcnt + static_cast<size_t>(blockIdx.x) * a.nb;
  const int tot = radix::cta_exclusive_scan<kScanThreads>(c, a.nb);
  if (threadIdx.x == 0) a.rtot[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kB) iagg_radix_scatter(Sort a) {
  __shared__ int cnt[kBins];
  const int i = blockIdx.x * kB + threadIdx.x;
  int d = kBins, key = 0, item = 0;
  if (i < a.n) {
    item_at(a, i, &key, &item);
    d = (key >> a.shift) & (kBins - 1);
  }
  const int r = radix::cta_digit_rank<kB, kBins>(d, kBins, cnt);
  if (i < a.n) {
    int base = a.rcnt[d * a.nb + blockIdx.x];
    for (int e = 0; e < d; ++e) base += a.rtot[e];
    a.out_key[base + r] = key;
    a.out_item[base + r] = item;
  }
}

__device__ __forceinline__ float canonical_nan() {
  return __uint_as_float(kCanonicalNan);
}

// jnp.minimum / jnp.maximum on the CPU: NaN propagates, -0.0 < +0.0
__device__ __forceinline__ float ieee_min(float a, float b) {
  if (a != a || b != b) return canonical_nan();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ float ieee_max(float a, float b) {
  if (a != a || b != b) return canonical_nan();
  if (a > b) return a;
  if (b > a) return b;
  return signbit(b) ? a : b;
}

template <int FN>
__device__ __forceinline__ float fold_op(float acc, float v) {
  if (FN == F_SUM) return __fadd_rn(acc, v);
  if (FN == F_SUMSQ) return __fadd_rn(acc, __fmul_rn(v, v));
  if (FN == F_MIN) return ieee_min(acc, v);
  return ieee_max(acc, v);
}

__device__ __forceinline__ float fold_one(int fn, float acc, float v) {
  switch (fn) {
    case F_SUM: return fold_op<F_SUM>(acc, v);
    case F_SUMSQ: return fold_op<F_SUMSQ>(acc, v);
    case F_MIN: return fold_op<F_MIN>(acc, v);
    default: return fold_op<F_MAX>(acc, v);
  }
}

__device__ __forceinline__ void two_sum(float a, float b, float* s,
                                        float* err) {
  *s = __fadd_rn(a, b);
  const float bb = __fsub_rn(*s, a);
  *err = __fadd_rn(__fsub_rn(a, __fsub_rn(*s, bb)), __fsub_rn(b, bb));
}

// store x at p unless it holds x already (or both are NaN)
__device__ __forceinline__ void settle_store(float* p, float x) {
  const float old = *p;
  if (__float_as_uint(old) == __float_as_uint(x) || (old != old && x != x))
    return;
  *p = x;
}

// The partial acc of a column folded into its slab cell (and comp).
__device__ __forceinline__ void combine(int fn, float acc, float* cell,
                                        float* c) {
  const float cur = *cell;
  if (fn == F_MIN) {
    *cell = ieee_min(cur, acc);
  } else if (fn == F_MAX) {
    *cell = ieee_max(cur, acc);
  } else if (c == nullptr) {
    *cell = __fadd_rn(cur, acc);
  } else {
    // TwoSum(cur, acc): s + err == cur + acc exactly
    float s, err;
    two_sum(cur, acc, &s, &err);
    *cell = s;
    *c = __fadd_rn(*c, err);
  }
}

__device__ __forceinline__ float identity_of(int fn) {
  return fn == F_MIN ? __int_as_float(0x7f800000)
       : fn == F_MAX ? __int_as_float(0xff800000) : 0.0f;
}

// One thread a run of equal keys in the sorted order (skey, srow).
__global__ void __launch_bounds__(kB)
iagg_walk(Fold f, const float* __restrict__ bv, const int* __restrict__ skey,
          const int* __restrict__ srow, float* vals, float* comp, int* cnt,
          unsigned char* touched, int* runs, int* nruns) {
  const int i = blockIdx.x * kB + threadIdx.x;
  if (i >= f.n) return;
  const int k = skey[i];
  if (k >= f.S || (i > 0 && skey[i - 1] == k)) return;
  // the run's end e: gallop to a bound, then bisect (keys ascend)
  int lo = i, step = 1;                  // skey[lo] == k
  int hi = i + 1;
  while (hi < f.n && skey[hi] == k) {
    lo = hi;
    step <<= 1;
    hi = i + step;
  }
  if (hi > f.n) hi = f.n;                // skey[hi] != k or hi == n
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    if (skey[mid] == k) lo = mid; else hi = mid;
  }
  const int e = hi;
  touched[k] = 1;
  cnt[k] = static_cast<int>(static_cast<unsigned>(cnt[k]) +
                            static_cast<unsigned>(e - i));
  const size_t B = static_cast<size_t>(f.B);
  const bool warp_walk = e - i >= kLongRun && f.folds;
  if (warp_walk) {                       // iagg_walk_long folds its columns
    const int r = atomicAdd(nruns, 1);
    runs[3 * r] = i;
    runs[3 * r + 1] = e;
    runs[3 * r + 2] = k;
  }
  for (int b = 0; b < f.B; ++b) {
    const int fn = f.fn[b];
    float* cell = vals + static_cast<size_t>(k) * B + b;
    if (fn == F_COUNT) continue;
    if (fn == F_LAST) {
      *cell = bv[static_cast<size_t>(srow[e - 1]) * B + b];
      continue;
    }
    if (warp_walk) continue;
    float acc = identity_of(fn);
    for (int j = i; j < e; j += kUnroll) {
      int rr[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) rr[u] = j + u < e ? srow[j + u] : -1;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = rr[u] >= 0 ? bv[static_cast<size_t>(rr[u]) * B + b] : 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (rr[u] >= 0) acc = fold_one(fn, acc, v[u]);
    }
    combine(fn, acc, cell,
            comp ? comp + static_cast<size_t>(k) * B + b : nullptr);
  }
}

// One column of a long run [i, e) folded by a warp, software-pipelined:
// while the lanes fold chunk c (kDepth x 32 rows, every lane the same
// chain from shuffles, in row order), the values of chunk c + 1 and the
// row indices of chunk c + 2 are in flight.
template <int FN>
__device__ float warp_fold(const float* __restrict__ bv,
                           const int* __restrict__ srow, int i, int e,
                           size_t B, int b, int lane) {
  constexpr int kChunk = 32 * kDepth;
  float acc = identity_of(FN);
  int r[kDepth], rn[kDepth];
  float v[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int j = i + 32 * d + lane;
    r[d] = j < e ? srow[j] : -1;
    const int jn = j + kChunk;
    rn[d] = jn < e ? srow[jn] : -1;
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    v[d] = r[d] >= 0 ? bv[static_cast<size_t>(r[d]) * B + b] : 0.0f;
  for (int j0 = i; j0 < e; j0 += kChunk) {
    float vn[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      vn[d] = rn[d] >= 0 ? bv[static_cast<size_t>(rn[d]) * B + b] : 0.0f;
      const int jnn = j0 + 2 * kChunk + 32 * d + lane;
      rn[d] = jnn < e ? srow[jnn] : -1;
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int m = e - (j0 + 32 * d);   // rows left from this part
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float x = __shfl_sync(kFull, v[d], t);
        if (t < m) acc = fold_op<FN>(acc, x);
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) v[d] = vn[d];
  }
  return acc;
}

// A warp a long run (iagg_walk's list); lane 0 combines each column.
__global__ void __launch_bounds__(kB)
iagg_walk_long(Fold f, const float* __restrict__ bv,
               const int* __restrict__ srow, float* vals, float* comp,
               const int* __restrict__ runs, const int* __restrict__ nruns) {
  const int w = (blockIdx.x * kB + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= *nruns) return;               // the same for the whole warp
  const int i = runs[3 * w], e = runs[3 * w + 1], k = runs[3 * w + 2];
  const size_t B = static_cast<size_t>(f.B);
  for (int b = 0; b < f.B; ++b) {
    const int fn = f.fn[b];
    float acc;
    switch (fn) {
      case F_SUM: acc = warp_fold<F_SUM>(bv, srow, i, e, B, b, lane); break;
      case F_SUMSQ:
        acc = warp_fold<F_SUMSQ>(bv, srow, i, e, B, b, lane);
        break;
      case F_MIN: acc = warp_fold<F_MIN>(bv, srow, i, e, B, b, lane); break;
      case F_MAX: acc = warp_fold<F_MAX>(bv, srow, i, e, B, b, lane); break;
      default: continue;                 // count and last: iagg_walk
    }
    if (lane == 0)
      combine(fn, acc, vals + static_cast<size_t>(k) * B + b,
              comp ? comp + static_cast<size_t>(k) * B + b : nullptr);
  }
}

// The untouched slots' sum columns: cur + 0.0f (TwoSum in compensated
// mode), as the twin combines them.
__global__ void __launch_bounds__(kB)
iagg_settle(Fold f, float* vals, float* comp,
            const unsigned char* __restrict__ touched) {
  const int k = blockIdx.x * kB + threadIdx.x;
  if (k >= f.S || touched[k]) return;
  const size_t B = static_cast<size_t>(f.B);
  for (int b = 0; b < f.B; ++b) {
    if (f.fn[b] != F_SUM && f.fn[b] != F_SUMSQ) continue;
    float* cell = vals + static_cast<size_t>(k) * B + b;
    const float cur = *cell;
    if (comp == nullptr) {
      settle_store(cell, __fadd_rn(cur, 0.0f));
    } else {
      float s, err;
      two_sum(cur, 0.0f, &s, &err);
      settle_store(cell, s);
      float* c = comp + static_cast<size_t>(k) * B + b;
      settle_store(c, __fadd_rn(*c, err));
    }
  }
}

int key_bits(int S) {
  int bits = 0;
  while ((S >> bits) != 0) ++bits;       // keys lie in [0, S]
  return bits;
}

// long runs a fold of n rows can have
int max_runs(int n) { return n / kLongRun + 1; }

size_t scratch_layout(int n, int S, int* nb_out, int* npass_out) {
  const int nb = (n + kB - 1) / kB;
  if (nb_out) *nb_out = nb;
  if (npass_out) *npass_out = (key_bits(S) + kDigitBits - 1) / kDigitBits;
  return sizeof(int) * (4 * static_cast<size_t>(n) +
                        static_cast<size_t>(kBins) * nb + kBins +
                        1 + 3 * static_cast<size_t>(max_runs(n))) +
         static_cast<size_t>(S);       // the walk's touched flags
}

}  // namespace

extern "C" {

// bytes of device scratch a fold of n rows into S slots needs
long long iagg_scratch_bytes(int n, int S) {
  return static_cast<long long>(scratch_layout(n, S, nullptr, nullptr));
}

// base_vals [n, B] f32, seg [n] i32, vals [S, B] f32 (in place), comp
// [S, B] f32 or null (in place), cnt [S] i32 (in place), fns [B] host
// ints (Fn codes).  0 or a CUDA error code.
int iagg_fold(const float* base_vals, const int* seg, float* vals,
              float* comp, int* cnt, const int* fns, int n, int S, int B,
              void* scratch, long long scratch_bytes, void* stream) {
  if (n <= 0) return 0;
  if (S <= 0 || B <= 0 || B > kMaxBases) return cudaErrorInvalidValue;
  int nb = 0, npass = 0;
  const size_t need = scratch_layout(n, S, &nb, &npass);
  if (scratch_bytes < static_cast<long long>(need))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(scratch);
  int* key[2] = {w, w + n};
  int* item[2] = {w + 2 * static_cast<size_t>(n),
                  w + 3 * static_cast<size_t>(n)};
  Sort a;
  a.n = n;
  a.S = S;
  a.nb = nb;
  a.seg = seg;
  a.rcnt = w + 4 * static_cast<size_t>(n);
  a.rtot = a.rcnt + static_cast<size_t>(kBins) * nb;
  const int* skey = nullptr;
  const int* srow = nullptr;
  for (int p = 0; p < npass; ++p) {
    a.shift = p * kDigitBits;
    a.in_key = p == 0 ? nullptr : key[(p - 1) & 1];
    a.in_item = p == 0 ? nullptr : item[(p - 1) & 1];
    a.out_key = key[p & 1];
    a.out_item = item[p & 1];
    iagg_radix_count<<<nb, kB, 0, st>>>(a);
    iagg_radix_scan<<<kBins, kScanThreads, 0, st>>>(a);
    iagg_radix_scatter<<<nb, kB, 0, st>>>(a);
    skey = a.out_key;
    srow = a.out_item;
  }
  Fold f;
  f.n = n;
  f.S = S;
  f.B = B;
  f.folds = 0;
  bool any_sum = false;
  for (int b = 0; b < kMaxBases; ++b) {
    f.fn[b] = b < B ? fns[b] : F_COUNT;
    any_sum |= f.fn[b] == F_SUM || f.fn[b] == F_SUMSQ;
    f.folds |= f.fn[b] != F_COUNT && f.fn[b] != F_LAST;
  }
  int* nruns = a.rtot + kBins;
  int* runs = nruns + 1;
  unsigned char* touched =
      reinterpret_cast<unsigned char*>(runs + 3 * static_cast<size_t>(
          max_runs(n)));
  cudaMemsetAsync(nruns, 0, sizeof(int), st);
  cudaMemsetAsync(touched, 0, static_cast<size_t>(S), st);
  iagg_walk<<<nb, kB, 0, st>>>(f, base_vals, skey, srow, vals, comp, cnt,
                               touched, runs, nruns);
  if (f.folds) {
    const int warps = max_runs(n);
    iagg_walk_long<<<(warps * 32 + kB - 1) / kB, kB, 0, st>>>(
        f, base_vals, srow, vals, comp, runs, nruns);
  }
  if (any_sum)
    iagg_settle<<<(S + kB - 1) / kB, kB, 0, st>>>(f, vals, comp, touched);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
