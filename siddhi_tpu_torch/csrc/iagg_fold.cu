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
// orders each slot's rows by batch position and one thread folds them.
// A fold is a memset and 3 + ceil(bits(S) / 8) kernels: seven device
// operations at S = 2^20.
//   1. prep (after a memset of the digit counts): one read of seg counts
//      every 8-bit digit of every pass's key (a masked row, seg < 0 or
//      >= S, has the key S and sorts last), a CTA a tile of kTile rows,
//      warp-aggregated in shared memory, then added to the counts; it
//      also zeroes the passes' look-back words, their tile counters and
//      the long-run counter, and settles every slot's sum columns;
//   2. one launch a pass, ceil(bits(S) / 8) passes (3 at S = 2^20): a
//      stable LSD radix sort of the rows by slot, Onesweep (Adinets and
//      Merrill, 2022): a CTA takes a tile of kTile rows from an atomic
//      counter, ranks them stably (warp-striped items, __match_any_sync
//      ranks in row order, radix.cuh warp_striped_rank), adds the digit's
//      total before it (the prep counts) and the digit's count in the
//      tiles before it (decoupled look-back a digit, radix.cuh lookback),
//      stages the tile in sorted order in shared memory and writes the
//      keys and row indices out, a digit's rows at consecutive positions;
//   3. walk: the first position of each run of equal keys starts a thread;
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
//      (s, err) with s to vals and comp + err to comp.
// The settle: the twin (and the JAX program) combine every slot, an
// untouched one with a partial of 0.0f.  That changes a sum column's bits
// only where cur is -0.0 (to +0.0) or, in compensated mode, not finite
// (comp becomes NaN) or comp is -0.0.  prep applies cur + 0.0f (TwoSum in
// compensated mode) to every slot, writing only the words whose value
// changes (a NaN stays as it is); the walk then combines the touched
// slots.  Settling a touched slot first changes none of its bits: a
// partial folded from +0.0f is never -0.0, so (cur + 0) + acc == cur +
// acc, and TwoSum(cur, 0) adds +0.0 or NaN to comp exactly where
// TwoSum(cur, acc) leaves comp + err as +0.0-signed or NaN.
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
constexpr int kWarps = kB / 32;
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits; // == kB: a thread a digit
constexpr int kItems = 8;               // rows a thread a pass
constexpr int kTile = kB * kItems;      // rows a pass CTA
constexpr int kMaxPasses = 4;
constexpr int kMaxBases = 32;           // ops/incremental_agg.MAX_BASES
constexpr int kUnroll = 8;              // rows a thread loads ahead
constexpr int kLongRun = 64;            // runs at least this long: a warp
constexpr int kDepth = 8;               // 32-row parts of a warp's chunk
constexpr unsigned kCanonicalNan = 0x7fc00000u;

static_assert(kRadix == kB, "a pass's thread owns a digit");

// base functions (ops/incremental_agg.FN_CODES)
enum Fn { F_SUM = 0, F_SUMSQ = 1, F_MIN = 2, F_MAX = 3, F_COUNT = 4,
          F_LAST = 5 };

struct Fold {
  int n, S, B;
  int folds;             // a sum, sumsq, min or max column exists
  int sums;              // a sum or sumsq column exists
  int fn[kMaxBases];
};

struct Sort {
  int n, S, npass, ntiles;
  const int* seg;
  int* key[2];           // pass p writes key[p & 1], item[p & 1]
  int* item[2];
  int* hist;             // [kMaxPasses][kRadix] digit counts (zeroed)
  unsigned* status;      // [npass][ntiles][kRadix] look-back words
  int* counter;          // [npass] tiles handed out
  int* nruns;            // long runs listed by the walk
};

__device__ __forceinline__ int key_of(const Sort& a, int i) {
  const int s = a.seg[i];
  return (s >= 0 && s < a.S) ? s : a.S;
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
          int* runs, int* nruns) {
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

// Settle slot k's sum columns: cur + 0.0f (TwoSum in compensated mode),
// as the twin combines an untouched slot.
__device__ __forceinline__ void settle_slot(const Fold& f, float* vals,
                                            float* comp, int k) {
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

// prep: the passes' digit counts (CTAs below a.ntiles, a tile each,
// warp-aggregated shared atomics, then one global add a digit), the
// look-back words, tile counters and long-run counter zeroed, every slot
// settled.
__global__ void __launch_bounds__(kB)
iagg_prep(Sort a, Fold f, float* vals, float* comp) {
  __shared__ int h[kMaxPasses][kRadix];
  const int tid = threadIdx.x, lid = tid & 31, wid = tid >> 5;
  const int stride = gridDim.x * kB;
  const int gid = blockIdx.x * kB + tid;
  const size_t nstatus = static_cast<size_t>(a.npass) * a.ntiles * kRadix;
  for (size_t k = gid; k < nstatus; k += stride) a.status[k] = 0u;
  if (gid < a.npass) a.counter[gid] = 0;
  if (gid == 0) *a.nruns = 0;
  if (f.sums)
    for (int k = gid; k < f.S; k += stride) settle_slot(f, vals, comp, k);
  const int t = blockIdx.x;
  if (t >= a.ntiles) return;             // the same for the whole CTA
  for (int k = tid; k < kMaxPasses * kRadix; k += kB)
    h[k / kRadix][k % kRadix] = 0;
  __syncthreads();
  const int row0 = t * kTile + wid * (32 * kItems) + lid;
  int key[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = row0 + 32 * k;
    key[k] = i < a.n ? key_of(a, i) : -1;
  }
  for (int p = 0; p < a.npass; ++p) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int d = key[k] < 0 ? kRadix
                               : (key[k] >> (p * kDigitBits)) & (kRadix - 1);
      const unsigned m = __match_any_sync(kFull, d);
      if (d < kRadix && (m & ((1u << lid) - 1u)) == 0u)
        atomicAdd(&h[p][d], __popc(m));
    }
  }
  __syncthreads();
  for (int p = 0; p < a.npass; ++p)
    if (h[p][tid] != 0) atomicAdd(&a.hist[p * kRadix + tid], h[p][tid]);
}

// One radix pass p: a tile of kTile rows, warp-striped (warp w's item k
// of lane l is the tile's row w * 256 + k * 32 + l), ranked stably,
// offset by the digit's start and its look-back, staged in shared memory
// in the tile's sorted order, then written out: a digit's rows of the
// tile land at consecutive positions, so the writes coalesce.
__global__ void __launch_bounds__(kB) iagg_pass(Sort a, int p) {
  __shared__ int run[kWarps][kRadix];    // a warp's count a digit
  __shared__ int start[kRadix];          // the digit's first position
  __shared__ int local[kRadix];          // the digit's first in the tile
  __shared__ int s_key[kTile];
  __shared__ int s_item[kTile];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lid = tid & 31, wid = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(&a.counter[p], 1);
  for (int k = tid; k < kWarps * kRadix; k += kB)
    run[k / kRadix][k % kRadix] = 0;
  start[tid] = a.hist[p * kRadix + tid]; // rows of digit tid, this pass
  __syncthreads();
  radix::cta_exclusive_scan<kB>(start, kRadix);
  const int t = s_tile;
  const int shift = p * kDigitBits;
  const int* in_key = p == 0 ? nullptr : a.key[(p - 1) & 1];
  const int* in_item = p == 0 ? nullptr : a.item[(p - 1) & 1];
  const int row0 = t * kTile + wid * (32 * kItems) + lid;
  int key[kItems], item[kItems], d[kItems], r[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = row0 + 32 * k;
    if (i < a.n) {
      key[k] = in_key ? in_key[i] : key_of(a, i);
      item[k] = in_item ? in_item[i] : i;
      d[k] = (key[k] >> shift) & (kRadix - 1);
    } else {
      d[k] = kRadix;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    r[k] = radix::warp_striped_rank<kRadix>(d[k], run[wid]);
  __syncthreads();
  int c = 0;                             // thread tid: digit tid
  for (int w = 0; w < kWarps; ++w) {
    const int x = run[w][tid];
    run[w][tid] = c;                     // the warps before w, this digit
    c += x;
  }
  local[tid] = c;
  radix::cta_exclusive_scan<kB>(local, kRadix);
  const unsigned excl = radix::lookback<unsigned>(
      a.status + (static_cast<size_t>(p) * a.ntiles) * kRadix + tid, kRadix,
      t, static_cast<unsigned>(c));
  // a tile's row at sorted position j (digit d) goes to start[d] + j
  start[tid] += static_cast<int>(excl) - local[tid];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (d[k] < kRadix) {
      const int j = local[d[k]] + run[wid][d[k]] + r[k];
      s_key[j] = key[k];
      s_item[j] = item[k];
    }
  }
  __syncthreads();
  int* out_key = a.key[p & 1];
  int* out_item = a.item[p & 1];
  const int rows = min(kTile, a.n - t * kTile);
  for (int j = tid; j < rows; j += kB) {
    const int k = s_key[j];
    const int pos = start[(k >> shift) & (kRadix - 1)] + j;
    out_key[pos] = k;
    out_item[pos] = s_item[j];
  }
}

int key_bits(int S) {
  int bits = 0;
  while ((S >> bits) != 0) ++bits;       // keys lie in [0, S]
  return bits;
}

// long runs a fold of n rows can have
int max_runs(int n) { return n / kLongRun + 1; }

struct Layout {
  int npass, ntiles;
  size_t key, item, hist, status, counter, nruns, runs, bytes;  // offsets
};

Layout scratch_layout(int n, int S) {
  Layout l;
  l.npass = (key_bits(S) + kDigitBits - 1) / kDigitBits;
  l.ntiles = (n + kTile - 1) / kTile;
  const size_t N = static_cast<size_t>(n);
  l.key = 0;                             // int words from here on
  l.item = l.key + 2 * N;
  l.hist = l.item + 2 * N;
  l.status = l.hist + static_cast<size_t>(kMaxPasses) * kRadix;
  l.counter = l.status + static_cast<size_t>(l.npass) * l.ntiles * kRadix;
  l.nruns = l.counter + kMaxPasses;
  l.runs = l.nruns + 1;
  l.bytes = sizeof(int) * (l.runs + 3 * static_cast<size_t>(max_runs(n)));
  return l;
}

}  // namespace

extern "C" {

// bytes of device scratch a fold of n rows into S slots needs
long long iagg_scratch_bytes(int n, int S) {
  return n <= 0 || S <= 0
             ? 0
             : static_cast<long long>(scratch_layout(n, S).bytes);
}

// base_vals [n, B] f32, seg [n] i32, vals [S, B] f32 (in place), comp
// [S, B] f32 or null (in place), cnt [S] i32 (in place), fns [B] host
// ints (Fn codes).  0 or a CUDA error code.
int iagg_fold(const float* base_vals, const int* seg, float* vals,
              float* comp, int* cnt, const int* fns, int n, int S, int B,
              void* scratch, long long scratch_bytes, void* stream) {
  if (n <= 0) return 0;
  if (S <= 0 || B <= 0 || B > kMaxBases || n >= (1 << 30))
    return cudaErrorInvalidValue;
  const Layout l = scratch_layout(n, S);
  if (scratch_bytes < static_cast<long long>(l.bytes))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(scratch);
  Sort a;
  a.n = n;
  a.S = S;
  a.npass = l.npass;
  a.ntiles = l.ntiles;
  a.seg = seg;
  a.key[0] = w + l.key;
  a.key[1] = w + l.key + n;
  a.item[0] = w + l.item;
  a.item[1] = w + l.item + n;
  a.hist = w + l.hist;
  a.status = reinterpret_cast<unsigned*>(w + l.status);
  a.counter = w + l.counter;
  a.nruns = w + l.nruns;
  int* runs = w + l.runs;
  Fold f;
  f.n = n;
  f.S = S;
  f.B = B;
  f.folds = 0;
  f.sums = 0;
  for (int b = 0; b < kMaxBases; ++b) {
    f.fn[b] = b < B ? fns[b] : F_COUNT;
    f.sums |= f.fn[b] == F_SUM || f.fn[b] == F_SUMSQ;
    f.folds |= f.fn[b] != F_COUNT && f.fn[b] != F_LAST;
  }
  const int prep_grid =
      max(l.ntiles, min((max(S, l.npass * l.ntiles * kRadix) + kB - 1) / kB,
                        1024));
  cudaMemsetAsync(a.hist, 0, sizeof(int) * kMaxPasses * kRadix, st);
  iagg_prep<<<prep_grid, kB, 0, st>>>(a, f, vals, comp);
  for (int p = 0; p < l.npass; ++p)
    iagg_pass<<<l.ntiles, kB, 0, st>>>(a, p);
  const int* skey = a.key[(l.npass - 1) & 1];
  const int* srow = a.item[(l.npass - 1) & 1];
  const int nb = (n + kB - 1) / kB;
  iagg_walk<<<nb, kB, 0, st>>>(f, base_vals, skey, srow, vals, comp, cnt,
                               runs, a.nruns);
  if (f.folds) {
    const int warps = max_runs(n);
    iagg_walk_long<<<(warps * 32 + kB - 1) / kB, kB, 0, st>>>(
        f, base_vals, srow, vals, comp, runs, a.nruns);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
