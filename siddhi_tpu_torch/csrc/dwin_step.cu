// Device window step (K9) for NVIDIA Hopper (sm_90a): all twelve kinds.
//
// Replaces siddhi_tpu/ops/dwin.py:177 build_dwin_step (an XLA program: per
// kind a closed form over the pool [carry ring ‖ chunk], a stable argsort
// that left-aligns the surviving entries, and jnp.nonzero(size=cap) that
// packs the egress).  Contract: siddhi_tpu_torch/ops/dwin.py
// dwin_step_plain at P = 1 (the compiler's shape), bit for bit: the egress
// rows up to the count, the tail row, the telemetry row and every carry
// leaf.  The kernel moves bits and does no float arithmetic (float lanes
// are only compared, by the sort kind).
//
// The reshaping.  Live entries' arrival ranks rise with the pool index
// (carry slot j has rank j < fill, chunk slot j has rank fill + j - C), so
// _new_ring's stable argsort is a stable partition of the pool — kept
// entries in index order, then the rest in index order, cut at C — and
// _pack_egress is a compaction of the emit mask in flat order ([pool ‖ exp
// plane] for the batch kinds and hopping).  Every position comes from one
// exclusive scan.  Four launches on one stream for ten kinds:
//   0. prep (one CTA): nv = #valid chunk rows (the twin's `live` reads it),
//      externalTimeBatch's last flushed batch id, the accumulators reset;
//   1. decide (one thread an entry): keep / emit / exp-keep, evict_t and
//      cause by the kind's closed form; in-CTA exclusive ranks and per-CTA
//      counts.  externalTime and timeLength run JAX's own searchsorted
//      (method='scan': ceil(log2(T+1)) halvings, mid = (low+high)/2,
//      go_left = q <= a[mid]), which decides an out-of-order attribute;
//   2. scan (one CTA): exclusive offsets of the per-CTA counts;
//   3. scatter: the new ring (and exp plane) by partition position, the
//      egress rows by emit position; the last CTA to finish writes fill,
//      exp_fill, the telemetry leaf and rows, and the tail.  The tail's
//      min live ts (sliding kinds: the kept entries' ts; session: their
//      key's last activity in the new ring) is an atomicMin across CTAs.
//
// Sort and session first sort the L = fill + nv live entries, by rank (0
// .. L-1 is pool order), with a stable LSD radix sort written here: per
// 4-bit digit one pass of three launches (per-CTA digit counts; one CTA a
// digit scans its counts; a stable scatter, in-CTA ranks by
// __match_any_sync), 8 passes a 32-bit key word, the last key first.
//   sort: each key maps to an order key (float: -0.0 as +0.0, NaN last in
//     the key's direction; desc: complemented).  The twin's lex compare
//     stops at the first key where == fails and answers < there (false on
//     a NaN), ties by rank, so x's lex-predecessors are a prefix of the
//     sorted order: the entries before x, or, when x's first NaN is at key
//     k, the entries before the run sharing x's first k keys (a binary
//     search).  tN(x), the n-th smallest arrival among them, is the n-th
//     smallest rank in that prefix (arrival rises with rank): a wavelet
//     matrix over the sorted ranks, ceil(log2 M) levels of one stable
//     1-bit partition each (the same three launches, which also write the
//     level's zero counts), then a descent of ceil(log2 M) rank lookups an
//     entry in decide.
//   session: the runs of equal keys in that order (a binary search for a
//     run's start); a warp-segmented max, one atomicMax a run a warp, gives
//     each key's last activity over the carried live entries (decide), and
//     after the scan its max and count over the new ring's entries (the
//     tail's minimum; the twin's NEG floor unless the C slots are all that
//     key's).  An int32 max and count do not depend on order.
// No pass is quadratic in the pool M = C + T: the sort is O(M * 8 * keys),
// the wavelet and the searches O(M log M).
//
// What bounds it on this card: bytes.  The carry in and out (C entries of
// 4(F+I)+4 bytes each way, twice for the batch kinds), the chunk (T rows),
// the emitted rows; the scratch adds ~21 B an entry (sort and session: the
// radix and wavelet planes besides).  chip_smoke phase 19 computes the
// bound per kind at the window cell's shape.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kB = 256;                 // threads a CTA
constexpr int kWarps = kB / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxKeys = 16;
constexpr int kTsNone = 0x7fffffff;
constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;
constexpr int kDigitBits = 4;           // sort and session: radix digits
constexpr int kMaxBins = 1 << kDigitBits;
constexpr int C_TIME = 1, C_LEN = 2, C_BATCH = 3, C_EXPBATCH = 4,
              C_DELAY = 5;

// kind ids (ops/dwin.py KIND_IDS)
enum Kind {
  K_LENGTH = 0, K_TIME, K_EXTTIME, K_TIMELENGTH, K_DELAY, K_SORT, K_SESSION,
  K_HOPPING, K_LENGTHBATCH, K_TIMEBATCH, K_EXTTIMEBATCH, K_BATCH
};

// flags a pool entry
constexpr unsigned char F_KEEP = 1, F_EMIT = 2, F_XKEEP = 4, F_LIVE = 8;

struct Prog {
  int kind, C, T, F, I, window_ms, length, skey_lane, telem, hop_ms, cap;
  int nkeys;
  int key_bank[kMaxKeys], key_lane[kMaxKeys], key_asc[kMaxKeys];
  int nbits;                           // sort: wavelet levels, ceil(log2 M)
};

struct Ptrs {
  const float* ring_f;
  const int* ring_i;
  const int* ring_ts;
  const int* fill;
  const float* exp_f;
  const int* exp_i;
  const int* exp_ts;
  const int* exp_fill;
  const int* telem;
  const float* ev_f;
  const int* ev_i;
  const int* ev_ts;
  const unsigned char* ev_valid;
  const int* now;
  const int* directive;
  float* o_ring_f;
  int* o_ring_i;
  int* o_ring_ts;
  int* o_fill;
  float* o_exp_f;
  int* o_exp_i;
  int* o_exp_ts;
  int* o_exp_fill;
  int* o_telem;
  int* buf;
  // scratch
  unsigned char* flags;
  int* evt;
  int* cause;
  int* krank;
  int* erank;
  int* xrank;
  int* bk;
  int* be;
  int* bx;
  int* g;  // [nv, last_id, K, E, X, min_live, done, 0]
  // sort and session only
  int* perm[2];   // radix / wavelet sequences (ranks), ping-pong
  int* inv;       // session: rank -> sorted position
  int* aux;       // sort: rank -> prefix length; session: position -> run
  int* mxa;       // session: a run's max ts over the carried live entries
  int* mxb;       // session: ... over the new ring's entries
  int* cb;        // session: the new ring's entries of a run
  int* wr;        // sort: wavelet zero counts, nbits rows of M + 1
  int* wz;        // sort: wavelet zeros a level
  int* rcnt;      // radix digit counts, [bins][CTA]
  int* rtot;      // radix digit totals
};

__host__ __device__ __forceinline__ bool has_exp_planes(int kind) {
  return kind == K_HOPPING || kind == K_LENGTHBATCH ||
         kind == K_TIMEBATCH || kind == K_EXTTIMEBATCH || kind == K_BATCH;
}

// the kinds whose egress also compacts the carried exp plane
__host__ __device__ __forceinline__ bool emits_exp(int kind) {
  return kind == K_HOPPING || kind == K_LENGTHBATCH ||
         kind == K_TIMEBATCH || kind == K_EXTTIMEBATCH;
}

__host__ __device__ __forceinline__ long long pool2(const Prog& p) {
  return static_cast<long long>(p.C) + p.T + (emits_exp(p.kind) ? p.C : 0);
}

__device__ __forceinline__ int wadd(int a, int b) {     // wrapping int32
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int pool_ts(const Prog& p, const Ptrs& q, int x) {
  if (x < p.C) return q.ring_ts[x];
  const int t = x - p.C;
  return q.ev_valid[t] ? q.ev_ts[t] : kTsNone;
}

__device__ __forceinline__ int pool_i(const Prog& p, const Ptrs& q, int x,
                                      int lane) {
  return x < p.C ? q.ring_i[static_cast<size_t>(x) * p.I + lane]
                 : q.ev_i[static_cast<size_t>(x - p.C) * p.I + lane];
}

__device__ __forceinline__ int pool_f_bits(const Prog& p, const Ptrs& q,
                                           int x, int lane) {
  return __float_as_int(
      x < p.C ? q.ring_f[static_cast<size_t>(x) * p.F + lane]
              : q.ev_f[static_cast<size_t>(x - p.C) * p.F + lane]);
}

// Exclusive sums of three per-thread counts over the CTA; totals out.
__device__ void block_scan3(int a, int b, int c, int& ea, int& eb, int& ec,
                            int& ta, int& tb, int& tc) {
  __shared__ int ws[3][kWarps];
  const int lid = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int ia = a, ib = b, ic = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int na = __shfl_up_sync(kFull, ia, o);
    const int nb = __shfl_up_sync(kFull, ib, o);
    const int nc = __shfl_up_sync(kFull, ic, o);
    if (lid >= o) {
      ia += na;
      ib += nb;
      ic += nc;
    }
  }
  if (lid == 31) {
    ws[0][wid] = ia;
    ws[1][wid] = ib;
    ws[2][wid] = ic;
  }
  __syncthreads();
  int pa = 0, pb = 0, pc = 0;
  ta = tb = tc = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < wid) {
      pa += ws[0][w];
      pb += ws[1][w];
      pc += ws[2][w];
    }
    ta += ws[0][w];
    tb += ws[1][w];
    tc += ws[2][w];
  }
  ea = pa + ia - a;
  eb = pb + ib - b;
  ec = pc + ic - c;
  __syncthreads();                       // ws is reused by the next call
}

__device__ int block_min(int v) {
  __shared__ int ws[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    const int u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = ws[0];
  for (int w = 1; w < kWarps; ++w) m = ws[w] < m ? ws[w] : m;
  __syncthreads();
  return m;
}

// ---------------------------------------------------------------- pass 0

__global__ void __launch_bounds__(kScanThreads)
dwin_prep(Prog p, Ptrs q) {
  __shared__ int red[kScanThreads / 32];
  const int tid = threadIdx.x;
  int c = 0;
  for (int t = tid; t < p.T; t += kScanThreads) c += q.ev_valid[t] != 0;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if ((tid & 31) == 0) red[tid >> 5] = c;
  __syncthreads();
  int nv = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) nv += red[w];
  __syncthreads();
  if (p.kind == K_EXTTIMEBATCH) {
    // the last flushed batch id: carried entries are batch 0, chunk row t
    // (live iff t < nv) batch directive[t]; flushed iff id < n_done
    const int n_done = q.now[0];
    int m = -1;
    for (int t = tid; t < nv && t < p.T; t += kScanThreads) {
      const int b = q.directive[t];
      if (b < n_done && b > m) m = b;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int u = __shfl_xor_sync(kFull, m, o);
      m = u > m ? u : m;
    }
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      int mm = (q.fill[0] > 0 && 0 < n_done) ? 0 : -1;
      for (int w = 0; w < kScanThreads / 32; ++w)
        mm = red[w] > mm ? red[w] : mm;
      q.g[1] = mm;
    }
  }
  if (tid == 0) {
    q.g[0] = nv;
    q.g[5] = kTsNone;
    q.g[6] = 0;
  }
}

// ------------------------------------------- sort and session: the order

// pool index of the live entry of rank r
__device__ __forceinline__ int pool_of(int r, int fill, int C) {
  return r < fill ? r : C + (r - fill);
}

// sort key k of pool entry x as an unsigned whose order is the key's
// direction: floats with -0.0 as +0.0 and NaN after every number; ints
// with the sign flipped; desc complemented (NaN stays last).  k < 0 (a
// sort without keys): 0.
__device__ __forceinline__ unsigned okey(const Prog& p, const Ptrs& q,
                                         int x, int k) {
  if (k < 0) return 0u;
  unsigned a;
  if (p.key_bank[k] == 0) {
    unsigned u = static_cast<unsigned>(pool_f_bits(p, q, x, p.key_lane[k]));
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
    if (u == 0x80000000u) u = 0u;
    a = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  } else {
    a = static_cast<unsigned>(pool_i(p, q, x, p.key_lane[k])) ^ 0x80000000u;
  }
  return p.key_asc[k] ? a : ~a;
}

__device__ __forceinline__ bool f_is_nan(const Prog& p, const Ptrs& q,
                                         int x, int k) {
  return p.key_bank[k] == 0 &&
         (static_cast<unsigned>(pool_f_bits(p, q, x, p.key_lane[k])) &
          0x7fffffffu) > 0x7f800000u;
}

// One radix pass: digits of the sequence `in` (mode 0: the ranks' order
// key word `key`, `first` = the identity sequence; mode 1: the wavelet
// level's bit of the ranks themselves), stably partitioned into `out`.
struct Pass {
  int mode, key, shift, bins, first, level;
  const int* in;
  int* out;
};

__device__ __forceinline__ int pass_item(const Pass& a, int i) {
  return a.mode == 0 && a.first ? i : a.in[i];
}

__device__ __forceinline__ int pass_digit(const Prog& p, const Ptrs& q,
                                          const Pass& a, int item,
                                          int fill) {
  if (a.mode == 1) return (item >> a.shift) & 1;
  return static_cast<int>(
      (okey(p, q, pool_of(item, fill, p.C), a.key) >> a.shift) &
      (kMaxBins - 1));
}

// The CTA's stable rank of each thread's digit (d < bins; d == bins: no
// item) among the CTA's threads of that digit; the CTA's count of each
// digit into cnt[bins].
__device__ int cta_digit_rank(int d, int bins, int* cnt) {
  __shared__ int wc[kWarps][kMaxBins];
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  for (int i = tid; i < kWarps * kMaxBins; i += kB) wc[i / kMaxBins][i % kMaxBins] = 0;
  __syncthreads();
  const unsigned m = __match_any_sync(kFull, d);
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

__global__ void __launch_bounds__(kB)
dwin_radix_count(Prog p, Ptrs q, Pass a) {
  __shared__ int cnt[kMaxBins];
  const int fill = q.fill[0];
  const int L = fill + q.g[0];
  const int i = blockIdx.x * kB + threadIdx.x;
  const int d = i < L ? pass_digit(p, q, a, pass_item(a, i), fill) : a.bins;
  cta_digit_rank(d, a.bins, cnt);
  if (threadIdx.x < a.bins)
    q.rcnt[threadIdx.x * gridDim.x + blockIdx.x] = cnt[threadIdx.x];
}

// one CTA a digit: its per-CTA counts to exclusive offsets, its total
__global__ void __launch_bounds__(kScanThreads)
dwin_radix_scan(Ptrs q, int nb) {
  __shared__ int ws[kScanThreads / 32];
  __shared__ int carry_in;
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  int* c = q.rcnt + static_cast<size_t>(blockIdx.x) * nb;
  if (tid == 0) carry_in = 0;
  __syncthreads();
  for (int b0 = 0; b0 < nb; b0 += kScanThreads) {
    const int b = b0 + tid;
    const int v = b < nb ? c[b] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, o);
      if (lid >= o) inc += u;
    }
    if (lid == 31) ws[wid] = inc;
    __syncthreads();
    int pre = 0, tot = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      if (w < wid) pre += ws[w];
      tot += ws[w];
    }
    if (b < nb) c[b] = carry_in + pre + inc - v;
    __syncthreads();
    if (tid == 0) carry_in += tot;
    __syncthreads();
  }
  if (tid == 0) q.rtot[blockIdx.x] = carry_in;
}

__global__ void __launch_bounds__(kB)
dwin_radix_scatter(Prog p, Ptrs q, Pass a) {
  __shared__ int cnt[kMaxBins];
  const int fill = q.fill[0];
  const int L = fill + q.g[0];
  const int i = blockIdx.x * kB + threadIdx.x;
  const int item = i < L ? pass_item(a, i) : 0;
  const int d = i < L ? pass_digit(p, q, a, item, fill) : a.bins;
  const int r = cta_digit_rank(d, a.bins, cnt);
  if (i < L) {
    int base = q.rcnt[d * gridDim.x + blockIdx.x];
    for (int e = 0; e < d; ++e) base += q.rtot[e];
    a.out[base + r] = item;
    if (a.mode == 1) {                    // the level's zeros before i
      int* R = q.wr + static_cast<size_t>(a.level) * (p.C + p.T + 1);
      R[i] = q.rcnt[blockIdx.x] + (d == 0 ? r : threadIdx.x - r);
    }
  }
  if (a.mode == 1 && blockIdx.x == 0 && threadIdx.x == 0) {
    q.wr[static_cast<size_t>(a.level) * (p.C + p.T + 1) + L] = q.rtot[0];
    q.wz[a.level] = q.rtot[0];
  }
}

// sort: each live entry's predecessor prefix in the sorted order `srt`
__global__ void __launch_bounds__(kB)
dwin_sort_prefix(Prog p, Ptrs q, const int* __restrict__ srt) {
  const int fill = q.fill[0];
  const int L = fill + q.g[0];
  const int i = blockIdx.x * kB + threadIdx.x;
  if (i >= L) return;
  const int r = srt[i];
  const int x = pool_of(r, fill, p.C);
  int kn = -1;                            // x's first NaN key
  for (int k = 0; k < p.nkeys && kn < 0; ++k)
    if (f_is_nan(p, q, x, k)) kn = k;
  int len = i;
  if (kn >= 0) {                          // the run of x's first kn keys
    int lo = 0, hi = i;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int y = pool_of(srt[mid], fill, p.C);
      bool lt = false;
      for (int k = 0; k < kn; ++k) {
        const unsigned ky = okey(p, q, y, k), kx = okey(p, q, x, k);
        if (ky != kx) {
          lt = ky < kx;
          break;
        }
      }
      if (lt) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    len = lo;
  }
  q.aux[r] = len;
}

// sort: the k-th smallest (from 0) of the wavelet's sequence in [0, len)
__device__ int wavelet_kth(const Prog& p, const Ptrs& q, int k, int len) {
  const size_t stride = static_cast<size_t>(p.C) + p.T + 1;
  int lo = 0, hi = len, v = 0;
  for (int l = 0; l < p.nbits; ++l) {
    const int* R = q.wr + l * stride;
    const int rlo = R[lo], rhi = R[hi];
    if (k < rhi - rlo) {
      lo = rlo;
      hi = rhi;
    } else {
      k -= rhi - rlo;
      const int z = q.wz[l];
      lo = z + lo - rlo;
      hi = z + hi - rhi;
      v |= 1 << (p.nbits - 1 - l);
    }
  }
  return v;
}

// session: each sorted position's run of equal keys; the runs' slots
// reset
__global__ void __launch_bounds__(kB)
dwin_runs(Prog p, Ptrs q, const int* __restrict__ srt) {
  const int fill = q.fill[0];
  const int L = fill + q.g[0];
  const int i = blockIdx.x * kB + threadIdx.x;
  if (i >= L) return;
  const int r = srt[i];
  q.inv[r] = i;
  const int key = pool_i(p, q, pool_of(r, fill, p.C), p.skey_lane);
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pool_i(p, q, pool_of(srt[mid], fill, p.C), p.skey_lane) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  q.aux[i] = lo;
  q.mxa[i] = kNeg;
  q.mxb[i] = static_cast<int>(0x80000000u);
  q.cb[i] = 0;
}

// session: a run's max ts (and count) over its members: the carried live
// entries (which 0), the new ring's entries (which 1, after the scan)
__global__ void __launch_bounds__(kB)
dwin_session_agg(Prog p, Ptrs q, const int* __restrict__ srt, int which) {
  const int fill = q.fill[0];
  const int L = fill + q.g[0];
  const int i = blockIdx.x * kB + threadIdx.x;
  const int lid = threadIdx.x & 31;
  const bool active = i < L;
  int rs = 0x7fffffff, v = static_cast<int>(0x80000000u), c = 0;
  if (active) {
    rs = q.aux[i];
    const int r = srt[i];
    const int x = pool_of(r, fill, p.C);
    bool member;
    if (which == 0) {
      member = r < fill;
    } else {
      member = (q.flags[x] & F_KEEP) &&
               q.bk[x / kB] + q.krank[x] < p.C;
    }
    if (member) {
      v = pool_ts(p, q, x);
      c = 1;
    }
  }
  for (int o = 1; o < 32; o <<= 1) {     // segmented by run, in the warp
    const int vv = __shfl_up_sync(kFull, v, o);
    const int cc = __shfl_up_sync(kFull, c, o);
    const int rr = __shfl_up_sync(kFull, rs, o);
    if (lid >= o && rr == rs) {
      v = vv > v ? vv : v;
      c += cc;
    }
  }
  const int next = __shfl_down_sync(kFull, rs, 1);
  if (active && c > 0 && (lid == 31 || next != rs)) {
    if (which == 0) {
      atomicMax(&q.mxa[rs], v);
    } else {
      atomicMax(&q.mxb[rs], v);
      atomicAdd(&q.cb[rs], c);
    }
  }
}

// ---------------------------------------------------------------- pass 1

// first chunk index whose ets >= v (JAX's scan searchsorted, side='left')
__device__ int search_scan(const Prog& p, const Ptrs& q, int v) {
  const int n = p.T;
  int levels = 0;
  while ((1ll << levels) < static_cast<long long>(n) + 1) ++levels;
  int low = 0, high = n;
  for (int l = 0; l < levels; ++l) {
    const int mid = static_cast<int>(
        (static_cast<unsigned>(low) + static_cast<unsigned>(high)) >> 1);
    const int a = q.ev_valid[mid] ? q.ev_ts[mid] : kTsNone;
    if (v <= a) {
      high = mid;
    } else {
      low = mid;
    }
  }
  return high;
}

__global__ void __launch_bounds__(kB)
dwin_decide(Prog p, Ptrs q) {
  const int tid = threadIdx.x;
  const long long m2 = pool2(p);
  const int M = p.C + p.T;
  const long long xl = static_cast<long long>(blockIdx.x) * kB + tid;
  const bool in = xl < m2;
  const int x = static_cast<int>(xl);
  const int C = p.C;
  const int fill = q.fill[0];
  const int nv = q.g[0];
  const int now = q.now[0];
  bool keep = false, emit = false, xkeep = false, live = false;
  int evt = 0, cause = 0, pts = kTsNone, rank = 0;
  const bool is_carry = x < C;
  if (in && x < M) {
    pts = pool_ts(p, q, x);
    live = is_carry ? x < fill : (x - C) < nv;
    rank = is_carry ? x : fill + (x - C);
  }
  const int after_self = !is_carry ? x - C + 1 : (x - fill + 1 > 0 ? x - fill + 1 : 0);

  if (p.kind == K_SORT) {
    // tN: the n-th smallest rank in the entry's predecessor prefix
    const int n = p.length;
    int tN = kBig;
    if (in && x < M && live && n >= 1 && n - 1 < M) {
      const int len = q.aux[rank];
      if (len >= n) {
        const int v = wavelet_kth(p, q, n - 1, len);
        tN = v < fill ? -1 : v - fill;
      }
    }
    const int arr = is_carry ? -1 : x - C;
    evt = tN > arr ? tN : arr;
    emit = in && x < M && live && n - 1 < M && tN < kBig && evt < nv;
    keep = live && !emit;
    cause = C_LEN;
  } else if (p.kind == K_SESSION) {
    // a carried live entry's key's last activity over the carried entries
    int last = kNeg;
    if (in && x < M && is_carry && live) last = q.mxa[q.aux[q.inv[x]]];
    evt = wadd(last, p.window_ms);
    emit = is_carry && live && evt <= now;
    keep = live && !emit;
    cause = C_TIME;
  } else if (in && x < M) {
    switch (p.kind) {
      case K_LENGTH:
        evt = wadd(wadd(rank, p.length), -fill);
        emit = live && evt < nv && evt >= 0;
        cause = C_LEN;
        keep = live && !emit;
        break;
      case K_TIME:
      case K_DELAY:
        emit = live && is_carry && pts <= wadd(now, -p.window_ms);
        cause = p.kind == K_TIME ? C_TIME : C_DELAY;
        keep = live && !emit;
        break;
      case K_EXTTIME:
      case K_TIMELENGTH: {
        int te = search_scan(p, q, wadd(pts, p.window_ms));
        te = te > after_self ? te : after_self;
        if (p.kind == K_EXTTIME) {
          evt = te;
          emit = live && evt < nv;
          cause = C_TIME;
        } else {
          int le = wadd(wadd(rank, p.length), -fill);
          le = le > after_self ? le : after_self;
          evt = te < le ? te : le;
          const bool by_now = nv == 0 && wadd(pts, p.window_ms) <= now;
          emit = live && (evt < nv || by_now);
          cause = te <= le ? C_TIME : C_LEN;
        }
        keep = live && !emit;
        break;
      }
      case K_HOPPING: {
        const bool flushing = q.directive[0] > 0;
        keep = live && (!flushing || pts > wadd(now, -p.window_ms));
        emit = keep && flushing;
        cause = C_BATCH;
        break;
      }
      case K_BATCH: {
        const bool has_ev = nv > 0;
        emit = live && ((is_carry && has_ev) || !is_carry);
        cause = is_carry ? C_EXPBATCH : C_BATCH;
        keep = live && (!is_carry || !has_ev);
        break;
      }
      default: {                           // lengthBatch / (ext)timeBatch
        int bid, n_done, last_id;
        if (p.kind == K_LENGTHBATCH) {
          bid = rank / p.length;
          n_done = (fill + nv) / p.length;
          last_id = n_done - 1;
        } else {
          bid = is_carry ? 0 : q.directive[x - C];
          n_done = now;
          last_id = p.kind == K_TIMEBATCH ? n_done - 1 : q.g[1];
        }
        emit = live && bid < n_done;
        keep = live && !emit;
        xkeep = emit && bid == last_id && last_id >= 0;
        evt = bid;
        cause = C_BATCH;
        break;
      }
    }
  } else if (in) {                         // the carried exp plane
    const int e = x - M;
    const bool flushing = p.kind == K_HOPPING ? q.directive[0] > 0 : false;
    if (p.kind == K_HOPPING) {
      emit = e < q.exp_fill[0] && flushing &&
             q.exp_ts[e] <= wadd(now, -p.window_ms);
    } else {
      const int n_done = p.kind == K_LENGTHBATCH ? (fill + nv) / p.length
                                                 : now;
      emit = e < q.exp_fill[0] && n_done > 0;
    }
    cause = C_EXPBATCH;
  }
  int ek, ee, ex, tk, te, tx;
  block_scan3(keep, emit, xkeep, ek, ee, ex, tk, te, tx);
  if (in) {
    q.flags[x] = static_cast<unsigned char>(
        (keep ? F_KEEP : 0) | (emit ? F_EMIT : 0) | (xkeep ? F_XKEEP : 0) |
        (live ? F_LIVE : 0));
    q.evt[x] = evt;
    q.cause[x] = cause;
    q.krank[x] = ek;
    q.erank[x] = ee;
    q.xrank[x] = ex;
  }
  if (tid == 0) {
    q.bk[blockIdx.x] = tk;
    q.be[blockIdx.x] = te;
    q.bx[blockIdx.x] = tx;
  }
}

// ---------------------------------------------------------------- pass 2

__global__ void __launch_bounds__(kScanThreads)
dwin_scan(Ptrs q, int nb) {
  __shared__ int ws[3][kScanThreads / 32];
  __shared__ int carry_in[3];
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  if (tid == 0) carry_in[0] = carry_in[1] = carry_in[2] = 0;
  __syncthreads();
  for (int b0 = 0; b0 < nb; b0 += kScanThreads) {
    const int b = b0 + tid;
    int v[3] = {0, 0, 0};
    if (b < nb) {
      v[0] = q.bk[b];
      v[1] = q.be[b];
      v[2] = q.bx[b];
    }
    int inc[3] = {v[0], v[1], v[2]};
    for (int o = 1; o < 32; o <<= 1) {
      for (int k = 0; k < 3; ++k) {
        const int u = __shfl_up_sync(kFull, inc[k], o);
        if (lid >= o) inc[k] += u;
      }
    }
    if (lid == 31)
      for (int k = 0; k < 3; ++k) ws[k][wid] = inc[k];
    __syncthreads();
    int tot[3] = {0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      int pre = 0;
      for (int w = 0; w < kScanThreads / 32; ++w) {
        if (w < wid) pre += ws[k][w];
        tot[k] += ws[k][w];
      }
      inc[k] = carry_in[k] + pre + inc[k] - v[k];
    }
    if (b < nb) {
      q.bk[b] = inc[0];
      q.be[b] = inc[1];
      q.bx[b] = inc[2];
    }
    __syncthreads();
    if (tid == 0)
      for (int k = 0; k < 3; ++k) carry_in[k] += tot[k];
    __syncthreads();
  }
  if (tid == 0) {
    q.g[2] = carry_in[0];
    q.g[3] = carry_in[1];
    q.g[4] = carry_in[2];
  }
}

// ---------------------------------------------------------------- pass 3

__device__ __forceinline__ void copy_entry(const Prog& p, const Ptrs& q,
                                           int x, float* of, int* oi,
                                           int slot) {
  for (int l = 0; l < p.F; ++l)
    of[static_cast<size_t>(slot) * p.F + l] =
        __int_as_float(pool_f_bits(p, q, x, l));
  for (int l = 0; l < p.I; ++l)
    oi[static_cast<size_t>(slot) * p.I + l] = pool_i(p, q, x, l);
}

__global__ void __launch_bounds__(kB)
dwin_scatter(Prog p, Ptrs q) {
  __shared__ bool am_last;
  const int tid = threadIdx.x;
  const long long m2 = pool2(p);
  const int M = p.C + p.T;
  const int C = p.C;
  const long long xl = static_cast<long long>(blockIdx.x) * kB + tid;
  const bool in = xl < m2;
  const int x = static_cast<int>(xl);
  const int K = q.g[2], E = q.g[3], X = q.g[4];
  const int nv = q.g[0];
  const int fill = q.fill[0];
  const int now = q.now[0];
  const unsigned char fl = in ? q.flags[x] : 0;
  const bool keep = fl & F_KEEP;
  const bool exp_kind = has_exp_planes(p.kind);
  // does this step rewrite the exp plane (else it is copied through)?
  bool exp_new = false;
  if (p.kind == K_HOPPING) {
    exp_new = q.directive[0] > 0;
  } else if (p.kind == K_LENGTHBATCH) {
    exp_new = (fill + nv) / p.length > 0;
  } else if (p.kind == K_TIMEBATCH || p.kind == K_EXTTIMEBATCH) {
    exp_new = now > 0;
  }
  int kp = C;                                      // partition position
  if (in && x < M) {
    const int kb = q.bk[blockIdx.x] + q.krank[x];  // kept entries before x
    kp = keep ? kb : K + (x - kb);
    if (kp < C) {
      const int ts = keep ? pool_ts(p, q, x) : kTsNone;
      copy_entry(p, q, x, q.o_ring_f, q.o_ring_i, kp);
      q.o_ring_ts[kp] = ts;
      if (p.kind == K_HOPPING && exp_new) {
        copy_entry(p, q, x, q.o_exp_f, q.o_exp_i, kp);
        q.o_exp_ts[kp] = ts;
      }
    }
    if (exp_new && p.kind != K_HOPPING) {            // the batch kinds
      const bool xk = fl & F_XKEEP;
      const int xb = q.bx[blockIdx.x] + q.xrank[x];
      const int xp = xk ? xb : X + (x - xb);
      if (xp < C) {
        copy_entry(p, q, x, q.o_exp_f, q.o_exp_i, xp);
        q.o_exp_ts[xp] = xk ? pool_ts(p, q, x) : kTsNone;
      }
    }
  }
  if (exp_kind && !exp_new && in && x < C) {         // exp plane unchanged
    for (int l = 0; l < p.F; ++l)
      q.o_exp_f[static_cast<size_t>(x) * p.F + l] =
          q.exp_f[static_cast<size_t>(x) * p.F + l];
    for (int l = 0; l < p.I; ++l)
      q.o_exp_i[static_cast<size_t>(x) * p.I + l] =
          q.exp_i[static_cast<size_t>(x) * p.I + l];
    q.o_exp_ts[x] = q.exp_ts[x];
  }
  // the egress row
  if (fl & F_EMIT) {
    const int r = q.be[blockIdx.x] + q.erank[x];
    if (r < p.cap) {
      int* row = q.buf + static_cast<size_t>(r) * (4 + p.F + p.I);
      row[0] = x;
      row[1] = q.evt[x];
      row[2] = q.cause[x];
      if (x < M) {
        row[3] = pool_ts(p, q, x);
        for (int l = 0; l < p.F; ++l) row[4 + l] = pool_f_bits(p, q, x, l);
        for (int l = 0; l < p.I; ++l) row[4 + p.F + l] = pool_i(p, q, x, l);
      } else {
        const int e = x - M;
        row[3] = q.exp_ts[e];
        for (int l = 0; l < p.F; ++l)
          row[4 + l] =
              __float_as_int(q.exp_f[static_cast<size_t>(e) * p.F + l]);
        for (int l = 0; l < p.I; ++l)
          row[4 + p.F + l] = q.exp_i[static_cast<size_t>(e) * p.I + l];
      }
    }
  }
  // the tail's min live ts
  const bool sliding = p.kind <= K_DELAY;
  if (sliding || p.kind == K_SESSION) {
    const bool mine = in && x < M && keep && kp < C;
    int cand = kTsNone;
    if (sliding) {
      if (mine) cand = pool_ts(p, q, x);
    } else if (mine) {
      // the entry's key's last activity among the new ring's live slots;
      // the twin's row max includes NEG unless every slot is this key's
      const int rs = q.aux[q.inv[x < C ? x : fill + (x - C)]];
      const int last = q.mxb[rs];
      cand = q.cb[rs] >= C || last > kNeg ? last : kNeg;
    }
    const int m = block_min(cand);
    if (tid == 0 && m != kTsNone) atomicMin(&q.g[5], m);
  }
  // the last CTA writes the scalars, the telemetry and the tail
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned v = atomicAdd(reinterpret_cast<unsigned*>(&q.g[6]), 1u);
    am_last = v == gridDim.x - 1;
  }
  __syncthreads();
  if (!am_last || tid != 0) return;
  const int nfill = K < C ? K : C;
  int ovf = K > C;
  int post_exp = 0;
  if (p.kind == K_HOPPING) {
    post_exp = exp_new ? nfill : q.exp_fill[0];
  } else if (p.kind == K_LENGTHBATCH || p.kind == K_TIMEBATCH ||
             p.kind == K_EXTTIMEBATCH) {
    post_exp = exp_new ? (X < C ? X : C) : q.exp_fill[0];
    ovf = ovf || X > C;
  }
  q.o_fill[0] = nfill;
  if (exp_kind)
    q.o_exp_fill[0] = p.kind == K_BATCH ? q.exp_fill[0] : post_exp;
  const int width = 4 + p.F + p.I;
  int* tail = q.buf + static_cast<size_t>(p.cap + (p.telem ? 1 : 0)) * width;
  if (p.telem) {
    const int n1 = wadd(q.telem[1], E);
    const int n2 = wadd(q.telem[2], ovf);
    q.o_telem[0] = nfill;
    q.o_telem[1] = n1;
    q.o_telem[2] = n2;
    int* trow = q.buf + static_cast<size_t>(p.cap) * width;
    for (int c = 0; c < width; ++c) trow[c] = 0;
    trow[0] = nfill;
    trow[1] = n1;
    trow[2] = n2;
  }
  for (int c = 0; c < width; ++c) tail[c] = 0;
  tail[0] = E;
  tail[1] = nfill;
  tail[2] = post_exp;
  tail[3] = (sliding || p.kind == K_SESSION) ? atomicAdd(&q.g[5], 0)
                                             : kTsNone;
  tail[4] = ovf;
}

void read_prog(const int* h, Prog& p) {
  p.kind = h[0];
  p.C = h[1];
  p.T = h[2];
  p.F = h[3];
  p.I = h[4];
  p.window_ms = h[5];
  p.length = h[6];
  p.skey_lane = h[7];
  p.telem = h[8];
  p.hop_ms = h[9];
  p.cap = h[10];
  p.nkeys = h[11];
  for (int k = 0; k < p.nkeys && k < kMaxKeys; ++k) {
    p.key_bank[k] = h[12 + 3 * k];
    p.key_lane[k] = h[13 + 3 * k];
    p.key_asc[k] = h[14 + 3 * k];
  }
  const long long M = static_cast<long long>(p.C) + p.T;
  p.nbits = 1;
  while ((1ll << p.nbits) < M) ++p.nbits;
}

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

bool sorts(const Prog& p) { return p.kind == K_SORT || p.kind == K_SESSION; }

// The scratch layout, in one place: the byte offset of each plane
// (kinds without a plane give it 0 bytes); returns the total.
size_t scratch_layout(const Prog& p, size_t* off) {
  const size_t m2 = static_cast<size_t>(pool2(p));
  const size_t nb = (m2 + kB - 1) / kB;
  const size_t M = static_cast<size_t>(p.C) + p.T;
  const bool sort = p.kind == K_SORT, session = p.kind == K_SESSION;
  const size_t sz[] = {
      align16(m2),                                      // flags
      align16(m2 * 4), align16(m2 * 4), align16(m2 * 4),  // evt, cause,
      align16(m2 * 4), align16(m2 * 4),                 // k/e/x ranks
      align16(nb * 4), align16(nb * 4), align16(nb * 4),  // bk, be, bx
      64,                                               // g
      sorts(p) ? align16(M * 4) : 0,                    // perm[0]
      sorts(p) ? align16(M * 4) : 0,                    // perm[1]
      session ? align16(M * 4) : 0,                     // inv
      sorts(p) ? align16(M * 4) : 0,                    // aux
      session ? align16(M * 4) : 0,                     // mxa
      session ? align16(M * 4) : 0,                     // mxb
      session ? align16(M * 4) : 0,                     // cb
      sort ? align16(static_cast<size_t>(p.nbits) * (M + 1) * 4) : 0,  // wr
      sort ? align16(static_cast<size_t>(p.nbits) * 4) : 0,           // wz
      sorts(p) ? align16(kMaxBins * nb * 4) : 0,        // rcnt
      sorts(p) ? align16(kMaxBins * 4) : 0};            // rtot
  size_t t = 0;
  for (size_t k = 0; k < sizeof(sz) / sizeof(sz[0]); ++k) {
    if (off) off[k] = t;
    t += sz[k];
  }
  return t;
}
constexpr int kPlanes = 21;

}  // namespace

extern "C" {

// Bytes of device scratch one step needs (hdr: see dwin_step).
long long dwin_scratch_bytes(const int* hdr) {
  Prog p;
  read_prog(hdr, p);
  return static_cast<long long>(scratch_layout(p, nullptr));
}

// One step.  hdr (host ints): kind id, C, T, F, I, window_ms, length,
// skey_lane, telemetry, hop_ms, cap, n sort keys, then (bank, lane, asc)
// per key.  ptrs (host array of device pointers, in ops/dwin.py
// KERNEL_PTRS order): the carry in (ring_f, ring_i, ring_ts, fill,
// exp_f, exp_i, exp_ts, exp_fill, telem; null where the kind has none),
// the chunk (ev_f, ev_i, ev_ts, ev_valid, now, directive), the carry out
// (the nine), the egress buffer, the scratch (scratch_bytes bytes, at
// least dwin_scratch_bytes(hdr)).  Returns the CUDA error of the launches
// (0 = ok).
int dwin_step(const int* hdr, const long long* ptrs, long long scratch_bytes,
              void* stream) {
  Prog p;
  read_prog(hdr, p);
  if (p.nkeys > kMaxKeys || p.T < 1 || p.C < 1 || p.F < 1 || p.I < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t off[kPlanes];
  if (scratch_bytes < 0 ||
      static_cast<size_t>(scratch_bytes) < scratch_layout(p, off))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t m2 = static_cast<size_t>(pool2(p));
  const size_t nb = (m2 + kB - 1) / kB;
  if (m2 > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidValue);
  Ptrs q;
  const void* const* v = reinterpret_cast<const void* const*>(ptrs);
  q.ring_f = static_cast<const float*>(v[0]);
  q.ring_i = static_cast<const int*>(v[1]);
  q.ring_ts = static_cast<const int*>(v[2]);
  q.fill = static_cast<const int*>(v[3]);
  q.exp_f = static_cast<const float*>(v[4]);
  q.exp_i = static_cast<const int*>(v[5]);
  q.exp_ts = static_cast<const int*>(v[6]);
  q.exp_fill = static_cast<const int*>(v[7]);
  q.telem = static_cast<const int*>(v[8]);
  q.ev_f = static_cast<const float*>(v[9]);
  q.ev_i = static_cast<const int*>(v[10]);
  q.ev_ts = static_cast<const int*>(v[11]);
  q.ev_valid = static_cast<const unsigned char*>(v[12]);
  q.now = static_cast<const int*>(v[13]);
  q.directive = static_cast<const int*>(v[14]);
  q.o_ring_f = static_cast<float*>(const_cast<void*>(v[15]));
  q.o_ring_i = static_cast<int*>(const_cast<void*>(v[16]));
  q.o_ring_ts = static_cast<int*>(const_cast<void*>(v[17]));
  q.o_fill = static_cast<int*>(const_cast<void*>(v[18]));
  q.o_exp_f = static_cast<float*>(const_cast<void*>(v[19]));
  q.o_exp_i = static_cast<int*>(const_cast<void*>(v[20]));
  q.o_exp_ts = static_cast<int*>(const_cast<void*>(v[21]));
  q.o_exp_fill = static_cast<int*>(const_cast<void*>(v[22]));
  q.o_telem = static_cast<int*>(const_cast<void*>(v[23]));
  q.buf = static_cast<int*>(const_cast<void*>(v[24]));
  unsigned char* s = static_cast<unsigned char*>(const_cast<void*>(v[25]));
  int* w[kPlanes];
  for (int k = 0; k < kPlanes; ++k) w[k] = reinterpret_cast<int*>(s + off[k]);
  q.flags = s;
  q.evt = w[1];
  q.cause = w[2];
  q.krank = w[3];
  q.erank = w[4];
  q.xrank = w[5];
  q.bk = w[6];
  q.be = w[7];
  q.bx = w[8];
  q.g = w[9];
  q.perm[0] = w[10];
  q.perm[1] = w[11];
  q.inv = w[12];
  q.aux = w[13];
  q.mxa = w[14];
  q.mxb = w[15];
  q.cb = w[16];
  q.wr = w[17];
  q.wz = w[18];
  q.rcnt = w[19];
  q.rtot = w[20];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nbu = static_cast<unsigned>(nb);
  dwin_prep<<<1, kScanThreads, 0, st>>>(p, q);
  const int* srt = nullptr;
  if (sorts(p)) {
    // the live entries (ranks) sorted by the keys, the last key first
    Prog ps = p;
    if (p.kind == K_SESSION) {
      ps.nkeys = 1;
      ps.key_bank[0] = 1;
      ps.key_lane[0] = p.skey_lane;
      ps.key_asc[0] = 1;
    }
    int cur = 0, first = 1;
    for (int k = ps.nkeys - 1; k >= (ps.nkeys > 0 ? 0 : -1); --k) {
      for (int sh = 0; sh < 32; sh += kDigitBits) {
        const Pass a = {0, k, sh, kMaxBins, first, 0, q.perm[cur],
                        q.perm[1 - cur]};
        dwin_radix_count<<<nbu, kB, 0, st>>>(ps, q, a);
        dwin_radix_scan<<<kMaxBins, kScanThreads, 0, st>>>(q, nbu);
        dwin_radix_scatter<<<nbu, kB, 0, st>>>(ps, q, a);
        cur = 1 - cur;
        first = 0;
        if (k < 0) break;                   // no keys: one identity pass
      }
    }
    srt = q.perm[cur];
    if (p.kind == K_SORT) {
      dwin_sort_prefix<<<nbu, kB, 0, st>>>(p, q, srt);
      for (int l = 0; l < p.nbits; ++l) {   // the wavelet matrix
        const Pass a = {1, 0, p.nbits - 1 - l, 2, 0, l, q.perm[cur],
                        q.perm[1 - cur]};
        dwin_radix_count<<<nbu, kB, 0, st>>>(p, q, a);
        dwin_radix_scan<<<2, kScanThreads, 0, st>>>(q, nbu);
        dwin_radix_scatter<<<nbu, kB, 0, st>>>(p, q, a);
        cur = 1 - cur;
      }
    } else {
      dwin_runs<<<nbu, kB, 0, st>>>(p, q, srt);
      dwin_session_agg<<<nbu, kB, 0, st>>>(p, q, srt, 0);
    }
  }
  dwin_decide<<<nbu, kB, 0, st>>>(p, q);
  dwin_scan<<<1, kScanThreads, 0, st>>>(q, static_cast<int>(nb));
  if (p.kind == K_SESSION)
    dwin_session_agg<<<nbu, kB, 0, st>>>(p, q, srt, 1);
  dwin_scatter<<<nbu, kB, 0, st>>>(p, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
