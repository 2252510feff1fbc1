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
// exclusive scan.  Four launches on one stream:
//   0. prep (one CTA): nv = #valid chunk rows (the twin's `live` reads it),
//      externalTimeBatch's last flushed batch id, the accumulators reset;
//   1. decide (one thread an entry): keep / emit / exp-keep, evict_t and
//      cause by the kind's closed form; in-CTA exclusive ranks and per-CTA
//      counts.  externalTime and timeLength run JAX's own searchsorted
//      (method='scan': ceil(log2(T+1)) halvings, mid = (low+high)/2,
//      go_left = q <= a[mid]), which decides an out-of-order attribute.
//      sort: entry x is displaced at the (n)-th smallest arrival among its
//      lex-predecessors; those arrivals rise with the pool index (carry
//      entries all -1 first), so it is the arrival of x's n-th
//      predecessor in index order: a walk over the pool in shared-memory
//      tiles that stops when every thread of the CTA has found its own.
//      session: a carried entry's key's last activity, a tiled walk over
//      the carried entries;
//   2. scan (one CTA): exclusive offsets of the per-CTA counts;
//   3. scatter: the new ring (and exp plane) by partition position, the
//      egress rows by emit position; the last CTA to finish writes fill,
//      exp_fill, the telemetry leaf and rows, and the tail.  The tail's
//      min live ts (sliding kinds: the kept entries' ts; session: their
//      key's last activity in the new ring, another tiled walk) is an
//      atomicMin across CTAs.
// The sort and session walks are quadratic in the pool, like the twin's
// [M, M] masks, but never allocate M^2 bytes: simple and right first.
//
// What bounds it on this card: bytes.  The carry in and out (C entries of
// 4(F+I)+4 bytes each way, twice for the batch kinds), the chunk (T rows),
// the emitted rows; the scratch adds ~21 B an entry.  chip_smoke phase 19
// computes the bound per kind at the window cell's shape.

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
  __shared__ int tile_a[kMaxKeys][kB];
  __shared__ int tile_r[kB];
  __shared__ unsigned char tile_l[kB];
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
    // the n-th lex-predecessor (in index order) of each live entry
    const int n = p.length;
    const int kth = (n - 1 < M - 1 ? n - 1 : M - 1) + 1;
    int xa[kMaxKeys];
    if (in && x < M) {
      for (int k = 0; k < p.nkeys; ++k)
        xa[k] = p.key_bank[k] == 0 ? pool_f_bits(p, q, x, p.key_lane[k])
                                   : pool_i(p, q, x, p.key_lane[k]);
    }
    int cnt = 0, tN = kBig;
    bool done = !(in && x < M && live) || n - 1 >= M;
    for (int y0 = 0; y0 < M; y0 += kB) {
      if (!__syncthreads_or(!done)) break;
      const int y = y0 + tid;
      if (y < M) {
        for (int k = 0; k < p.nkeys; ++k)
          tile_a[k][tid] = p.key_bank[k] == 0
                               ? pool_f_bits(p, q, y, p.key_lane[k])
                               : pool_i(p, q, y, p.key_lane[k]);
        tile_r[tid] = y < C ? y : fill + (y - C);
        tile_l[tid] = y < C ? (y < fill) : ((y - C) < nv);
      }
      __syncthreads();
      const int lim = M - y0 < kB ? M - y0 : kB;
      for (int i = 0; i < lim && !done; ++i) {
        if (!tile_l[i]) continue;
        bool less = false, eq = true;
        for (int k = 0; k < p.nkeys && eq; ++k) {
          bool lt, e;
          if (p.key_bank[k] == 0) {
            const float a = __int_as_float(xa[k]);
            const float b = __int_as_float(tile_a[k][i]);
            lt = p.key_asc[k] ? (b < a) : (b > a);
            e = b == a;
          } else {
            const int a = xa[k], b = tile_a[k][i];
            lt = p.key_asc[k] ? (b < a) : (b > a);
            e = b == a;
          }
          less = lt;
          eq = e;
        }
        if (!less && eq) less = tile_r[i] < rank;
        if (less && ++cnt == kth) {
          tN = y0 + i < C ? -1 : y0 + i - C;
          done = true;
        }
      }
    }
    const int arr = is_carry ? -1 : x - C;
    evt = tN > arr ? tN : arr;
    emit = in && x < M && live && n - 1 < M && tN < kBig && evt < nv;
    keep = live && !emit;
    cause = C_LEN;
  } else if (p.kind == K_SESSION) {
    // a carried live entry's key's last activity over the carried entries
    const int kx = in && x < M ? pool_i(p, q, x, p.skey_lane) : 0;
    int last = kNeg;
    for (int y0 = 0; y0 < fill; y0 += kB) {
      const int y = y0 + tid;
      if (y < fill) {
        tile_a[0][tid] = q.ring_i[static_cast<size_t>(y) * p.I + p.skey_lane];
        tile_r[tid] = q.ring_ts[y];
      }
      __syncthreads();
      const int lim = fill - y0 < kB ? fill - y0 : kB;
      if (in && x < M && is_carry && live) {
        for (int i = 0; i < lim; ++i)
          if (tile_a[0][i] == kx && tile_r[i] > last) last = tile_r[i];
      }
      __syncthreads();
    }
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
  __shared__ int tile_k[kB];
  __shared__ int tile_t[kB];
  __shared__ unsigned char tile_ok[kB];
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
    } else {
      // the entry's key's last activity among the new ring's live slots
      const int kx = mine ? pool_i(p, q, x, p.skey_lane) : 0;
      int last = kNeg, same = 0;
      for (int y0 = 0; y0 < M; y0 += kB) {
        const int y = y0 + tid;
        unsigned char ok = 0;
        if (y < M && (q.flags[y] & F_KEEP)) {
          const int yp = q.bk[y / kB] + q.krank[y];
          if (yp < C) {
            ok = 1;
            tile_k[tid] = pool_i(p, q, y, p.skey_lane);
            tile_t[tid] = pool_ts(p, q, y);
          }
        }
        tile_ok[tid] = ok;
        __syncthreads();
        if (mine) {
          const int lim = M - y0 < kB ? M - y0 : kB;
          for (int i = 0; i < lim; ++i) {
            if (tile_ok[i] && tile_k[i] == kx) {
              ++same;
              if (tile_t[i] > last) last = tile_t[i];
            }
          }
        }
        __syncthreads();
      }
      // the twin's row max includes NEG unless every slot is this key's
      if (same >= C) {
        // every one of the C slots is a live slot of this key: no floor
      } else if (kNeg > last) {
        last = kNeg;
      }
      if (mine) cand = last;
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
}

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

}  // namespace

extern "C" {

// Bytes of device scratch one step needs (hdr: see dwin_step).
long long dwin_scratch_bytes(const int* hdr) {
  Prog p;
  read_prog(hdr, p);
  const size_t m2 = static_cast<size_t>(pool2(p));
  const size_t nb = (m2 + kB - 1) / kB;
  return static_cast<long long>(align16(m2) + 5 * align16(m2 * 4) +
                                3 * align16(nb * 4) + 64);
}

// One step.  hdr (host ints): kind id, C, T, F, I, window_ms, length,
// skey_lane, telemetry, hop_ms, cap, n sort keys, then (bank, lane, asc)
// per key.  ptrs (host array of device pointers, in ops/dwin.py
// KERNEL_PTRS order): the carry in (ring_f, ring_i, ring_ts, fill,
// exp_f, exp_i, exp_ts, exp_fill, telem; null where the kind has none),
// the chunk (ev_f, ev_i, ev_ts, ev_valid, now, directive), the carry out
// (the nine), the egress buffer, the scratch.  Returns the CUDA error of
// the launches (0 = ok).
int dwin_step(const int* hdr, const long long* ptrs, void* stream) {
  Prog p;
  read_prog(hdr, p);
  if (p.nkeys > kMaxKeys || p.T < 1 || p.C < 1 || p.F < 1 || p.I < 1)
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
  q.flags = s;
  s += align16(m2);
  int** planes[5] = {&q.evt, &q.cause, &q.krank, &q.erank, &q.xrank};
  for (int k = 0; k < 5; ++k) {
    *planes[k] = reinterpret_cast<int*>(s);
    s += align16(m2 * 4);
  }
  q.bk = reinterpret_cast<int*>(s);
  s += align16(nb * 4);
  q.be = reinterpret_cast<int*>(s);
  s += align16(nb * 4);
  q.bx = reinterpret_cast<int*>(s);
  s += align16(nb * 4);
  q.g = reinterpret_cast<int*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dwin_prep<<<1, kScanThreads, 0, st>>>(p, q);
  dwin_decide<<<static_cast<unsigned>(nb), kB, 0, st>>>(p, q);
  dwin_scan<<<1, kScanThreads, 0, st>>>(q, static_cast<int>(nb));
  dwin_scatter<<<static_cast<unsigned>(nb), kB, 0, st>>>(p, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
