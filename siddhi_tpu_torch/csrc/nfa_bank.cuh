// The pattern bank's thread instances' shared host and device code: the
// arguments, the shared-memory layout, the carry's loads and stores, the
// constant compares as intervals and the staging of a lane tile.  Included
// by csrc/nfa_step.cu (the thread instance, nfa_bank_thread_kernel) and
// csrc/nfa_bank_wide.cu (its widened instance); the design is in
// nfa_step.cu's notes.
#pragma once
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "nfa_step.cuh"

namespace {

constexpr int kBankMaxPcmp = 8;         // constant compares a pattern
constexpr int kMaskWords = 4;           // candidate bits a lane: TT <= 128
// the thread instance's lanes a tile: a warp is 32 consecutive lanes of one
// pattern, 8 patterns over one tile of 32 lanes a CTA (8: a warp is 32
// patterns of one lane, 32 patterns over 8 lanes)
constexpr int kBankLanes = 32;

struct BankArgs {
  const float* attrs;     // [A, P, T]
  const int* ts;          // [P, T]
  const int* strm;        // [P, T]
  const int* gates;       // [P, T], bit 31 = __valid
  const int* prog;
  const float* params;    // [CN, n_params]
  const int *st_in, *start_in, *enter_in, *seq_in, *armseq_in;
  const float* caps_in;
  const int *dropped_in, *armed_in;
  const int* dl_in;       // absent units: the deadlines
  int *st, *start, *enter, *seq, *armseq;
  float* caps;
  int *dropped, *armed;
  int* dl;
  int *count, *lmt, *lmk; // [CN, P]
  int prog_len, n_params, CN, P, T, K, TT, A, RC;
  int absent;             // the spec has absent units: a deadline column
  int n_cond;             // conditions: one candidate mask each
  int stride;             // words between two lane rows of a staged array
  int arr;                // words of one staged array (tile lanes x stride)
  int vec_in, vec_slots, vec_caps;  // 16-byte aligned: inputs (and T % 4
                                    // == 0), slot leaves, captures
  int inplace;            // every carry leaf out is its leaf in
  int groups;             // pattern groups a CTA walks over its tile
  int counts;             // the spec has count units: cnt_cur, cnt_prev
  int pad_within;         // one more `within` pass at the last event's ts
  const int *cc_in, *cp_in;
  int *cc, *cp;
};

// The thread instance's shared memory, in words from its base: the
// program; the CTA's patterns' constants [NG, n_params]; per constant
// compare each pattern's interval and the CTA's union (float4); the tile's
// candidate masks, one per condition; one tile of (3 + A) staged arrays,
// two when T is tiled;
// each thread's column of capture, enter and seq words, of deadlines
// when the spec has absent units, and of cnt_cur, cnt_prev, state and
// start words when it has count units (the count instance keeps a slot's
// every word in its column).  Every region starts on 16 bytes.
// ops/nfa.bank_geometry sizes this layout to pick the instance and
// passes the size in; the launch checks it against `end`.
struct BankLayout {
  int prm, pc, mask, tiles, col, end;
};

__host__ __device__ inline BankLayout bank_layout(const BankArgs& a) {
  const int NG = kThreads / kBankLanes * a.groups;
  BankLayout b;
  b.prm = (a.prog_len + 3) & ~3;
  b.pc = b.prm + ((NG * a.n_params + 3) & ~3);
  b.mask = b.pc + 4 * kBankMaxPcmp * (NG + 1);
  b.tiles = b.mask + ((a.n_cond * kBankLanes * kMaskWords + 3) & ~3);
  b.col = b.tiles + (a.T > a.TT ? 2 : 1) * (3 + a.A) * a.arr;
  b.end = b.col + kThreads * a.K * (a.RC + 2 + a.absent + 4 * a.counts);
  return b;
}

// K <= KM slot words (one carry leaf of a lane) to and from registers
template <int KM>
__device__ __forceinline__ void load_words(int (&r)[KM], const int* src,
                                           int K, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < KM / 4; ++q) {
      if (4 * q >= K) break;
      const int4 x = reinterpret_cast<const int4*>(src)[q];
      r[4 * q] = x.x;
      r[4 * q + 1] = x.y;
      r[4 * q + 2] = x.z;
      r[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < KM; ++s) {
      if (s >= K) break;
      r[s] = src[s];
    }
  }
}

template <int KM>
__device__ __forceinline__ void store_words(const int (&r)[KM], int* dst,
                                            int K, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < KM / 4; ++q) {
      if (4 * q >= K) break;
      reinterpret_cast<int4*>(dst)[q] =
          make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < KM; ++s) {
      if (s >= K) break;
      dst[s] = r[s];
    }
  }
}

// n words of a lane's carry into this thread's shared column (cp.async:
// in by the next wait on the thread's copies) and out of it
__device__ __forceinline__ void load_col(float* col, const void* src,
                                         int n) {
  const float* f = static_cast<const float*>(src);
  for (int q = 0; q < n; ++q) cp_async4(col + q * kThreads, f + q);
}

__device__ __forceinline__ void store_col(const float* col, void* dst, int n,
                                          bool vec) {
  float* f = static_cast<float*>(dst);
  if (vec) {
    for (int q = 0; q < n / 4; ++q)
      reinterpret_cast<float4*>(f)[q] = make_float4(
          col[(4 * q) * kThreads], col[(4 * q + 1) * kThreads],
          col[(4 * q + 2) * kThreads], col[(4 * q + 3) * kThreads]);
  } else {
    for (int q = 0; q < n; ++q) f[q] = col[q * kThreads];
  }
}

// `x <op> c` as x in [lo, hi], the answer inverted when inv (op `!=`):
// exact on IEEE float32 (a NaN x is in no interval; a NaN c gives the
// empty one, so only `!=` holds)
__device__ __forceinline__ void pcmp_bounds(int op, float c, float& lo,
                                            float& hi, bool& inv) {
  const float inf = __int_as_float(0x7f800000);
  lo = -inf;
  hi = inf;
  inv = false;
  switch (op) {
    case 0:                             // <
      if (c == -inf) {
        lo = inf;
        hi = -inf;
      } else {
        hi = nextafterf(c, -inf);
      }
      break;
    case 1: hi = c; break;              // <=
    case 2:                             // >
      if (c == inf) {
        lo = inf;
        hi = -inf;
      } else {
        lo = nextafterf(c, inf);
      }
      break;
    case 3: lo = c; break;              // >=
    case 4: lo = hi = c; break;         // ==
    default:                            // !=
      lo = hi = c;
      inv = true;
  }
}

// Stage events [t0, t0 + TT) of the tile's LT lanes: array x (ts, stream,
// gate word, attribute lanes) of lane l at buf + x * arr + l * stride, a
// run of TT words per lane row; indices by shifts (TT, LT powers of two).
template <int LT>
__device__ __forceinline__ void bank_stage(int* buf, int t0,
                                           const BankArgs& a, int p0) {
  const int NA = 3 + a.A;
  const long long PT = static_cast<long long>(a.P) * a.T;
  const int* at = reinterpret_cast<const int*>(a.attrs);
  const int vw = a.vec_in ? 4 : 1;      // words a copy
  const int sh = __ffs(a.TT / vw) - 1;  // log2 of copies per row
  const int n = (NA * LT) << sh;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int c = idx & ((1 << sh) - 1);
    const int r = idx >> sh;
    const int l = r & (LT - 1);
    const int x = r / LT;
    const int p = p0 + l;
    const int t = t0 + c * vw;
    if (p >= a.P || t >= a.T) continue;
    const long long e = static_cast<long long>(p) * a.T + t;
    const int* src = x == 0 ? a.ts + e
                   : x == 1 ? a.strm + e
                   : x == 2 ? a.gates + e
                            : at + (x - 3) * PT + e;
    int* dst = buf + x * a.arr + l * a.stride + c * vw;
    if (a.vec_in) cp_async16(dst, src);
    else cp_async4(dst, src);
  }
}

// A thread instance's CTA (nfa_step.cu's notes, design (2) and (3)): its
// NG patterns' constant compares as intervals and their union, a staged
// tile's candidate events, and a pattern's gate word and live events.
// spc: per compare q each pattern's entry (q * NG + n) and the CTA's
// union (kBankMaxPcmp * NG + q): lo, hi, attribute offset, bits; smask:
// per condition and lane the tile's candidate bits.
template <int LT>
struct BankCta {
  const BankArgs& a;
  float4* spc;
  int* smask;
  int NG, npc, l;
  static constexpr int mstride = LT * kMaskWords;  // words a condition

  // each pattern's constant compares as intervals (a pattern past CN:
  // the empty one), with the attribute lane's offset in a staged tile and
  // the condition's bit (bit 31: inverted)
  __device__ __forceinline__ void intervals(const Prog& g, const float* sprm,
                                            int pat0) {
    for (int i = threadIdx.x; i < npc * NG; i += kThreads) {
      const int q = i / NG, n = i - q * NG;
      int c0 = 0;
      while (g.pcmp_start[c0 + 1] <= q) ++c0;
      const int* c = g.pcmp + 3 * q;
      float lo = __int_as_float(0x7f800000), hi = -lo;
      bool iv = false;
      if (pat0 + n < a.CN)
        pcmp_bounds(c[2], sprm[n * a.n_params + c[1]], lo, hi, iv);
      spc[i] = make_float4(
          lo, hi, __int_as_float((3 + c[0]) * a.arr),
          __uint_as_float((1u << c0) | (static_cast<unsigned>(iv) << 31)));
    }
  }

  // the CTA's union of each compare's intervals (after a barrier over
  // intervals): an event outside it fails the compare for every pattern
  // of the CTA (`!=` compares are left out: bits 0)
  __device__ __forceinline__ void join() {
    const int tid = threadIdx.x;
    if (tid < npc) {
      float4 u = spc[tid * NG];
      const unsigned bits = __float_as_uint(u.w);
      for (int n = 1; n < NG; ++n) {
        const float4 e = spc[tid * NG + n];
        u.x = fminf(u.x, e.x);
        u.y = fmaxf(u.y, e.y);
      }
      u.w = __uint_as_float(bits >> 31 ? 0u : bits);
      spc[kBankMaxPcmp * NG + tid] = u;
    }
  }

  // the candidates of condition i in the staged tile `cur` (tn events of
  // TT = 1 << tt_sh a lane row, the masks cleared): valid events whose
  // bit i the CTA's union of constant intervals leaves; an event that is
  // no candidate of a condition fails it for every pattern of the CTA
  __device__ __forceinline__ void mark(unsigned cmask, const int* cur,
                                       int tn, int p0, int tt_sh) {
    for (int idx = threadIdx.x; idx < (LT << tt_sh); idx += kThreads) {
      const int ll = idx >> tt_sh, j = idx & (a.TT - 1);
      if (j >= tn || p0 + ll >= a.P) continue;
      const int* rw = cur + ll * a.stride;
      unsigned gw = static_cast<unsigned>(rw[2 * a.arr + j]);
      if (!(gw & kValidBit) || !(gw & cmask)) continue;
      for (int q = 0; q < npc; ++q) {
        const float4 e = spc[kBankMaxPcmp * NG + q];
        const float x = __int_as_float(rw[__float_as_int(e.z) + j]);
        if (!(x >= e.x && x <= e.y)) gw &= ~__float_as_uint(e.w);
      }
      for (unsigned b = gw & cmask; b; b &= b - 1)
        atomicOr(reinterpret_cast<unsigned*>(smask) +
                     (__ffs(b) - 1) * mstride + ll * kMaskWords + (j >> 5),
                 1u << (j & 31));
    }
  }

  // pattern n's gate word of event j of the staged row: condition bits
  // cleared where one of its constant compares fails
  __device__ __forceinline__ unsigned gate(const int* row, int j,
                                           int n) const {
    unsigned gw = static_cast<unsigned>(row[2 * a.arr + j]);
    for (int q = 0; q < npc; ++q) {
      const float4 e = spc[q * NG + n];
      const float x = __int_as_float(row[__float_as_int(e.z) + j]);
      const unsigned bits = __float_as_uint(e.w);
      if ((x >= e.x && x <= e.y) == static_cast<bool>(bits >> 31))
        gw &= ~(bits & ~kValidBit);
    }
    return gw;
  }

  // word wd's events from event `from` on that pass one of the conditions
  // in `need` for pattern n: its candidates of those conditions, then the
  // pattern's own constant compares
  __device__ __forceinline__ unsigned live_from(const int* row, int wd,
                                                int from, unsigned need,
                                                int n) const {
    const int jb = wd << 5;
    if (from - jb >= 32) return 0u;
    unsigned c = 0;
    for (unsigned b = need; b; b &= b - 1)
      c |= static_cast<unsigned>(
          smask[(__ffs(b) - 1) * mstride + l * kMaskWords + wd]);
    c &= ~0u << (from - jb);
    unsigned al = 0;
    for (unsigned m = c; m; m &= m - 1) {
      const int j = jb + __ffs(m) - 1;
      if (gate(row, j, n) & need) al |= 1u << (j - jb);
    }
    return al;
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One launch of a thread instance: ceil(P / kBankLanes) lane tiles by
// the CTAs' pattern groups, smem bytes of dynamic shared memory.
template <class Args>
int launch_bank(void (*kern)(Args), const Args& a, size_t smem,
                cudaStream_t s) {
  constexpr int NPC = kThreads / kBankLanes;
  const long long gx = (a.P + kBankLanes - 1) / kBankLanes;
  const long long gy = (a.CN + NPC * a.groups - 1) / (NPC * a.groups);
  if (gx > INT_MAX || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A thread instance's arguments from its C entry's (csrc/nfa_step.cu
// nfa_bank_thread); false for a geometry or a carry it does not take.
inline bool make_thread_args(BankArgs& a, const float* attrs, const int* ts,
                             const int* strm, const int* gates,
                             const int* prog, int prog_len,
                             const float* params, int n_params,
                             const CarryPtrs& in, const CarryOut& out,
                             int* count, int* lmt, int* lmk, int CN, int P,
                             int T, int K, int TT, int A, int RC, int groups,
                             int n_cond, int pad_within) {
  if (K <= 0 || K > 16 || T < 0 || TT < 4 || TT > 32 * kMaskWords ||
      (TT & (TT - 1)) || A < 0 || groups < 1 || (groups > 1 && T > TT) ||
      RC <= 0 || prog_len < kHeader || n_params < 0 || n_cond < 1 ||
      n_cond > 31 || missing_leaves(in, out) ||
      ((in.dl != nullptr) != (out.dl != nullptr)) ||
      ((in.cc != nullptr) != (out.cc != nullptr)) ||
      ((in.cc != nullptr) != (in.cp != nullptr)) ||
      ((in.cp != nullptr) != (out.cp != nullptr)))
    return false;
  a = BankArgs{attrs, ts, strm, gates, prog, params, in.st, in.start,
               in.enter, in.seq, in.armseq, in.caps, in.dropped, in.armed,
               in.dl, out.st, out.start, out.enter, out.seq, out.armseq,
               out.caps, out.dropped, out.armed, out.dl, count, lmt, lmk};
  a.prog_len = prog_len;
  a.n_params = n_params;
  a.CN = CN;
  a.P = P;
  a.T = T;
  a.K = K;
  a.TT = TT;
  a.A = A;
  a.RC = RC;
  a.absent = in.dl != nullptr;
  a.counts = in.cc != nullptr;
  a.pad_within = pad_within != 0;
  a.cc_in = in.cc;
  a.cp_in = in.cp;
  a.cc = out.cc;
  a.cp = out.cp;
  a.n_cond = n_cond;
  a.groups = groups;
  // a stride of 4 (mod 8) words: a warp's 16-byte loads of 32 lane rows
  // fall in distinct bank groups
  a.stride = ((TT >> 2) & 1) ? TT : TT + 4;
  a.arr = kBankLanes * a.stride;
  a.vec_in = (T & 3) == 0 && aligned16(attrs) && aligned16(ts) &&
             aligned16(strm) && aligned16(gates);
  a.vec_slots = (K & 3) == 0 && aligned16(in.st) && aligned16(in.start) &&
                aligned16(in.enter) && aligned16(in.seq) &&
                aligned16(out.st) && aligned16(out.start) &&
                aligned16(out.enter) && aligned16(out.seq) &&
                (!a.absent || (aligned16(in.dl) && aligned16(out.dl))) &&
                (!a.counts || (aligned16(in.cc) && aligned16(out.cc) &&
                              aligned16(in.cp) && aligned16(out.cp)));
  a.vec_caps = ((K * RC) & 3) == 0 && aligned16(in.caps) &&
               aligned16(out.caps);
  a.inplace = out.st == in.st && out.start == in.start &&
              out.enter == in.enter && out.seq == in.seq &&
              out.armseq == in.armseq && out.caps == in.caps &&
              out.dropped == in.dropped && out.armed == in.armed &&
              out.dl == in.dl && out.cc == in.cc && out.cp == in.cp;
  return true;
}

}  // namespace
