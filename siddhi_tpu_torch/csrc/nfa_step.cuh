// The NFA block step's device code shared by csrc/nfa_step.cu (the step,
// the compaction, the pattern bank) and csrc/nfa_gang.cu (the
// cross-tenant gang): the program table, the slot storage, the step body
// (step_body) and the compaction body (compact_body), the step's
// geometry (plan_step) and the C entries' carry pointers.  The design
// and the contract are in nfa_step.cu's notes.
#pragma once
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// The build variant (ops/_kernels.VARIANTS): NFA_PROG=1 builds the step
// instances that run condition programs (nfa_prog, nfa_wide_prog,
// nfa_gang_prog); the default build's instances refuse a program and
// compile its code away, so a spec without one keeps its registers.
#ifndef NFA_PROG
#define NFA_PROG 0
#endif

namespace {

constexpr bool kProg = NFA_PROG != 0;


constexpr int kThreads = 256;
constexpr int kTileBytes = 32 * 1024;   // both tile buffers together: at
                                        // K = 8 five CTAs fit an SM, so
                                        // P = 16384 runs in one wave
constexpr int kMaxTileEvents = 128;
constexpr int kHeader = 24;             // S, R, C, has_within, within_ms,
                                        // arm_once, n_cond, n_cmp, n_pcmp,
                                        // has_count, has_absent, occ_hi,
                                        // then the widened instance's:
                                        // wide, is_sequence, is_every,
                                        // every_group_end,
                                        // tail_every_start, eps_start,
                                        // lead_absent, dead_start,
                                        // telemetry, has_logical, n_mid,
                                        // n_ccmp
constexpr unsigned kValidBit = 0x80000000u;
// the step's flags (ops/nfa.kernel_flags): the widened instance, and one
// more `within` pass after the last event at that event's ts (the invalid
// rows padding the plain step's block to a multiple of its B)
constexpr int kFlagWide = 1;
constexpr int kFlagPadWithin = 2;
constexpr unsigned kFull = 0xffffffffu;

// A unit's words in the program (ops/nfa.kernel_prog): kind, stream,
// condition, capture row, count min and max, absent wait, where a slot
// advancing out of it lands (>= S: the chain completes) and whether that
// landing skipped a min-0 count (live0), and the count units whose
// forwarded count keeps appending while a slot waits here (-1: none).
constexpr int kUnit = 11;
enum UnitWord {
  uKind, uStream, uCond, uRow, uMin, uMax, uWait, uLand, uLive0, uApp0, uApp1
};
enum UnitKind { kSimple = 0, kCount = 1, kAbsent = 2, kLogical = 3 };
// A unit's words in the widened table: a logical unit's side B (stream,
// condition, capture row) and whether it is `and`.
constexpr int kUnitB = 4;
enum UnitBWord { bStream, bCond, bRow, bAnd };
// mid-chain `every` groups the widened instance holds a clone rank for
// (ops/nfa.MAX_MID_EVERY), and its slots a thread in the wide ring
constexpr int kMaxMid = 4;
constexpr int kWideMaxSpt = 32;
// a slot's state while an event is stepped: it completed a match in the
// unit loop (no state of the class is this value)
constexpr int kMatched = INT_MIN;

struct Prog {
  int S, R, C, has_within, within, arm_once, n_cond, n_cmp, n_pcmp;
  int has_count, has_absent;
  int occ_hi;             // arming waits while a slot sits at 0..occ_hi
  const int* units;       // S x kUnit
  const int* row_src;     // R*C: attr index, -1 -> 0.0f, -2 -> 1.0f
  const int* rowx_start;  // R + 1: each count row's layout in rowx
  const int* rowx;        // per count row: n_first, n_last, n lane,
                          // n_idx, n_lastk, L, n_idx x (k, start, len),
                          // n_lastk bank starts, L last-bank lanes
  const int* cmp_start;   // n_cond + 1
  const int* cmp;         // n_cmp x (attr, row, lane, op)
  const int* pcmp_start;  // n_cond + 1
  const int* pcmp;        // n_pcmp x (attr, param, op)
  // the widened instance's (ops/nfa.kernel_prog)
  int is_seq, is_every, every_end, tail_every, eps, lead_absent;
  int dead_start, telem, has_logical, n_mid;
  const int* unitsb;      // S x kUnitB
  const int* mid;         // n_mid x (g0, g1), ascending g0
  const int* ccmp_start;  // n_cond + 1
  const int* ccmp;        // n_ccmp x (row, lane, op, constant's bits)
  // the condition programs (plan/nfa_program.py): n_cond + 1 starts, then
  // np words, then the constants' bits; and the pattern's constants (the
  // bank's group instance, else null)
  const int* pstart;
  int np;
  const float* prm;
};

__device__ __forceinline__ Prog parse(const int* p) {
  Prog g;
  g.S = p[0];
  g.R = p[1];
  g.C = p[2];
  g.has_within = p[3];
  g.within = p[4];
  g.arm_once = p[5];
  g.n_cond = p[6];
  g.n_cmp = p[7];
  g.n_pcmp = p[8];
  g.has_count = p[9];
  g.has_absent = p[10];
  g.occ_hi = p[11];
  g.is_seq = p[13];
  g.is_every = p[14];
  g.every_end = p[15];
  g.tail_every = p[16];
  g.eps = p[17];
  g.lead_absent = p[18];
  g.dead_start = p[19];
  g.telem = p[20];
  g.has_logical = p[21];
  g.n_mid = p[22];
  g.units = p + kHeader;
  g.row_src = g.units + kUnit * g.S;
  g.rowx_start = g.row_src + g.R * g.C;
  g.rowx = g.rowx_start + g.R + 1;
  g.cmp_start = g.rowx + g.rowx_start[g.R];
  g.cmp = g.cmp_start + g.n_cond + 1;
  g.pcmp_start = g.cmp + 4 * g.n_cmp;
  g.pcmp = g.pcmp_start + g.n_cond + 1;
  g.unitsb = g.pcmp + 3 * g.n_pcmp;
  g.mid = g.unitsb + kUnitB * g.S;
  g.ccmp_start = g.mid + 2 * g.n_mid;
  g.ccmp = g.ccmp_start + g.n_cond + 1;
  g.pstart = g.ccmp + 4 * g.ccmp_start[g.n_cond];
  g.np = g.pstart[g.n_cond];
  g.prm = nullptr;
  return g;
}

__device__ __forceinline__ const int* unit(const Prog& g, int j) {
  return g.units + kUnit * j;
}

__device__ __forceinline__ const int* unit_b(const Prog& g, int j) {
  return g.unitsb + kUnitB * j;
}

// int32 timestamp offsets add and subtract with two's-complement wrap
__device__ __forceinline__ int add32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int sub32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// What arming does at unit 0 (ops/nfa.py _one_event_step, arming): the
// armed slot's state, count words and whether it completes at once.
struct Arm {
  int state, cnt_cur, cnt_prev;
  bool match, deadline;   // deadline: the state is an absent unit
};

__device__ __forceinline__ Arm arm_of(const Prog& g) {
  const int* u0 = unit(g, 0);
  Arm r{0, 0, -1, false, false};
  if (u0[uKind] == kCount && u0[uMin] >= 2) {
    r.cnt_cur = 1;                      // accumulates at unit 0
    return r;
  }
  const int t = u0[uLand];
  if (t >= g.S) {
    r.match = true;
    return r;
  }
  r.state = t;
  r.cnt_prev = u0[uKind] == kCount ? (u0[uMax] == 1 ? -1 : 1)
                                   : (u0[uLive0] ? 0 : -1);
  r.deadline = unit(g, t)[uKind] == kAbsent;
  return r;
}

struct StepArgs {
  const float* attrs;     // [A, P, T]
  const int* ts;          // [P, T]
  const int* strm;        // [P, T]
  const int* gates;       // [P, T], bit 31 = __valid
  const int* prog;
  const int *st_in, *start_in, *enter_in, *seq_in, *armseq_in;
  const float* caps_in;
  const int *dropped_in, *armed_in;
  const int *cc_in, *cp_in, *dl_in;     // cnt_cur, cnt_prev, deadline
  int *st, *start, *enter, *seq, *armseq;
  float* caps;
  int *dropped, *armed;
  int *cc, *cp, *dl;
  int* rows;              // [n_cta, seg, 4 + RC + 2]
  int* lane_count;        // [P]
  int* fill;              // [n_cta]
  int* dl_min;            // [n_cta]: the earliest absent deadline
  const float* params;    // bank: [CN, n_params]
  int *count, *lmt, *lmk; // bank: [CN, P]
  // the widened instance's leaves (null where the spec has none):
  // lmask [P, K], seq_froze [P], telem [P, tel_w]
  const int *lm_in, *sf_in, *tel_in;
  int *lm, *sf, *tel;
  int prog_len, P, T, K, G, spt, L, TT, seg, A, RC, CN, n_params;
  int wide;               // the widened instance (kFlagWide)
  int pad_within;         // one more `within` pass at the last ts
  int tel_w;              // telem's words a lane (3S + 1), 0: none
};

__device__ __forceinline__ bool compare(int op, float x, float y) {
  switch (op) {
    case 0: return x < y;
    case 1: return x <= y;
    case 2: return x > y;
    case 3: return x >= y;
    case 4: return x == y;
    default: return x != y;
  }
}

// ------------------------------------------------------------ programs

// A condition program's operations (plan/nfa_program.py OP_*): a word is
// the op in its low 8 bits and its argument above them (an operand's
// index; pCmp: the compare's code).
enum ProgOp {
  pEv = 0, pCap, pPrm, pK, pAdd, pSub, pMul, pDiv, pMod, pAbs, pFloor,
  pCeil, pSqrt, pRound, pMax, pMin, pCmp, pAnd, pOr, pNot
};
constexpr int kProgDepth = 8;           // plan/nfa_program.MAX_DEPTH

// Program words [w, w + n) over the event's lanes (at, stride LT), one
// slot's capture words (cb, stride cs; null: a fresh chain's zeros), the
// pattern's constants (prm) and the program's constants (kc, float32
// bits), on a stack of float32 registers: a condition is 1.0f or 0.0f;
// each arithmetic op is one IEEE operation rounded to nearest (the
// intrinsics keep that whatever --fmad says), as the torch program
// computes it; max and min give NaN for a NaN operand, as torch's do;
// round is half to even (rintf), as torch.round.  Not inlined: the
// register file a step instance needs stays its own.
__device__ __noinline__ bool eval_prog(const int* w, int n, const int* kc,
                                       const float* at, int LT,
                                       const float* cb, int cs,
                                       const float* prm) {
  float r[kProgDepth];
  int sp = 0;
  for (int q = 0; q < n; ++q) {
    const int op = w[q] & 0xff;
    const int x = w[q] >> 8;
    switch (op) {
      case pEv: r[sp++] = at[x * LT]; continue;
      case pCap: r[sp++] = cb ? cb[x * cs] : 0.0f; continue;
      case pPrm: r[sp++] = prm[x]; continue;
      case pK: r[sp++] = __int_as_float(kc[x]); continue;
      case pAbs: r[sp - 1] = fabsf(r[sp - 1]); continue;
      case pFloor: r[sp - 1] = floorf(r[sp - 1]); continue;
      case pCeil: r[sp - 1] = ceilf(r[sp - 1]); continue;
      case pSqrt: r[sp - 1] = __fsqrt_rn(r[sp - 1]); continue;
      case pRound: r[sp - 1] = rintf(r[sp - 1]); continue;
      case pNot: r[sp - 1] = r[sp - 1] != 0.0f ? 0.0f : 1.0f; continue;
      default: break;
    }
    const float b = r[--sp];
    const float a = r[sp - 1];
    float v;
    switch (op) {
      case pAdd: v = __fadd_rn(a, b); break;
      case pSub: v = __fsub_rn(a, b); break;
      case pMul: v = __fmul_rn(a, b); break;
      case pDiv: v = __fdiv_rn(a, b); break;
      case pMod: v = fmodf(a, b); break;
      case pMax: v = (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
        break;
      case pMin: v = (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
        break;
      case pCmp: v = compare(x, a, b) ? 1.0f : 0.0f; break;
      case pAnd: v = (a != 0.0f && b != 0.0f) ? 1.0f : 0.0f; break;
      default: v = (a != 0.0f || b != 0.0f) ? 1.0f : 0.0f;   // pOr
    }
    r[sp - 1] = v;
  }
  return r[0] != 0.0f;
}

// Condition i's program, if it has one, against capture words cb (stride
// cs; null: zeros).
__device__ __forceinline__ bool prog_ok(const Prog& g, int i,
                                        const float* at, int LT,
                                        const float* cb, int cs) {
  const int q0 = g.pstart[i], q1 = g.pstart[i + 1];
  if (q0 == q1) return true;
  const int* words = g.pstart + g.n_cond + 1;
  return eval_prog(words + q0, q1 - q0, words + g.np, at, LT, cb, cs, g.prm);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage events [t0, t0 + TT) of the CTA's L lanes: per lane row a run of
// TT consecutive words, consecutive threads on consecutive words.
__device__ __forceinline__ void load_tile(int* buf, int t0, const StepArgs& a,
                                          int p0) {
  const int LT = a.L * a.TT;
  const long long PT = static_cast<long long>(a.P) * a.T;
  for (int idx = threadIdx.x; idx < LT; idx += kThreads) {
    const int l = idx / a.TT;
    const int t = t0 + (idx - l * a.TT);
    const int p = p0 + l;
    if (p >= a.P || t >= a.T) continue;
    const long long e = static_cast<long long>(p) * a.T + t;
    cp_async4(buf + idx, a.ts + e);
    cp_async4(buf + LT + idx, a.strm + e);
    cp_async4(buf + 2 * LT + idx, a.gates + e);
    for (int x = 0; x < a.A; ++x)
      cp_async4(buf + (3 + x) * LT + idx, a.attrs + x * PT + e);
  }
}

// A per-slot array of the widened instance's event in registers (the
// slot loops unrolled) or local memory (the wide ring)
template <int N>
struct RegArr {
  int v[N];
  __device__ __forceinline__ int& operator[](int s) { return v[s]; }
};

// Slot storage.  SPT > 0: this thread's SPT slots in registers (state,
// start, enter, seq, and the count and deadline words), their capture
// rows in its own column of shared memory (stride kThreads, so a warp's
// accesses never share a bank).
template <int SPT>
struct Slots {
  int st_[SPT], start_[SPT], enter_[SPT], seq_[SPT];
  int cc_[SPT], cp_[SPT], dl_[SPT], lm_[SPT];
  float* cap;
  int RC;
  __device__ __forceinline__ int& st(int s) { return st_[s]; }
  __device__ __forceinline__ int& start(int s) { return start_[s]; }
  __device__ __forceinline__ int& enter(int s) { return enter_[s]; }
  __device__ __forceinline__ int& seq(int s) { return seq_[s]; }
  __device__ __forceinline__ int& cc(int s) { return cc_[s]; }
  __device__ __forceinline__ int& cp(int s) { return cp_[s]; }
  __device__ __forceinline__ int& dl(int s) { return dl_[s]; }
  __device__ __forceinline__ int& lm(int s) { return lm_[s]; }
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[(s * RC + i) * kThreads];
  }
  // slot s of the thread d places on in the same lane
  __device__ __forceinline__ float& cx(int d, int s, int i) {
    return cap[(s * RC + i) * kThreads + d];
  }
  // words between two capture lanes of a slot
  __device__ __forceinline__ int cs() const { return kThreads; }
  // a per-slot array of the widened instance's event (Wide::arr)
  using Arr = RegArr<SPT>;
};

// The wide-ring instance: the slots live in the new carry, slot s of this
// thread at k = gl + s*G (cc, cp, dl: only where the spec has the leaf).
template <>
struct Slots<0> {
  int *st_, *start_, *enter_, *seq_, *cc_, *cp_, *dl_, *lm_;
  float* cap;
  int G, RC;
  __device__ __forceinline__ int& st(int s) { return st_[s * G]; }
  __device__ __forceinline__ int& start(int s) { return start_[s * G]; }
  __device__ __forceinline__ int& enter(int s) { return enter_[s * G]; }
  __device__ __forceinline__ int& seq(int s) { return seq_[s * G]; }
  __device__ __forceinline__ int& cc(int s) { return cc_[s * G]; }
  __device__ __forceinline__ int& cp(int s) { return cp_[s * G]; }
  __device__ __forceinline__ int& dl(int s) { return dl_[s * G]; }
  __device__ __forceinline__ int& lm(int s) { return lm_[s * G]; }
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[static_cast<long long>(s) * G * RC + i];
  }
  __device__ __forceinline__ float& cx(int d, int s, int i) {
    return cap[(static_cast<long long>(s) * G + d) * RC + i];
  }
  __device__ __forceinline__ int cs() const { return 1; }
  using Arr = RegArr<kWideMaxSpt>;
};

// an int32 word of a thread's shared-memory column, which holds float
// bits (one type for every access to the column)
struct ColInt {
  float& f;
  __device__ __forceinline__ operator int() const { return __float_as_int(f); }
  __device__ __forceinline__ const ColInt& operator=(int v) const {
    f = __int_as_float(v);
    return *this;
  }
  __device__ __forceinline__ const ColInt& operator=(const ColInt& o) const {
    f = o.f;
    return *this;
  }
};

// A per-slot array of a thread's column: row x of its words, slot s at
// x + s (csrc/nfa_bank_wide.cu's rows of K words)
struct ColArr {
  float* p;
  __device__ __forceinline__ ColInt operator[](int s) const {
    return ColInt{p[s * kThreads]};
  }
};

// The bank's widened thread instance (csrc/nfa_bank_wide.cu): one
// thread's K slots, every word of a slot in the thread's shared-memory
// column (stride kThreads, so a warp's accesses never share a bank): the
// captures, slot s's at rows s * RC.., then rows of K words at the given
// offsets (in words from the column's base), and the event's per-slot
// arrays (Wide::arr) from row xa on.
struct ColSlots {
  float* cap;
  int RC, K;
  int xst, xstart, xenter, xseq, xcc, xcp, xdl, xlm, xa;
  __device__ __forceinline__ ColInt w(int x, int s) {
    return ColInt{cap[(x + s) * kThreads]};
  }
  __device__ __forceinline__ ColInt st(int s) { return w(xst, s); }
  __device__ __forceinline__ ColInt start(int s) { return w(xstart, s); }
  __device__ __forceinline__ ColInt enter(int s) { return w(xenter, s); }
  __device__ __forceinline__ ColInt seq(int s) { return w(xseq, s); }
  __device__ __forceinline__ ColInt cc(int s) { return w(xcc, s); }
  __device__ __forceinline__ ColInt cp(int s) { return w(xcp, s); }
  __device__ __forceinline__ ColInt dl(int s) { return w(xdl, s); }
  __device__ __forceinline__ ColInt lm(int s) { return w(xlm, s); }
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[(s * RC + i) * kThreads];
  }
  // one thread holds the lane: slot s2 of "thread" d is its own slot s2
  __device__ __forceinline__ float& cx(int, int s2, int i) {
    return c(s2, i);
  }
  __device__ __forceinline__ int cs() const { return kThreads; }
  using Arr = ColArr;
};

// condition i of the event at `at` against slot s's captures
template <class SL>
__device__ __forceinline__ bool cond_ok(const Prog& g, int i, unsigned gw,
                                        SL& sl, int s, const float* at,
                                        int LT) {
  if (!((gw >> i) & 1u)) return false;
  for (int q = g.cmp_start[i]; q < g.cmp_start[i + 1]; ++q) {
    const int* c = g.cmp + 4 * q;
    if (!compare(c[3], at[c[0] * LT], sl.c(s, c[1] * g.C + c[2])))
      return false;
  }
  return !g.np || prog_ok(g, i, at, LT, &sl.c(s, 0), sl.cs());
}

// the event's gate word with bit i cleared where one of condition i's
// `event lane <op> pattern constant` compares fails
__device__ __forceinline__ unsigned param_gates(const Prog& g, unsigned gw,
                                                const float* at, int LT,
                                                const float* prm) {
  for (int i = 0; i < g.n_cond; ++i) {
    for (int q = g.pcmp_start[i]; q < g.pcmp_start[i + 1]; ++q) {
      const int* c = g.pcmp + 3 * q;
      if (!compare(c[2], at[c[0] * LT], prm[c[1]])) {
        gw &= ~(1u << i);
        break;
      }
    }
  }
  return gw;
}

// what the event writes into lane c of capture row `row`
__device__ __forceinline__ float event_lane(const Prog& g, int row, int c,
                                            const float* at, int LT) {
  const int src = g.row_src[row * g.C + c];
  return src >= 0 ? at[src * LT] : (src == -2 ? 1.0f : 0.0f);
}

// the event's lanes into capture row `row` of slot s
template <class SL>
__device__ __forceinline__ void write_row(const Prog& g, int row, SL& sl,
                                          int s, const float* at, int LT) {
  for (int c = 0; c < g.C; ++c)
    sl.c(s, row * g.C + c) = event_lane(g, row, c, at, LT);
}

// A kleene count's append of the event to its row (ops/nfa.py
// _StepState.write_count): the e[last-j] banks shift behind the last bank,
// deepest first, before the new value lands; the first bank on the first
// append; the last bank; the e[k] bank whose k + 1 is the new count n;
// the __n lane = n.
template <class SL>
__device__ __forceinline__ void write_count(const Prog& g, int row, SL& sl,
                                            int s, const float* at, int LT,
                                            bool first, int n) {
  const int* x = g.rowx + g.rowx_start[row];
  const int nf = x[0], nl = x[1], nlane = x[2], ni = x[3], nm = x[4];
  const int L = x[5];
  const int* ib = x + 6;
  const int* mb = ib + 3 * ni;
  const int* src = mb + nm;
  const int base = row * g.C;
  for (int j = nm; j >= 1; --j) {
    const int from = j == 1 ? -1 : mb[j - 2];
    for (int i = 0; i < L; ++i)
      sl.c(s, base + mb[j - 1] + i) =
          sl.c(s, base + (from < 0 ? src[i] : from + i));
  }
  if (first)
    for (int c = 0; c < nf; ++c)
      sl.c(s, base + c) = event_lane(g, row, c, at, LT);
  for (int c = nf; c < nf + nl; ++c)
    if (c != nlane) sl.c(s, base + c) = event_lane(g, row, c, at, LT);
  for (int q = 0; q < ni; ++q) {
    if (n != ib[3 * q] + 1) continue;
    for (int c = ib[3 * q + 1]; c < ib[3 * q + 1] + ib[3 * q + 2]; ++c)
      sl.c(s, base + c) = event_lane(g, row, c, at, LT);
  }
  if (nlane >= 0) sl.c(s, base + nlane) = static_cast<float>(n);
}

// Slot s, waiting at unit j with state `st`, advances at time `base` (the
// event's ts, or its deadline): land where unit j says, entering at base,
// with the count words reset (cnt_prev: the forwarded count, dead at max,
// or 0 past a skipped min-0 count), and a deadline when the new unit is
// absent.  True: the chain completes (state -1).
template <class SL>
__device__ __forceinline__ bool land(const Prog& g, SL& sl, int s, int& st,
                                     int j, int base, bool fwd, int fwd_cnt,
                                     bool dead) {
  const int* u = unit(g, j);
  const int t = u[uLand];
  if (t >= g.S) {
    st = -1;
    return true;
  }
  st = t;
  sl.enter(s) = base;
  if (g.has_count) {
    sl.cp(s) = fwd ? (dead ? -1 : fwd_cnt) : (u[uLive0] ? 0 : -1);
    sl.cc(s) = 0;
  }
  if (g.has_absent && unit(g, t)[uKind] == kAbsent)
    sl.dl(s) = add32(base, unit(g, t)[uWait]);
  return false;
}

// Slot s, waiting at unit t with a forwarded count, appends the event to
// count unit j's row when j's condition held (ok); it freezes at max.
template <class SL>
__device__ __forceinline__ void live_append(const Prog& g, SL& sl, int s,
                                            int j, bool ok, const float* at,
                                            int LT) {
  if (j < 0 || !ok) return;
  const int* w = unit(g, j);
  const int cp = sl.cp(s);
  if (cp < 0 || cp >= w[uMax]) return;
  if (w[uRow] >= 0) write_count(g, w[uRow], sl, s, at, LT, cp == 0, cp + 1);
  sl.cp(s) = cp + 1 == w[uMax] ? -1 : cp + 1;
}

// one matched slot's scratch row: flat index, ts, enter, seq, captures,
// rank in its lane, lane in the CTA (`cta`: the CTA's index in its step)
template <class SL>
__device__ __forceinline__ void emit_row(const StepArgs& a, SL& sl, int s,
                                         int pos, int p, int t, int k,
                                         int tsv, int enter, int seq,
                                         int rank, int l, int cta) {
  if (pos >= a.seg) return;
  const int W = 4 + a.RC;
  int* r = a.rows + (static_cast<long long>(cta) * a.seg + pos) *
                        (W + 2);
  r[0] = static_cast<int>((static_cast<long long>(p) * a.T + t) * a.K + k);
  r[1] = tsv;
  r[2] = enter;
  r[3] = seq;
  for (int i = 0; i < a.RC; ++i) r[4 + i] = __float_as_int(sl.c(s, i));
  r[W] = rank;
  r[W + 1] = l;
}

// ------------------------------------------------------------ widened

// Condition i of the event against slot s's captures with the widened
// tables: cond_ok, then each `capture lane <op> constant` compare.
template <class SL>
__device__ __forceinline__ bool cond_w(const Prog& g, int i, unsigned gw,
                                       SL& sl, int s, const float* at,
                                       int LT) {
  if (!cond_ok(g, i, gw, sl, s, at, LT)) return false;
  for (int q = g.ccmp_start[i]; q < g.ccmp_start[i + 1]; ++q) {
    const int* c = g.ccmp + 4 * q;
    if (!compare(c[2], sl.c(s, c[0] * g.C + c[1]), __int_as_float(c[3])))
      return false;
  }
  return true;
}

// Condition i against a fresh chain's zero captures (SEQUENCE arming of a
// count, and its every-min-0 seed).
__device__ __forceinline__ bool cond_zero(const Prog& g, int i, unsigned gw,
                                          const float* at, int LT) {
  if (!((gw >> i) & 1u)) return false;
  for (int q = g.cmp_start[i]; q < g.cmp_start[i + 1]; ++q) {
    const int* c = g.cmp + 4 * q;
    if (!compare(c[3], at[c[0] * LT], 0.0f)) return false;
  }
  for (int q = g.ccmp_start[i]; q < g.ccmp_start[i + 1]; ++q) {
    const int* c = g.ccmp + 4 * q;
    if (!compare(c[2], 0.0f, __int_as_float(c[3]))) return false;
  }
  return !g.np || prog_ok(g, i, at, LT, nullptr, 0);
}

// The widened instance's lane: one event of ops/nfa.py _one_event_step,
// section by section, under one of two lane policies (TH).
//
// The group policy (the step's widened instance and the bank's group
// mapping): the G threads of a lane (slot k of the lane at thread k % G,
// its s = k / G).  Every section that reads the lane as a whole (the
// first free slot, a slot count, the pending-list rank of the slots
// landing together, the clone allocation) is a ballot over the group's
// bits, a prefix popcount or a shuffle sweep over the group's threads;
// all of them run on every thread of the warp together (warp uniform
// control flow), so lanes that share a warp step in lockstep.
//
// The thread policy (TH, the bank's thread instance, csrc/nfa_bank_wide.cu):
// one thread holds the lane's K slots in its shared-memory column
// (ColSlots), G = 1: a ballot is the slot's own bit, a first free or
// lowest matched slot a find-first-set, a count a popcount, a pending
// rank a K x K compare over the thread's column, a shuffle the value
// itself, a warp barrier nothing; the slot loops are rolled (the body
// unrolled K times would not fit the instruction cache) and the event's
// per-slot arrays are rows of the column.  The sections are the same
// code.
//
// A slot that completes writes its scratch row at once (the captures as
// they stand then: a trailing `every` clears rows right after); its rank
// in the lane is written when the event ends, so rows keep (t, k) order.
// BANK (the pattern bank's instances): a completing slot writes no row;
// when the event ends the lane adds its matched slots to its count, and
// an event with a match sets the lane's last match (the event's ts and
// its lowest matched slot, `jnp.argmax(mm)`).
template <int SPT, bool BANK = false, bool TH = false>
struct Wide {
  static_assert(!TH || BANK, "the thread policy is the bank's");
  using SL = std::conditional_t<TH, ColSlots, Slots<SPT>>;
  using Arr = typename SL::Arr;
  static constexpr int NS = TH ? 1 : (SPT > 0 ? SPT : kWideMaxSpt);
  // slot loops: unrolled over a register instance's slots, else rolled
  static constexpr int UR = !TH && SPT > 0 ? SPT : 1;
  // the event's per-slot arrays (the thread policy's column rows, from
  // ColSlots::xa on, in this order)
  enum { aPre, aRk, aFrom, aFstart, aSpr };
  const Prog& g;
  const StepArgs& a;
  SL& sl;
  int* stel;                  // this lane's telemetry row (shared memory)
  int* s_fill;
  int G, gl, gbase, l, p, ns, cta;
  bool lane_ok;
  unsigned gmask;
  int arm_seq, drop, armed, sf, cnt;
  // the event
  int t, tsv, sv, LT;
  unsigned gw;
  const float* at;
  bool v;
  unsigned mb;                // bit s: slot s matched by this event
  int mpos[NS];               // its scratch row (-1: none yet)
  Arr st_pre;                 // its state when the unit loop starts
  Arr spr[kMaxMid];           // its clone rank in mid-chain group q
  int lmt, lmk;               // bank: the lane's last match (ts, slot)
  // the thread policy: the slots whose every carry word (wfull), or whose
  // captures and start (wcs), this block wrote; an in-place launch
  // writes back those of a lane it read no carry words of
  unsigned wfull, wcs;

  __device__ __forceinline__ int nsl() const {
    return SPT > 0 && !TH ? SPT : ns;
  }
  __device__ __forceinline__ bool on(int s) const {
    return lane_ok && gl + s * G < a.K;
  }
  __device__ __forceinline__ Arr arr(int x) {
    if constexpr (TH) {
      return ColArr{sl.cap + (sl.xa + x * sl.K) * kThreads};
    } else {
      Arr r;
      return r;
    }
  }
  // the thread policy's column rows of st_pre and the clone ranks
  __device__ __forceinline__ void bind() {
    if constexpr (TH) {
      st_pre = arr(aPre);
#pragma unroll
      for (int q = 0; q < kMaxMid; ++q) spr[q] = arr(aSpr + q);
    }
  }
  __device__ __forceinline__ unsigned ballot(bool x) const {
    if constexpr (TH) return x ? 1u : 0u;
    else return (__ballot_sync(kFull, x) & gmask) >> gbase;
  }
  __device__ __forceinline__ bool any(bool x) const {
    if constexpr (TH) return x;
    else return __any_sync(kFull, x);
  }
  template <class V>
  __device__ __forceinline__ V shfl(V x, int src) const {
    if constexpr (TH) return x;
    else return __shfl_sync(kFull, x, src);
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (!TH) __syncwarp();
  }
  __device__ __forceinline__ bool lane_any(unsigned bits) const {
    if constexpr (TH) return bits != 0;
    bool any = false;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) any |= ballot((bits >> s) & 1u) != 0;
    return any;
  }
  // the lane's first slot (k order) whose bit is set, -1: none
  __device__ __forceinline__ int first(unsigned bits) const {
    if constexpr (TH) return bits ? __ffs(bits) - 1 : -1;
    int r = -1;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      const unsigned b = ballot((bits >> s) & 1u);
      if (r < 0 && b) r = s * G + __ffs(b) - 1;
    }
    return r;
  }
  __device__ __forceinline__ int count(unsigned bits) const {
    if constexpr (TH) return __popc(bits);
    int n = 0;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) n += __popc(ballot((bits >> s) & 1u));
    return n;
  }
  // each set slot's exclusive rank among the lane's set slots (k order);
  // returns their count
  __device__ __forceinline__ int prefix(unsigned bits, Arr& rk) const {
    int n = 0;
    const unsigned lt = (1u << gl) - 1u;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      const unsigned b = ballot((bits >> s) & 1u);
      rk[s] = n + __popc(b & lt);
      n += __popc(b);
    }
    return n;
  }
  // each slot of `bits`' rank among the lane's slots of `bits` in
  // pending-list order (enter, seq): the oracle's append order
  __device__ __forceinline__ void pending(unsigned bits, Arr& rk) {
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) rk[s] = 0;
#pragma unroll (UR)
    for (int s2 = 0; s2 < nsl(); ++s2) {
      const unsigned b = ballot((bits >> s2) & 1u);
      if (!any(b != 0)) continue;
      const bool mine = (bits >> s2) & 1u;
      const int e = mine ? sl.enter(s2) : 0;
      const int q = mine ? sl.seq(s2) : 0;
      for (int src = 0; src < G; ++src) {
        const int e2 = shfl(e, gbase + src);
        const int q2 = shfl(q, gbase + src);
        if (!((b >> src) & 1u)) continue;
#pragma unroll (UR)
        for (int s = 0; s < nsl(); ++s)
          if (((bits >> s) & 1u) &&
              (e2 < sl.enter(s) || (e2 == sl.enter(s) && q2 < sl.seq(s))))
            rk[s] = rk[s] + 1;
      }
    }
  }
  // a bitmask of this thread's slots where f holds
  template <class F>
  __device__ __forceinline__ unsigned bits(F f) {
    unsigned r = 0;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s)
      if (on(s) && f(s)) r |= 1u << s;
    return r;
  }
  __device__ __forceinline__ void set_lm(int s, int x) {
    if (g.has_logical) sl.lm(s) = x;
  }
  // the thread policy: slot s's carry words written (full: every one;
  // else its captures and start)
  __device__ __forceinline__ void wrote(int s, bool full) {
    if constexpr (TH) {
      if (full) wfull |= 1u << s;
      else wcs |= 1u << s;
    }
  }

  // slot s completes at `ts`: its scratch row (index, ts, enter, seq,
  // captures, lane); the rank follows when the event ends
  __device__ __forceinline__ void emit(int s, int ts, int enter, int seq) {
    mb |= 1u << s;
    if constexpr (!BANK) {
      if (mpos[s] < 0) mpos[s] = atomicAdd(s_fill, 1);
      const int pos = mpos[s];
      if (pos >= a.seg) return;
      const int W = 4 + a.RC;
      int* r =
          a.rows + (static_cast<long long>(cta) * a.seg + pos) * (W + 2);
      r[0] = static_cast<int>((static_cast<long long>(p) * a.T + t) * a.K +
                              gl + s * G);
      r[1] = ts;
      r[2] = enter;
      r[3] = seq;
      for (int i = 0; i < a.RC; ++i) r[4 + i] = __float_as_int(sl.c(s, i));
      r[W + 1] = l;
    }
  }

  // zero the logical units' capture rows of units j0..j1 in slot s (a
  // re-arm or a clone clears its group's logical sides)
  __device__ __forceinline__ void clear_logical(int s, int j0, int j1) {
    if (!g.has_logical) return;
    for (int j = j0; j <= j1; ++j) {
      if (unit(g, j)[uKind] != kLogical) continue;
      const int ra = unit(g, j)[uRow], rb = unit_b(g, j)[bRow];
      for (int c = 0; c < g.C; ++c) {
        if (ra >= 0) sl.c(s, ra * g.C + c) = 0.0f;
        if (rb >= 0) sl.c(s, rb * g.C + c) = 0.0f;
      }
    }
  }

  // the slots of `bits` advance out of unit j at the event's ts, or
  // (dl) at their deadline (ops/nfa.py _StepState.land); fwd: a count
  // unit's exit, each slot forwarding its count (dead at max)
  __device__ __forceinline__ void land(int j, unsigned bits, bool dl,
                                       bool fwd) {
    const int* u = unit(g, j);
    const int tgt = u[uLand];
#pragma unroll
    for (int q = 0; q < kMaxMid; ++q) {
      if (q >= g.n_mid || g.mid[2 * q + 1] != j) continue;
      if (!any(bits != 0)) continue;
      unsigned old = 0;
#pragma unroll (UR)
      for (int s = 0; s < nsl(); ++s)
        if (spr[q][s] >= 0) old |= 1u << s;
      const int n_old = count(old);
      Arr rk = arr(aRk);
      pending(bits, rk);
#pragma unroll (UR)
      for (int s = 0; s < nsl(); ++s)
        if ((bits >> s) & 1u) spr[q][s] = rk[s] + n_old;
    }
    if (tgt >= g.S) {
#pragma unroll (UR)
      for (int s = 0; s < nsl(); ++s)
        if ((bits >> s) & 1u)
          emit(s, dl ? sl.dl(s) : tsv, sl.enter(s), sl.seq(s));
      if (g.tail_every >= 0) {
        // trailing `every`: the match is emitted AND the partial re-arms
        // at the group's start with its earlier captures
        Arr rk = arr(aRk);
#pragma unroll (UR)
        for (int s = 0; s < nsl(); ++s) rk[s] = 0;
        if (any(bits != 0)) pending(bits, rk);
        const int n = count(bits);
#pragma unroll (UR)
        for (int s = 0; s < nsl(); ++s) {
          if (!((bits >> s) & 1u)) continue;
          const int base = dl ? sl.dl(s) : tsv;
          sl.st(s) = g.tail_every;
          sl.seq(s) = add32(arm_seq, rk[s]);
          sl.enter(s) = base;
          set_lm(s, 0);
          clear_logical(s, g.tail_every, g.S - 1);
        }
        arm_seq = add32(arm_seq, n);
      } else {
#pragma unroll (UR)
        for (int s = 0; s < nsl(); ++s)
          if ((bits >> s) & 1u) sl.st(s) = -1;
      }
      return;
    }
    const bool to_absent = g.has_absent && unit(g, tgt)[uKind] == kAbsent;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!((bits >> s) & 1u)) continue;
      const int base = dl ? sl.dl(s) : tsv;
      sl.st(s) = tgt;
      sl.enter(s) = base;
      set_lm(s, 0);
      if (g.has_count) {
        const int c = sl.cc(s);
        sl.cp(s) = fwd ? (c == u[uMax] ? -1 : c) : (u[uLive0] ? 0 : -1);
        sl.cc(s) = 0;
      }
      if (to_absent) sl.dl(s) = add32(base, unit(g, tgt)[uWait]);
    }
  }

  // the deadline pass over absent units, ascending (a due `not ... for t`
  // lands at its deadline; a chain of absences cascades in one pass)
  __device__ __forceinline__ void deadline_pass() {
    for (int j = 0; j < g.S; ++j) {
      if (unit(g, j)[uKind] != kAbsent) continue;
      const unsigned b = bits([&](int s) {
        return v && sl.st(s) == j && sl.dl(s) <= tsv;
      });
      land(j, b, true, false);
    }
  }

  // a fresh partial into free slot f (the lane's, k order) at `state`
  __device__ __forceinline__ void seat(int f, int state, int cc, int cp) {
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!on(s) || gl + s * G != f) continue;
      for (int i = 0; i < a.RC; ++i) sl.c(s, i) = 0.0f;
      sl.st(s) = state;
      sl.start(s) = tsv;
      sl.enter(s) = tsv;
      sl.seq(s) = arm_seq;
      set_lm(s, 0);
      if (g.has_count) {
        sl.cc(s) = cc;
        sl.cp(s) = cp;
      }
      wrote(s, true);
    }
  }

  // telemetry word w of the lane += n (the thread policy's row is a
  // column of its own, stride kThreads)
  __device__ __forceinline__ void tel_add(int w, int n) {
    if constexpr (TH) {
      if (stel && n) stel[w * kThreads] += n;
    } else {
      if (stel && n) atomicAdd(stel + w, n);
    }
  }

  // `within` expiry at ts of the slots of m (a leading min-0 count's
  // virgin chain is exempt); → the slots expired
  __device__ __forceinline__ int expire(int ts, unsigned m) {
    int n = 0;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!on(s) || !((m >> s) & 1u)) continue;
      const int st = sl.st(s);
      if (g.has_within && st >= 1 && sub32(ts, sl.start(s)) > g.within &&
          !(g.eps && st == 1 && sl.cp(s) == 0)) {
        sl.st(s) = -1;
        ++n;
      }
    }
    tel_add(3 * g.S, n);
    return n;
  }

  __device__ __forceinline__ void event();
};

template <int SPT, bool BANK, bool TH>
__device__ __forceinline__ void Wide<SPT, BANK, TH>::event() {
  const int S = g.S;
  const int* u0 = unit(g, 0);
  const int t0 = u0[uLand];
  const bool real = v && sv != -2;
  mb = 0;
#pragma unroll (UR)
  for (int s = 0; s < nsl(); ++s) {
    if constexpr (!BANK) mpos[s] = -1;
#pragma unroll
    for (int q = 0; q < kMaxMid; ++q)
      if (!TH || q < g.n_mid) spr[q][s] = -1;
  }

  // within expiry (a leading min-0 count's virgin chain is exempt)
  expire(tsv, ~0u);

  // a leading absent unit: exactly one partial waits at unit 0
  if (g.lead_absent) {
    const bool have0 = lane_any(bits([&](int s) { return sl.st(s) == 0; }));
    const bool want = real && !have0;
    const int f = first(bits([&](int s) {
      return sl.st(s) < 0 && !((mb >> s) & 1u);
    }));
    if (want && f >= 0) {
      seat(f, 0, 0, -1);
#pragma unroll (UR)
      for (int s = 0; s < nsl(); ++s)
        if (on(s) && gl + s * G == f) sl.dl(s) = add32(tsv, u0[uWait]);
      arm_seq = add32(arm_seq, 1);
    }
    if (want && f < 0) ++drop;
  }

  if (g.is_seq && g.has_absent) {
    // SEQUENCE: a due `not ... for t` confirms before the event, then any
    // real event (TIMER rows excepted) kills a partial waiting at one
    deadline_pass();
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s)
      if (on(s) && real && sl.st(s) >= 0 && sl.st(s) < S &&
          unit(g, sl.st(s))[uKind] == kAbsent)
        sl.st(s) = -1;
  }

  // a leading min-0 count: exactly one virgin chain (cnt_prev 0) at unit 1
  if (g.eps) {
    const bool have = lane_any(bits([&](int s) {
      return sl.st(s) == 1 && (!g.is_seq || sl.cp(s) >= 0);
    }));
    const bool want = v && !have && (!g.arm_once || armed == 0);
    const int f = first(bits([&](int s) {
      return sl.st(s) < 0 && !((mb >> s) & 1u);
    }));
    if (want && f >= 0) {
      seat(f, 1, 0, 0);
      arm_seq = add32(arm_seq, 1);
      if (g.arm_once) ++armed;
    }
    if (want && f < 0) ++drop;
  }

#pragma unroll (UR)
  for (int s = 0; s < nsl(); ++s) st_pre[s] = on(s) ? sl.st(s) : -1;

  // the occupancy gate on arming, from the states as the unit loop finds
  // them
  bool occ = false;
  if (g.is_seq && u0[uKind] == kCount && !g.eps && !g.dead_start) {
    occ = lane_any(bits([&](int s) {
      const int sp = st_pre[s];
      return (sp >= 0 && sp <= g.every_end) ||
             (t0 < S && sp == t0 && sl.cp(s) >= 0);
    }));
  } else if (g.occ_hi >= 0) {
    occ = lane_any(bits([&](int s) {
      return st_pre[s] >= 0 && st_pre[s] <= g.occ_hi;
    }));
  }
  // unit 0's conditions as arming reads them: against slot 0's captures
  // before the unit loop writes any
  const int* u0b = unit_b(g, 0);
  bool c0a = on(0) && cond_w(g, u0[uCond], gw, sl, 0, at, LT);
  bool c0b = u0[uKind] == kLogical && on(0) &&
             cond_w(g, u0b[bCond], gw, sl, 0, at, LT);
  c0a = shfl(c0a, gbase);
  c0b = shfl(c0b, gbase);

  // the unit loop: each slot's one transition, in unit order (a landing
  // ranks its slots against the others landing from the same unit)
  unsigned adv = 0, app = 0, ok0b = 0, ok1b = 0, froze0 = 0;
  bool seed_req = false, block_arm = false;
  for (int j = 0; j < S; ++j) {
    const int* u = unit(g, j);
    const int* ub = unit_b(g, j);
    const int kind = u[uKind];
    unsigned pd = 0;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!on(s) || !v || st_pre[s] != j) continue;
      // every condition this slot reads, before any write of the event
      const bool okA = sv == u[uStream] &&
                       cond_w(g, u[uCond], gw, sl, s, at, LT);
      const bool okB = kind == kLogical && sv == ub[bStream] &&
                       cond_w(g, ub[bCond], gw, sl, s, at, LT);
      if (g.has_count) {
        const int a0 = u[uApp0], a1 = u[uApp1];
        if (a0 >= 0 && sv == unit(g, a0)[uStream] &&
            cond_w(g, unit(g, a0)[uCond], gw, sl, s, at, LT))
          ok0b |= 1u << s;
        if (a1 >= 0 && sv == unit(g, a1)[uStream] &&
            cond_w(g, unit(g, a1)[uCond], gw, sl, s, at, LT))
          ok1b |= 1u << s;
      }
      if (stel) {
        const bool ea = sv == u[uStream];
        const bool eb = ub[bCond] >= 0 && sv == ub[bStream];
        if (ea || eb) tel_add(((okA || okB) ? S : 2 * S) + j, 1);
      }
      const unsigned bit = 1u << s;
      if (kind == kSimple) {
        bool ok = okA;
        if (g.eps && j == 1) {
          if (g.is_seq) ok = ok && !(sl.cp(s) == 0 && sf > 0);
          if (g.is_seq && g.is_every && ok && sl.cp(s) == 0) seed_req = true;
          if (ok && sl.cp(s) == 0) sl.start(s) = tsv;
        }
        if (ok) {
          if (u[uRow] >= 0) write_row(g, u[uRow], sl, s, at, LT);
          pd |= bit;
          adv |= bit;
        }
      } else if (kind == kLogical) {
        const int lm = sl.lm(s);
        const bool hA = lm & 1, hB = lm & 2;
        const bool nA = okA && !hA;
        const bool nB = okB && !hB && (ub[bAnd] || !nA);
        if (nA && u[uRow] >= 0) write_row(g, u[uRow], sl, s, at, LT);
        if (nB && ub[bRow] >= 0) write_row(g, ub[bRow], sl, s, at, LT);
        const bool done =
            ub[bAnd] ? ((hA || nA) && (hB || nB)) : (nA || nB);
        sl.lm(s) = lm | (nA ? 1 : 0) | (nB ? 2 : 0);
        if (done) {
          pd |= bit;
          adv |= bit;
        } else if (nA || nB) {
          app |= bit;
        }
      } else if (kind == kCount) {
        const int c2 = sl.cc(s) + 1;
        if (okA) {
          if (u[uRow] >= 0)
            write_count(g, u[uRow], sl, s, at, LT, c2 == 1, c2);
          sl.cc(s) = c2;
          if (c2 == u[uMin]) {
            pd |= bit;
            adv |= bit;
          }
          if (g.is_seq && j == 1 && u0[uKind] == kSimple && c2 >= u[uMin] &&
              c2 != u[uMax])
            block_arm = true;
          if (!g.is_seq || c2 >= u[uMin]) app |= bit;
        }
      } else if (okA) {                 // absent: an arrival kills
        if (j == 0 && g.lead_absent) {
          sl.dl(s) = add32(tsv, u[uWait]);
          sl.start(s) = tsv;
          sl.enter(s) = tsv;
        } else {
          sl.st(s) = -1;
        }
      }
    }
    if (kind != kAbsent) land(j, pd, false, kind == kCount);
  }
  seed_req = lane_any(seed_req ? 1u : 0u);

  // the live append of a forwarded count, while the slot waits where the
  // count's exit landed it
  if (g.has_count) {
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!on(s) || !v || ((adv >> s) & 1u) || st_pre[s] < 0 ||
          st_pre[s] >= S)
        continue;
      const int* w = unit(g, st_pre[s]);
      for (int x = 0; x < 2; ++x) {
        const int j = w[x ? uApp1 : uApp0];
        if (j < 0 || !(((x ? ok1b : ok0b) >> s) & 1u)) continue;
        const int* c = unit(g, j);
        const int cp = sl.cp(s);
        if (cp < 0 || cp >= c[uMax]) continue;
        if (g.eps && j == 0 && cp == 0) sl.start(s) = tsv;
        if (c[uRow] >= 0)
          write_count(g, c[uRow], sl, s, at, LT, cp == 0, cp + 1);
        const bool fz = cp + 1 == c[uMax];
        sl.cp(s) = fz ? -1 : cp + 1;
        app |= 1u << s;
        if (fz && j == 0) froze0 |= 1u << s;
        if (g.is_seq && j == 1 && u0[uKind] == kSimple && !fz)
          block_arm = true;
      }
    }
    if (g.eps && g.is_seq && t0 < S) {
      const bool fz = lane_any(froze0);
      if (v) sf = fz ? 1 : 0;
    }
  }
  block_arm = lane_any(block_arm ? 1u : 0u);

  // SEQUENCE strict contiguity: a real event that moves a partial at a
  // simple, count or logical unit neither on nor into the chain kills it
  // (a logical unit already half done waits)
  if (g.is_seq) {
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      const int sp = st_pre[s];
      if (!on(s) || !real || sp < 0 || sp >= S || sl.st(s) < 0) continue;
      const int kind = unit(g, sp)[uKind];
      if (kind == kAbsent || (((adv | app) >> s) & 1u)) continue;
      if (kind == kLogical && sl.lm(s) != 0) continue;
      sl.st(s) = -1;
    }
  }

  // arming a fresh partial at unit 0, in the first free slot
  bool arm = false, match = false, cA = false, cB = false;
  int state = t0, acc = 0, acp = u0[uLive0] ? 0 : -1, alm = 0;
  const int k0 = u0[uKind];
  if (k0 == kSimple) {
    arm = v && sv == u0[uStream] && c0a;
    match = t0 >= S;
  } else if (k0 == kCount && !g.eps && !g.dead_start) {
    const bool c = g.is_seq ? cond_zero(g, u0[uCond], gw, at, LT) : c0a;
    arm = v && sv == u0[uStream] && c;
    if (u0[uMin] <= 1) {
      match = t0 >= S;
      acp = u0[uMax] == 1 ? -1 : 1;
    } else {
      state = 0;
      acc = 1;
      acp = -1;
    }
  } else if (k0 == kLogical) {
    cA = v && sv == u0[uStream] && c0a;
    cB = v && sv == u0b[bStream] && c0b && (u0b[bAnd] || !cA);
    arm = cA || cB;
    const bool both = u0b[bAnd] ? (cA && cB) : (cA || cB);
    match = both && t0 >= S;
    if (!both) state = 0;
    alm = both ? 0 : (cA ? 1 : 0) | (cB ? 2 : 0);
  }
  const bool do_arm = arm && !occ && !(g.arm_once && armed != 0) &&
                      !block_arm;
  const int f = first(bits([&](int s) {
    return sl.st(s) < 0 && !((mb >> s) & 1u);
  }));
  if (do_arm && f < 0) ++drop;
  if (g.arm_once) {
    if (do_arm && f >= 0) ++armed;
    // a non-every sequence is single-shot: its one initial partial dies
    // on the first real event it cannot advance on
    if (g.is_seq && real && armed == 0) armed = 2;
  }
  if (do_arm && f >= 0) {
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!on(s) || gl + s * G != f) continue;
      for (int i = 0; i < a.RC; ++i) sl.c(s, i) = 0.0f;
      if (k0 == kLogical) {
        if (cA && u0[uRow] >= 0) write_row(g, u0[uRow], sl, s, at, LT);
        if (cB && u0b[bRow] >= 0) write_row(g, u0b[bRow], sl, s, at, LT);
      } else if (u0[uRow] >= 0) {
        if (k0 == kCount)
          write_count(g, u0[uRow], sl, s, at, LT, true, 1);
        else
          write_row(g, u0[uRow], sl, s, at, LT);
      }
      sl.start(s) = tsv;
      if (match) {                      // completes as it arms: stays free
        emit(s, tsv, tsv, arm_seq);
        wrote(s, false);
        continue;
      }
      wrote(s, true);
      sl.st(s) = state;
      sl.enter(s) = tsv;
      sl.seq(s) = arm_seq;
      set_lm(s, alm);
      if (g.has_count) {
        sl.cc(s) = acc;
        sl.cp(s) = acp;
      }
      if (g.has_absent && S > 1 && t0 < S && state == t0 &&
          unit(g, t0)[uKind] == kAbsent)
        sl.dl(s) = add32(tsv, unit(g, t0)[uWait]);
    }
    arm_seq = add32(arm_seq, 1);
  }

  // SEQUENCE every + leading min-0: the next chain starts with this event
  // when the virgin closed and the event passes the kleene
  if (g.eps && g.is_seq && g.is_every && S > 1 &&
      unit(g, 1)[uKind] == kSimple) {
    const bool want = seed_req && v && sv == u0[uStream] &&
                      cond_zero(g, u0[uCond], gw, at, LT);
    const int fs = first(bits([&](int s) {
      return sl.st(s) < 0 && !((mb >> s) & 1u);
    }));
    if (want && fs >= 0) {
      const bool mx1 = u0[uMax] == 1;
#pragma unroll (UR)
      for (int s = 0; s < nsl(); ++s) {
        if (!on(s) || gl + s * G != fs) continue;
        for (int i = 0; i < a.RC; ++i) sl.c(s, i) = 0.0f;
        sl.st(s) = 1;
        if (u0[uRow] >= 0) write_count(g, u0[uRow], sl, s, at, LT, true, 1);
        sl.cp(s) = mx1 ? -1 : 1;
        sl.cc(s) = 0;
        sl.start(s) = tsv;
        sl.enter(s) = tsv;
        sl.seq(s) = arm_seq;
        wrote(s, true);
      }
      arm_seq = add32(arm_seq, 1);
      if (mx1) sf = 1;
    }
    if (want && fs < 0) ++drop;
  }

  // mid-chain `every` clones: each partial that left a group's last unit
  // forks a partial at the group's start with its captures (the group's
  // logical rows cleared), ranks filling free slots in k order
#pragma unroll
  for (int q = 0; q < kMaxMid; ++q) {
    if (q >= g.n_mid) continue;
    unsigned src = 0;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s)
      if (spr[q][s] >= 0) src |= 1u << s;
    const int n_sp = count(src);
    if (!any(n_sp > 0)) continue;
    const int g0 = g.mid[2 * q], g1 = g.mid[2 * q + 1];
    Arr fr = arr(aRk), from = arr(aFrom), fstart = arr(aFstart);
    const unsigned freeb = bits([&](int s) {
      return sl.st(s) < 0 && !((mb >> s) & 1u);
    });
    const int n_free = prefix(freeb, fr);
    unsigned fill = 0;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      from[s] = -1;
      fstart[s] = 0;
      if (((freeb >> s) & 1u) && fr[s] < n_sp) fill |= 1u << s;
    }
    // the source of each filled slot: the slot whose rank is its rank
    // among the free slots
#pragma unroll (UR)
    for (int s2 = 0; s2 < nsl(); ++s2) {
      const int r = on(s2) ? spr[q][s2] : -1;
      const int st0 = on(s2) ? sl.start(s2) : 0;
      for (int x = 0; x < G; ++x) {
        const int r2 = shfl(r, gbase + x);
        const int s02 = shfl(st0, gbase + x);
        if (r2 < 0) continue;
#pragma unroll (UR)
        for (int s = 0; s < nsl(); ++s)
          if (((fill >> s) & 1u) && fr[s] == r2) {
            from[s] = s2 * G + x;
            fstart[s] = s02;
          }
      }
    }
    sync();                             // the sources' captures are written
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      if (!((fill >> s) & 1u)) continue;
      const int d = (from[s] & (G - 1)) - gl, s2 = from[s] / G;
      for (int i = 0; i < a.RC; ++i) sl.c(s, i) = sl.cx(d, s2, i);
      clear_logical(s, g0, g1);
      sl.st(s) = g0;
      sl.start(s) = fstart[s];
      sl.enter(s) = tsv;
      sl.seq(s) = add32(arm_seq, fr[s]);
      set_lm(s, 0);
      if (g.has_count) {
        sl.cc(s) = 0;
        sl.cp(s) = -1;
      }
      wrote(s, true);
    }
    sync();
    arm_seq = add32(arm_seq, n_sp);
    if (n_sp > n_free) drop += n_sp - n_free;
  }

  // the absent deadline pass, after the event
  if (g.has_absent) deadline_pass();

  if constexpr (BANK) {
    // the lane's matches, and its last match: this event's ts and lowest
    // matched slot (both ballots taken by the whole warp)
    const int f = first(mb);
    cnt += count(mb);
    if (f >= 0) {
      lmt = tsv;
      lmk = f;
    }
  } else {
    // each matched slot's rank in its lane: the lane's count, then k order
    int n = 0;
    const unsigned lt = (1u << gl) - 1u;
#pragma unroll (UR)
    for (int s = 0; s < nsl(); ++s) {
      const unsigned b = ballot((mb >> s) & 1u);
      if (((mb >> s) & 1u) && mpos[s] < a.seg) {
        const int W = 4 + a.RC;
        a.rows[(static_cast<long long>(cta) * a.seg + mpos[s]) * (W + 2) + W] =
            cnt + n + __popc(b & lt);
      }
      n += __popc(b);
    }
    cnt += n;
  }
}

// The step body, shared by the kernels below.  `cta` is the CTA's index
// in its step (blockIdx.x, or its place in its tenant for the gang).
// BANK: cta = lane tile * CN + pattern; the pattern's carry, its
// constants, and per-lane count / last-match outputs instead of rows.
//
// Each event of a lane takes ops/nfa.py _one_event_step's order in two
// passes over the lane's slots.  Pass A, per slot: `within` expiry; the
// slot's conditions against its captures as they stand before the event
// (the unit's own, and those of the count units that append while it
// waits there); its one transition (a simple unit advances or completes,
// a count unit appends and advances at min, an absent unit's arrival
// kills); the live append of a forwarded count.  A slot completed here
// holds kMatched until pass B.  Between the passes the lane's first free
// slot and the occupancy gate decide arming.  Pass B, per slot: the match
// of pass A; arming into the first free slot; the absent deadline pass
// (`deadline <= ts` lands the slot at its deadline, cascading through
// absent units); then the slot's row, if it matched, in slot order.
// WIDE: the widened instance, every spec of the class (Wide::event in
// place of the two passes; its leaves lmask, seq_froze and telem, the
// telemetry rows of the CTA's lanes in shared memory after the slots'
// captures; under BANK the pattern's rows).
template <int SPT, bool BANK, bool EXT, bool WIDE = false>
__device__ __forceinline__ void step_body(const StepArgs& a, int cta) {
  extern __shared__ int smem[];
  __shared__ int s_fill;
  __shared__ int s_dl;
  const int tid = threadIdx.x;
  const int prog_pad = (a.prog_len + 3) & ~3;
  const int prm_pad = BANK ? (a.n_params + 3) & ~3 : 0;
  const int LT = a.L * a.TT;
  const int tile_ints = (3 + a.A) * LT;
  int* sprog = smem;
  float* sprm = reinterpret_cast<float*>(smem + prog_pad);
  int* tiles = smem + prog_pad + prm_pad;
  const int pat = BANK ? cta % a.CN : 0;
  const int tile = BANK ? cta / a.CN : cta;
  const int p0 = tile * a.L;

  for (int i = tid; i < a.prog_len; i += kThreads) sprog[i] = a.prog[i];
  if constexpr (BANK) {
    for (int i = tid; i < a.n_params; i += kThreads)
      sprm[i] = a.params[static_cast<long long>(pat) * a.n_params + i];
  }
  if (tid == 0) {
    s_fill = 0;
    s_dl = INT_MAX;
  }
  load_tile(tiles, 0, a, p0);
  cp_async_commit();
  __syncthreads();

  Prog g = parse(sprog);
  if constexpr (BANK) g.prm = sprm;
  if constexpr (!kProg) {
    // the build without programs: their code compiles away
    if (g.np) __trap();                 // the caller picks the variant
    g.np = 0;
  }
  if constexpr (!EXT) {
    // the instance for simple units alone: the count, deadline and
    // occupancy code compiles away (and with it their registers)
    if (g.has_count || g.has_absent) __trap();  // the caller picks EXT
    g.has_count = g.has_absent = 0;
    g.occ_hi = -1;
  }
  if constexpr (!WIDE) {
    if (sprog[12]) __trap();            // the caller picks WIDE
  }
  const Arm arm = arm_of(g);
  const int G = a.G;
  const int gl = tid & (G - 1);
  const int l = tid / G;
  const int p = p0 + l;
  const bool lane_ok = p < a.P;
  const int wl = tid & 31;
  const int gbase = wl & ~(G - 1);
  const unsigned gmask =
      G == 32 ? kFull : ((1u << G) - 1u) << static_cast<unsigned>(gbase);
  const unsigned ltmask = gmask & ((1u << wl) - 1u);
  const int ns = SPT > 0 ? SPT : a.spt;
  const int RC = a.RC;
  const long long lane = static_cast<long long>(pat) * a.P + p;
  const long long lane_k = lane * a.K;

  Slots<SPT> sl;
  if constexpr (SPT > 0) {
    sl.cap = reinterpret_cast<float*>(tiles + 2 * tile_ints) + tid;
    sl.RC = RC;
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int k = gl + s * G;
      const bool on = lane_ok && k < a.K;
      const long long sk = lane_k + k;
      sl.st(s) = on ? a.st_in[sk] : -1;
      sl.start(s) = on ? a.start_in[sk] : 0;
      sl.enter(s) = on ? a.enter_in[sk] : 0;
      sl.seq(s) = on ? a.seq_in[sk] : 0;
      sl.cc(s) = on && g.has_count ? a.cc_in[sk] : 0;
      sl.cp(s) = on && g.has_count ? a.cp_in[sk] : -1;
      sl.dl(s) = on && g.has_absent ? a.dl_in[sk] : 0;
      if constexpr (WIDE) sl.lm(s) = on && g.has_logical ? a.lm_in[sk] : 0;
      for (int i = 0; i < RC; ++i)
        sl.c(s, i) = on ? a.caps_in[sk * RC + i] : 0.0f;
    }
  } else {
    sl.st_ = a.st + lane_k + gl;
    sl.start_ = a.start + lane_k + gl;
    sl.enter_ = a.enter + lane_k + gl;
    sl.seq_ = a.seq + lane_k + gl;
    sl.cc_ = g.has_count ? a.cc + lane_k + gl : nullptr;
    sl.cp_ = g.has_count ? a.cp + lane_k + gl : nullptr;
    sl.dl_ = g.has_absent ? a.dl + lane_k + gl : nullptr;
    sl.lm_ = WIDE && g.has_logical ? a.lm + lane_k + gl : nullptr;
    sl.cap = a.caps + (lane_k + gl) * RC;
    sl.G = G;
    sl.RC = RC;
    for (int s = 0; s < ns; ++s) {
      const int k = gl + s * G;
      if (!(lane_ok && k < a.K)) continue;
      const long long sk = lane_k + k;
      a.st[sk] = a.st_in[sk];
      a.start[sk] = a.start_in[sk];
      a.enter[sk] = a.enter_in[sk];
      a.seq[sk] = a.seq_in[sk];
      if (g.has_count) {
        a.cc[sk] = a.cc_in[sk];
        a.cp[sk] = a.cp_in[sk];
      }
      if (g.has_absent) a.dl[sk] = a.dl_in[sk];
      if (WIDE && g.has_logical) a.lm[sk] = a.lm_in[sk];
      for (int i = 0; i < RC; ++i) a.caps[sk * RC + i] = a.caps_in[sk * RC + i];
    }
  }
  int arm_seq = lane_ok ? a.armseq_in[lane] : 0;
  int drop = lane_ok ? a.dropped_in[lane] : 0;
  int armed = (lane_ok && g.arm_once) ? a.armed_in[lane] : 0;
  int cnt = 0;                          // matches of this lane so far
  int lmt = 0, lmk = 0;                 // bank: the lane's last match
  const int* u0 = unit(g, 0);
  // the widened instance's lane state and its telemetry rows: the CTA's
  // lanes' [3S + 1] words, pass / fail / within drops accumulated in
  // place, the occupancy gauge counted after the last event
  int* stel = nullptr;
  if constexpr (WIDE) {
    if (a.tel_w > 0) {
      int* rows = tiles + 2 * tile_ints + (SPT > 0 ? kThreads * SPT * RC : 0);
      for (int i = tid; i < a.L * a.tel_w; i += kThreads) {
        const int w = i % a.tel_w, pl = p0 + i / a.tel_w;
        rows[i] = pl < a.P && (a.T == 0 || w >= g.S)
                      ? a.tel_in[(static_cast<long long>(pat) * a.P + pl) *
                                     a.tel_w + w]
                      : 0;
      }
      __syncthreads();
      stel = lane_ok ? rows + l * a.tel_w : nullptr;
    }
  }
  Wide<SPT, BANK> w{g, a, sl, stel, &s_fill, G, gl, gbase, l, p, ns, cta,
                    lane_ok, gmask, arm_seq, drop, armed,
                    WIDE && lane_ok && a.sf_in ? a.sf_in[lane] : 0, 0};

  const int n_tiles = (a.T + a.TT - 1) / a.TT;
  for (int it = 0; it < n_tiles; ++it) {
    const int* cur = tiles + (it & 1) * tile_ints;
    if (it + 1 < n_tiles) {
      load_tile(tiles + ((it + 1) & 1) * tile_ints, (it + 1) * a.TT, a, p0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = it * a.TT;
    const int tn = min(a.TT, a.T - t0);
    for (int j = 0; j < tn; ++j) {
      const int e = l * a.TT + j;
      const int t = t0 + j;
      const int tsv = cur[e];
      const int sv = cur[LT + e];
      unsigned gw = static_cast<unsigned>(cur[2 * LT + e]);
      const float* at = reinterpret_cast<const float*>(cur + 3 * LT) + e;
      if constexpr (BANK) {
        if (g.n_pcmp) gw = param_gates(g, gw, at, LT, sprm);
      }
      const bool v = lane_ok && (gw & kValidBit);
      if constexpr (WIDE) {
        w.t = t;
        w.tsv = tsv;
        w.sv = sv;
        w.LT = LT;
        w.gw = gw;
        w.at = at;
        w.v = v;
        w.event();
        continue;
      }
      int ffree = -1;                   // first free slot of the lane
      bool occ = false;                 // a slot sits at units 0..occ_hi

      // pass A: within expiry, each slot's one transition, live appends
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        const int k = gl + s * G;
        bool fr = false, oc = false;
        if (lane_ok && k < a.K) {
          int st = sl.st(s);
          if (g.has_within && st >= 1 &&
              sub32(tsv, sl.start(s)) > g.within)
            st = -1;
          oc = st >= 0 && st <= g.occ_hi;
          bool m = false;
          if (v && st >= 0 && st < g.S) {
            const int* u = unit(g, st);
            const bool ok = sv == u[uStream] &&
                            cond_ok(g, u[uCond], gw, sl, s, at, LT);
            int a0 = -1, a1 = -1;
            bool ok0 = false, ok1 = false;
            if (g.has_count) {          // before any write of this event
              a0 = u[uApp0];
              a1 = u[uApp1];
              if (a0 >= 0)
                ok0 = sv == unit(g, a0)[uStream] &&
                      cond_ok(g, unit(g, a0)[uCond], gw, sl, s, at, LT);
              if (a1 >= 0)
                ok1 = sv == unit(g, a1)[uStream] &&
                      cond_ok(g, unit(g, a1)[uCond], gw, sl, s, at, LT);
            }
            bool adv = false;
            if (ok) {
              const int from = st;
              if (u[uKind] == kSimple) {
                if (u[uRow] >= 0) write_row(g, u[uRow], sl, s, at, LT);
                m = land(g, sl, s, st, from, tsv, false, 0, false);
                adv = true;
              } else if (u[uKind] == kCount) {
                const int c2 = sl.cc(s) + 1;
                if (u[uRow] >= 0)
                  write_count(g, u[uRow], sl, s, at, LT, c2 == 1, c2);
                sl.cc(s) = c2;
                if (c2 == u[uMin]) {
                  m = land(g, sl, s, st, from, tsv, true, c2,
                           c2 == u[uMax]);
                  adv = true;
                }
              } else {
                st = -1;                // an absent unit's arrival kills
              }
            }
            if (!adv) {
              live_append(g, sl, s, a0, ok0, at, LT);
              live_append(g, sl, s, a1, ok1, at, LT);
            }
          }
          sl.st(s) = m ? kMatched : st;
          fr = st < 0 && !m;
        }
        const unsigned bf = __ballot_sync(kFull, fr) & gmask;
        if (ffree < 0 && bf) ffree = s * G + (__ffs(bf) - 1 - gbase);
        if (g.occ_hi >= 0 && (__ballot_sync(kFull, oc) & gmask)) occ = true;
      }

      // arming at unit 0: the first free slot, free meaning empty and not
      // completed by this event, unless a slot occupies 0..occ_hi
      const bool c0 = v && sv == u0[uStream] && ((gw >> u0[uCond]) & 1u);
      const bool want = c0 && !occ && (!g.arm_once || armed == 0);
      const bool do_arm = want && ffree >= 0;
      const int aseq = arm_seq;
      if (want) {
        if (do_arm) {
          if (g.arm_once) armed += 1;
          arm_seq += 1;
        } else {
          drop += 1;
        }
      }

      // pass B: arming, the deadline pass, and each matched slot's row
      int ev_k = -1;                    // bank: lowest slot matched now
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        const int k = gl + s * G;
        bool m = false;
        int mts = tsv, ment = 0, mseq = 0;
        if (lane_ok && k < a.K) {
          int st = sl.st(s);
          if (st == kMatched) {
            m = true;
            st = -1;
            ment = sl.enter(s);
            mseq = sl.seq(s);
          }
          if (do_arm && k == ffree) {
            for (int i = 0; i < RC; ++i) sl.c(s, i) = 0.0f;
            if (u0[uRow] >= 0) {
              if (u0[uKind] == kCount)
                write_count(g, u0[uRow], sl, s, at, LT, true, 1);
              else
                write_row(g, u0[uRow], sl, s, at, LT);
            }
            sl.start(s) = tsv;
            if (arm.match) {            // the chain completes as it arms;
              m = true;                 // the slot stays empty
              ment = tsv;
              mseq = aseq;
            } else {
              st = arm.state;
              sl.enter(s) = tsv;
              sl.seq(s) = aseq;
              if (g.has_count) {
                sl.cc(s) = arm.cnt_cur;
                sl.cp(s) = arm.cnt_prev;
              }
              if (g.has_absent && arm.deadline)
                sl.dl(s) = add32(tsv, unit(g, st)[uWait]);
            }
          }
          if (g.has_absent && v) {
            // due `not ... for t` units land at their deadline, in
            // ascending unit order (a chain of absences in one pass)
            while (st >= 0 && unit(g, st)[uKind] == kAbsent &&
                   sl.dl(s) <= tsv) {
              const int base = sl.dl(s);
              if (land(g, sl, s, st, st, base, false, 0, false)) {
                m = true;
                mts = base;
                ment = sl.enter(s);
                mseq = sl.seq(s);
              }
            }
          }
          sl.st(s) = st;
        }
        const unsigned bm = __ballot_sync(kFull, m);
        if constexpr (BANK) {
          const unsigned mine = bm & gmask;
          if (mine) {
            cnt += __popc(mine);
            if (ev_k < 0) ev_k = s * G + (__ffs(mine) - 1 - gbase);
          }
        } else if (bm) {                // a row for each matched slot
          const unsigned mine = bm & gmask;
          int base = 0;
          if (mine && gl == 0) base = atomicAdd(&s_fill, __popc(mine));
          base = __shfl_sync(kFull, base, gbase);
          if (m) {
            const int off = __popc(mine & ltmask);
            emit_row(a, sl, s, base + off, p, t, k, mts, ment, mseq,
                     cnt + off, l, cta);
          }
          cnt += __popc(mine);
        }
      }
      if constexpr (BANK) {
        if (ev_k >= 0) {
          lmt = tsv;
          lmk = ev_k;
        }
      }
    }
    __syncthreads();                    // the tile is free to refill
  }
  if constexpr (EXT) {
    // the plain step's padding rows (invalid, at the last event's ts) run
    // only the `within` expiry: once more at that ts (the bank's group
    // and widened instances too; its thread instance runs its own pass)
    if (a.pad_within && g.has_within && lane_ok && a.T > 0) {
      const int tl = a.ts[static_cast<long long>(p) * a.T + a.T - 1];
      int n = 0;
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        const int k = gl + s * G;
        if (k >= a.K) continue;
        const int st = sl.st(s);
        if (st >= 1 && sub32(tl, sl.start(s)) > g.within &&
            !(WIDE && g.eps && st == 1 && sl.cp(s) == 0)) {
          sl.st(s) = -1;
          ++n;
        }
      }
      if (WIDE && stel && n) atomicAdd(stel + 3 * g.S, n);
    }
  }
  if constexpr (WIDE) {
    arm_seq = w.arm_seq;
    drop = w.drop;
    armed = w.armed;
    cnt = w.cnt;
    if constexpr (BANK) {
      lmt = w.lmt;
      lmk = w.lmk;
    }
    if (stel && a.T > 0) {              // the occupancy gauge
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        const int k = gl + s * G;
        if (k < a.K && sl.st(s) >= 0 && sl.st(s) < g.S)
          atomicAdd(stel + sl.st(s), 1);
      }
    }
  }

  // the bank may pass one carry as input and output: every thread of the
  // lane has read the lane's scalars before any is written
  if constexpr (BANK) __syncthreads();
  int dmin = INT_MAX;                   // this thread's earliest deadline
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    const int k = gl + s * G;
    if (!(lane_ok && k < a.K)) continue;
    if constexpr (SPT > 0) {
      const long long sk = lane_k + k;
      a.st[sk] = sl.st(s);
      a.start[sk] = sl.start(s);
      a.enter[sk] = sl.enter(s);
      a.seq[sk] = sl.seq(s);
      if (g.has_count) {
        a.cc[sk] = sl.cc(s);
        a.cp[sk] = sl.cp(s);
      }
      if (g.has_absent) a.dl[sk] = sl.dl(s);
      if (WIDE && g.has_logical) a.lm[sk] = sl.lm(s);
      for (int i = 0; i < RC; ++i) a.caps[sk * RC + i] = sl.c(s, i);
    }
    if (!BANK && g.has_absent) {
      const int st = sl.st(s);
      if (st >= 0 && unit(g, st)[uKind] == kAbsent) dmin = min(dmin, sl.dl(s));
    }
  }
  if (lane_ok && gl == 0) {
    a.armseq[lane] = arm_seq;
    a.dropped[lane] = drop;
    if (g.arm_once) a.armed[lane] = armed;
    if (WIDE && a.sf) a.sf[lane] = w.sf;
    if constexpr (BANK) {
      a.count[lane] = cnt;
      a.lmt[lane] = lmt;
      a.lmk[lane] = lmk;
    } else {
      a.lane_count[p] = cnt;
    }
  }
  if constexpr (!BANK) {
    if (g.has_absent) {                 // the CTA's earliest live deadline
      for (int o = 16; o > 0; o >>= 1)
        dmin = min(dmin, __shfl_xor_sync(kFull, dmin, o));
      if (wl == 0) atomicMin(&s_dl, dmin);
      __syncthreads();
      if (tid == 0) a.dl_min[cta] = s_dl;
    }
    if (tid == 0) a.fill[cta] = s_fill;
  }
  if constexpr (WIDE) {
    if (a.tel_w > 0) {
      __syncthreads();
      const int* rows =
          tiles + 2 * tile_ints + (SPT > 0 ? kThreads * SPT * RC : 0);
      for (int i = tid; i < a.L * a.tel_w; i += kThreads) {
        const int pl = p0 + i / a.tel_w;
        if (pl < a.P)
          a.tel[(static_cast<long long>(pat) * a.P + pl) * a.tel_w +
                i % a.tel_w] = rows[i];
      }
    }
  }
}

// ------------------------------------------------------------ compaction

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_op(int x, int op) {
  return op == 0 ? warp_sum(x) : op == 1 ? warp_max(x) : warp_min(x);
}

// block-wide sum (op 0), max (op 1) or min (op 2); every thread gets the
// result
__device__ int block_reduce(int x, int op, int* red) {
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5;
  x = warp_op(x, op);
  __syncthreads();
  if (wl == 0) red[w] = x;
  __syncthreads();
  int y = wl < kThreads / 32 ? red[wl]
                             : (op == 0 ? 0 : op == 1 ? INT_MIN : INT_MAX);
  return warp_op(y, op);
}

struct PackArgs {
  const int* rows;
  const int* lane_count;
  const int* fill;
  const int* dropped;
  const int* dl_min;      // [n_cta], or null: no absent unit
  int* slab;              // [cap + 2, W]
  int P, L, seg, n_cta, cap, W;
};

// The compaction of step CTA c's scratch (see nfa_compact below).
__device__ __forceinline__ void compact_body(const PackArgs& a, int c) {
  __shared__ int s_off[kThreads];
  __shared__ int red[kThreads / 32];
  const int tid = threadIdx.x;
  const int wl = tid & 31, w = tid >> 5;

  // rows of the CTAs before this one, rows in all, the fullest segment,
  // and (CTA 0) the earliest live absent deadline of the step's CTAs
  int before = 0, total = 0, mx = 0, dl = INT_MAX;
  for (int i = tid; i < a.n_cta; i += kThreads) {
    const int f = a.fill[i];
    total += f;
    if (i < c) before += f;
    mx = max(mx, f);
    if (c == 0 && a.dl_min) dl = min(dl, a.dl_min[i]);
  }
  before = block_reduce(before, 0, red);
  total = block_reduce(total, 0, red);
  mx = block_reduce(mx, 1, red);
  if (c == 0 && a.dl_min) dl = block_reduce(dl, 2, red);

  // exclusive scan of this CTA's lane counts
  const int p = c * a.L + tid;
  const int v = (tid < a.L && p < a.P) ? a.lane_count[p] : 0;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (wl >= o) x += y;
  }
  __syncthreads();
  if (wl == 31) red[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = wl < kThreads / 32 ? red[wl] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (wl >= o) y += z;
    }
    if (wl < kThreads / 32) red[wl] = y;
  }
  __syncthreads();
  s_off[tid] = x + (w > 0 ? red[w - 1] : 0) - v;
  __syncthreads();

  // scatter this CTA's rows to slab[offset(p) + rank]
  const int n = min(a.fill[c], a.seg);
  const int W2 = a.W + 2;
  for (int r = tid; r < n; r += kThreads) {
    const int* row = a.rows + (static_cast<long long>(c) * a.seg + r) * W2;
    const int dest = before + s_off[row[a.W + 1]] + row[a.W];
    if (dest >= a.cap) continue;
    int* out = a.slab + static_cast<long long>(dest) * a.W;
    for (int i = 0; i < a.W; ++i) out[i] = row[i];
  }
  // rows past the count: -1 in column 0
  for (long long r = static_cast<long long>(total) + c * kThreads + tid;
       r < a.cap; r += static_cast<long long>(a.n_cta) * kThreads)
    a.slab[r * a.W] = -1;

  if (c == 0) {
    int d = 0;
    for (int i = tid; i < a.P; i += kThreads) d += a.dropped[i];
    d = block_reduce(d, 0, red);
    int* tail = a.slab + static_cast<long long>(a.cap) * a.W;
    for (int i = tid; i < 2 * a.W; i += kThreads) {
      int val = 0;
      if (i == 0) val = total;
      else if (i == 1) val = d;
      else if (i == 2 && a.dl_min) val = dl;
      else if (i == a.W) val = mx;            // status row
      else if (i == a.W + 1) val = a.seg;
      tail[i] = val;
    }
  }
}

// ------------------------------------------------------------ launches

constexpr size_t kSmemLimit = 227 * 1024;

// A step's geometry: the slot instance (1, 2 or 4 slots a thread in
// registers; 0 the wide ring) and its dynamic shared memory.
struct StepPlan {
  int spt;
  size_t smem;
};

// Tile size, slot instance and shared memory for a within `limit` bytes
// (smem above the limit: no instance fits); an instance of more than
// `spt_max` slots a thread gives way to the wide ring.
StepPlan plan_step(StepArgs& a, bool bank, size_t limit, int spt_max = 4) {
  a.spt = (a.K + a.G - 1) / a.G;
  a.L = kThreads / a.G;
  // events per tile: both buffers within kTileBytes, a power of two
  int tt = kMaxTileEvents;
  while (tt > 1 && 2LL * (3 + a.A) * a.L * tt * 4 > kTileBytes) tt >>= 1;
  a.TT = tt;
  int spt = a.spt <= 2 ? a.spt : (a.spt <= 4 ? 4 : 0);
  if (spt > spt_max) spt = 0;
  const int prm_pad = bank ? (a.n_params + 3) & ~3 : 0;
  const size_t base =
      static_cast<size_t>(((a.prog_len + 3) & ~3) + prm_pad) * 4 +
      2ull * (3 + a.A) * a.L * a.TT * 4;
  const size_t caps_smem = static_cast<size_t>(kThreads) * spt * a.RC * 4;
  const size_t tel = static_cast<size_t>(a.L) * a.tel_w * 4;
  if (spt > 0 && base + caps_smem + tel <= limit)
    return {spt, base + caps_smem + tel};
  // the widened wide-ring instance keeps its per-slot event words in
  // local arrays of kWideMaxSpt
  if (a.wide && a.spt > kWideMaxSpt) return {0, limit + 1};
  return {0, base + tel};
}

bool bad_geometry(int K, int T, int G, int A, int RC, int prog_len) {
  return K <= 0 || T < 0 || G <= 0 || G > 32 || (G & (G - 1)) || A < 0 ||
         RC <= 0 || prog_len < kHeader;
}

// The carry pointers of the C entries: 11 leaves in, 11 out, in
// ops/nfa.KERNEL_CARRY's order (slot_state, slot_start, slot_enter,
// slot_seq, arm_seq, captures, dropped, armed_total, cnt_cur, cnt_prev,
// deadline; null where the spec's carry has no such leaf).
struct CarryPtrs {
  const int *st, *start, *enter, *seq, *armseq;
  const float* caps;
  const int *dropped, *armed, *cc, *cp, *dl;
};

struct CarryOut {
  int *st, *start, *enter, *seq, *armseq;
  float* caps;
  int *dropped, *armed, *cc, *cp, *dl;
};

void set_carry(StepArgs& a, const CarryPtrs& i, const CarryOut& o) {
  a.st_in = i.st;
  a.start_in = i.start;
  a.enter_in = i.enter;
  a.seq_in = i.seq;
  a.armseq_in = i.armseq;
  a.caps_in = i.caps;
  a.dropped_in = i.dropped;
  a.armed_in = i.armed;
  a.cc_in = i.cc;
  a.cp_in = i.cp;
  a.dl_in = i.dl;
  a.st = o.st;
  a.start = o.start;
  a.enter = o.enter;
  a.seq = o.seq;
  a.armseq = o.armseq;
  a.caps = o.caps;
  a.dropped = o.dropped;
  a.armed = o.armed;
  a.cc = o.cc;
  a.cp = o.cp;
  a.dl = o.dl;
}

// the widened instance's leaves (in: lmask, seq_froze, telem; out: the
// same), null where the spec's carry has none
void set_wide(StepArgs& a, const int* const* in, int* const* out,
              int flags, int tel_w) {
  a.lm_in = in[0];
  a.sf_in = in[1];
  a.tel_in = in[2];
  a.lm = out[0];
  a.sf = out[1];
  a.tel = out[2];
  a.wide = (flags & kFlagWide) != 0;
  a.pad_within = (flags & kFlagPadWithin) != 0;
  a.tel_w = tel_w;
}

#define CARRY_PARAMS                                                        \
  const int *st_in, const int *start_in, const int *enter_in,              \
      const int *seq_in, const int *armseq_in, const float *caps_in,       \
      const int *dropped_in, const int *armed_in, const int *cc_in,        \
      const int *cp_in, const int *dl_in, int *st, int *start, int *enter, \
      int *seq, int *armseq_out, float *caps, int *dropped_out,            \
      int *armed_out, int *cc, int *cp, int *dl
#define CARRY_IN                                                          \
  CarryPtrs {                                                             \
    st_in, start_in, enter_in, seq_in, armseq_in, caps_in, dropped_in,    \
        armed_in, cc_in, cp_in, dl_in                                     \
  }
#define CARRY_OUT                                                         \
  CarryOut {                                                              \
    st, start, enter, seq, armseq_out, caps, dropped_out, armed_out, cc, \
        cp, dl                                                            \
  }

// the widened leaves: in and out both or neither, telemetry with a width,
// all of them only with the widened instance
bool bad_wide(const int* lm_in, const int* sf_in, const int* tel_in,
              const int* lm, const int* sf, const int* tel, int flags,
              int tel_w) {
  return (!lm_in != !lm) || (!sf_in != !sf) || (!tel_in != !tel) ||
         (!tel_in != (tel_w <= 0)) || tel_w < 0 ||
         (flags & ~(kFlagWide | kFlagPadWithin)) ||
         (!(flags & kFlagWide) && (lm_in || sf_in || tel_in));
}

// a leaf every spec's carry has is null (the optional leaves are the
// caller's to match to the program: ops/nfa._check_carry)
bool missing_leaves(const CarryPtrs& i, const CarryOut& o) {
  return !i.st || !i.start || !i.enter || !i.seq || !i.armseq || !i.caps ||
         !i.dropped || !o.st || !o.start || !o.enter || !o.seq ||
         !o.armseq || !o.caps || !o.dropped;
}

// One block step's arguments from a C entry's (ops/nfa.py nfa_step_egress
// passes them in KERNEL_CARRY's and WIDE_CARRY's order); false for a
// geometry, a carry or a widened leaf set the kernels do not take.
inline bool make_step_args(StepArgs& a, const float* attrs, const int* ts,
                           const int* strm, const int* gates,
                           const int* prog, int prog_len,
                           const CarryPtrs& in, const CarryOut& out,
                           int* rows, int* lane_count, int* fill,
                           int* dl_min, const int* const* win,
                           int* const* wout, int P, int T, int K, int G,
                           int seg, int A, int RC, int flags, int tel_w) {
  if (bad_geometry(K, T, G, A, RC, prog_len) || seg < 0 ||
      missing_leaves(in, out) || ((in.dl != nullptr) != (dl_min != nullptr)) ||
      bad_wide(win[0], win[1], win[2], wout[0], wout[1], wout[2], flags,
               tel_w))
    return false;
  a.attrs = attrs;
  a.ts = ts;
  a.strm = strm;
  a.gates = gates;
  a.prog = prog;
  set_carry(a, in, out);
  set_wide(a, win, wout, flags, tel_w);
  a.rows = rows;
  a.lane_count = lane_count;
  a.fill = fill;
  a.dl_min = dl_min;
  a.prog_len = prog_len;
  a.P = P;
  a.T = T;
  a.K = K;
  a.G = G;
  a.seg = seg;
  a.A = A;
  a.RC = RC;
  a.CN = 1;
  a.n_params = 0;
  return true;
}

// One bank step's arguments from a C entry's (ops/nfa.py nfa_bank_lanes
// passes the carry in KERNEL_CARRY's and WIDE_CARRY's order, [CN, P, ...]
// leaves; in and out may be the same tensors); false for a geometry, a
// carry or a widened leaf set the kernels do not take.
inline bool make_bank_args(StepArgs& a, const float* attrs, const int* ts,
                           const int* strm, const int* gates,
                           const int* prog, int prog_len,
                           const float* params, int n_params,
                           const CarryPtrs& in, const CarryOut& out,
                           int* count, int* lmt, int* lmk,
                           const int* const* win, int* const* wout, int CN,
                           int P, int T, int K, int G, int A, int RC,
                           int flags, int tel_w) {
  if (bad_geometry(K, T, G, A, RC, prog_len) || n_params < 0 ||
      missing_leaves(in, out) ||
      bad_wide(win[0], win[1], win[2], wout[0], wout[1], wout[2], flags,
               tel_w))
    return false;
  a.attrs = attrs;
  a.ts = ts;
  a.strm = strm;
  a.gates = gates;
  a.prog = prog;
  set_carry(a, in, out);
  set_wide(a, win, wout, flags, tel_w);
  a.params = params;
  a.count = count;
  a.lmt = lmt;
  a.lmk = lmk;
  a.prog_len = prog_len;
  a.P = P;
  a.T = T;
  a.K = K;
  a.G = G;
  a.seg = 0;
  a.A = A;
  a.RC = RC;
  a.CN = CN;
  a.n_params = n_params;
  return true;
}

}  // namespace
