// The NFA block step's device code shared by csrc/nfa_step.cu (the step,
// the compaction, the pattern bank) and csrc/nfa_gang.cu (the
// cross-tenant gang): the program table, the slot storage, the step body
// (step_body) and the compaction body (compact_body), the step's
// geometry (plan_step) and the C entries' carry pointers.  The design
// and the contract are in nfa_step.cu's notes.
#pragma once
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {


constexpr int kThreads = 256;
constexpr int kTileBytes = 32 * 1024;   // both tile buffers together: at
                                        // K = 8 five CTAs fit an SM, so
                                        // P = 16384 runs in one wave
constexpr int kMaxTileEvents = 128;
constexpr int kHeader = 12;             // S, R, C, has_within, within_ms,
                                        // arm_once, n_cond, n_cmp, n_pcmp,
                                        // has_count, has_absent, occ_hi
constexpr unsigned kValidBit = 0x80000000u;
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
enum UnitKind { kSimple = 0, kCount = 1, kAbsent = 2 };
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
  g.units = p + kHeader;
  g.row_src = g.units + kUnit * g.S;
  g.rowx_start = g.row_src + g.R * g.C;
  g.rowx = g.rowx_start + g.R + 1;
  g.cmp_start = g.rowx + g.rowx_start[g.R];
  g.cmp = g.cmp_start + g.n_cond + 1;
  g.pcmp_start = g.cmp + 4 * g.n_cmp;
  g.pcmp = g.pcmp_start + g.n_cond + 1;
  return g;
}

__device__ __forceinline__ const int* unit(const Prog& g, int j) {
  return g.units + kUnit * j;
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
  int prog_len, P, T, K, G, spt, L, TT, seg, A, RC, CN, n_params;
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

// Slot storage.  SPT > 0: this thread's SPT slots in registers (state,
// start, enter, seq, and the count and deadline words), their capture
// rows in its own column of shared memory (stride kThreads, so a warp's
// accesses never share a bank).
template <int SPT>
struct Slots {
  int st_[SPT], start_[SPT], enter_[SPT], seq_[SPT];
  int cc_[SPT], cp_[SPT], dl_[SPT];
  float* cap;
  int RC;
  __device__ __forceinline__ int& st(int s) { return st_[s]; }
  __device__ __forceinline__ int& start(int s) { return start_[s]; }
  __device__ __forceinline__ int& enter(int s) { return enter_[s]; }
  __device__ __forceinline__ int& seq(int s) { return seq_[s]; }
  __device__ __forceinline__ int& cc(int s) { return cc_[s]; }
  __device__ __forceinline__ int& cp(int s) { return cp_[s]; }
  __device__ __forceinline__ int& dl(int s) { return dl_[s]; }
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[(s * RC + i) * kThreads];
  }
};

// The wide-ring instance: the slots live in the new carry, slot s of this
// thread at k = gl + s*G (cc, cp, dl: only where the spec has the leaf).
template <>
struct Slots<0> {
  int *st_, *start_, *enter_, *seq_, *cc_, *cp_, *dl_;
  float* cap;
  int G, RC;
  __device__ __forceinline__ int& st(int s) { return st_[s * G]; }
  __device__ __forceinline__ int& start(int s) { return start_[s * G]; }
  __device__ __forceinline__ int& enter(int s) { return enter_[s * G]; }
  __device__ __forceinline__ int& seq(int s) { return seq_[s * G]; }
  __device__ __forceinline__ int& cc(int s) { return cc_[s * G]; }
  __device__ __forceinline__ int& cp(int s) { return cp_[s * G]; }
  __device__ __forceinline__ int& dl(int s) { return dl_[s * G]; }
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[static_cast<long long>(s) * G * RC + i];
  }
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
  return true;
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
template <int SPT, bool BANK, bool EXT>
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
  if constexpr (!EXT) {
    // the instance for simple units alone: the count, deadline and
    // occupancy code compiles away (and with it their registers)
    if (g.has_count || g.has_absent) __trap();  // the caller picks EXT
    g.has_count = g.has_absent = 0;
    g.occ_hi = -1;
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
      for (int i = 0; i < RC; ++i) a.caps[sk * RC + i] = a.caps_in[sk * RC + i];
    }
  }
  int arm_seq = lane_ok ? a.armseq_in[lane] : 0;
  int drop = lane_ok ? a.dropped_in[lane] : 0;
  int armed = (lane_ok && g.arm_once) ? a.armed_in[lane] : 0;
  int cnt = 0;                          // matches of this lane so far
  int lmt = 0, lmk = 0;                 // bank: the lane's last match
  const int* u0 = unit(g, 0);

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
// (smem above the limit: no instance fits).
StepPlan plan_step(StepArgs& a, bool bank, size_t limit) {
  a.spt = (a.K + a.G - 1) / a.G;
  a.L = kThreads / a.G;
  // events per tile: both buffers within kTileBytes, a power of two
  int tt = kMaxTileEvents;
  while (tt > 1 && 2LL * (3 + a.A) * a.L * tt * 4 > kTileBytes) tt >>= 1;
  a.TT = tt;
  const int spt = a.spt <= 2 ? a.spt : (a.spt <= 4 ? 4 : 0);
  const int prm_pad = bank ? (a.n_params + 3) & ~3 : 0;
  const size_t base =
      static_cast<size_t>(((a.prog_len + 3) & ~3) + prm_pad) * 4 +
      2ull * (3 + a.A) * a.L * a.TT * 4;
  const size_t caps_smem = static_cast<size_t>(kThreads) * spt * a.RC * 4;
  if (spt > 0 && base + caps_smem <= limit) return {spt, base + caps_smem};
  return {0, base};
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

// a leaf every spec's carry has is null (the optional leaves are the
// caller's to match to the program: ops/nfa._check_carry)
bool missing_leaves(const CarryPtrs& i, const CarryOut& o) {
  return !i.st || !i.start || !i.enter || !i.seq || !i.armseq || !i.caps ||
         !i.dropped || !o.st || !o.start || !o.enter || !o.seq ||
         !o.armseq || !o.caps || !o.dropped;
}

}  // namespace
