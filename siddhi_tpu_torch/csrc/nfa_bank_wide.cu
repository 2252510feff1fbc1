// The pattern bank's widened thread instance for NVIDIA Hopper (sm_90a):
// the bank step for the programs of ops/nfa.kernel_wide (logical units,
// SEQUENCE, the `every` forms, leading min-0 counts and absent units,
// telemetry, a capture compare or program in the first condition) on the
// thread instance's mapping, csrc/nfa_step.cu's nfa_bank_thread_kernel.
//
// Replaces siddhi_tpu/ops/nfa.py:1167 build_bank_step and :1266
// build_super_bank_step (the step vmapped over the patterns) for those
// programs, as csrc/nfa_wide.cu's nfa_bank_step_wide (the group mapping:
// G threads a lane, a CTA a (lane tile, pattern)) does for the specs this
// instance does not take (K > 16, more than 8 constant compares, a column
// past shared memory).  Its contract is ops/nfa.bank_lanes_plain's: per
// (pattern, lane) the carry, the match count and the last match (ts,
// lowest matched slot); its CPU model is ops/nfa.bank_thread_model.
//
// What bounds it: the bank step's bytes (nfa_step.cu: the carry read and
// written once, the block read once; in place, what the data needs); the
// group mapping on the widened loop lost 99% of that to instructions
// (23.05 ms a launch for the SEQUENCE bank at 100 patterns x 10,000 lanes,
// 0.55% of its bound; chip_smoke.py phase 11), for nfa_step.cu's three
// reasons: G threads did one lane's event work through ballots, prefix
// popcounts and shuffle sweeps; each CTA staged its own copy of a lane
// tile 99 other patterns share; every valid event ran the whole unit loop
// for every pattern.  The design, the thread instance's answer to each:
//  - one thread per (pattern, lane) holds the lane's K slots, every word
//    of a slot (state, start, enter, seq, count and deadline words,
//    lmask, captures) in its shared-memory column, with the event's
//    per-slot arrays (the states the unit loop starts from, the pending
//    ranks, the clones' sources, the clone ranks) and its telemetry row;
//    it runs nfa_step.cuh's Wide::event under the thread policy (TH: a
//    ballot is the slot's bit, the first free slot a find-first-set, a
//    pending rank a K x K compare over the column, the clones' captures
//    copied inside the column, no warp intrinsic), the slot loops rolled;
//  - a CTA is 8 warps over one tile of 32 lanes, a warp 32 consecutive
//    lanes of one pattern; when one tile holds the block the CTA stages
//    it once and walks 4 groups of 8 patterns over it (any longer T is
//    tiled, double buffered, one group a CTA); the program, the
//    constants and the carry arrive by cp.async;
//  - the candidate skip: per lane and condition the tile's events that
//    pass the CTA's union of each constant compare's intervals; an event
//    is live for a thread when a condition it needs (ops/nfa.
//    wide_need_table: unit 0's, a leading min-0 count's unit 1, and per
//    slot those of its unit, the counts that append while it waits
//    there, and of the units a deadline lands it at) survives its own
//    intervals.  A dead event is the plain step with the row's gate word
//    zero.  The thread runs it as that full step where a zero gate word
//    still changes the lane (a SEQUENCE partial that a real event kills,
//    a leading absent unit or min-0 count armed on any event, a deadline
//    due, a single-shot SEQUENCE's first real event); elsewhere it cuts
//    it to `within` expiry and, with telemetry, a fail for each slot at a
//    unit whose stream the event is on.
// In place (the fleet path) a thread reads its slot states and lane
// scalars (and the deadlines, lmask, telemetry row and slot 0's
// captures where the spec has them: a slot armed here may keep the
// carry's stale deadline or lmask, and unit 0's condition may read slot
// 0's captures), the rest of its lane only if the lane holds a partial;
// it writes back what changed: a lane that held no partial writes the
// words of the slots it armed, the telemetry row when a counter moved.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "nfa_bank.cuh"

namespace {

// the widened leaves and the column's shape, beside the thread
// instance's arguments
struct BankWideArgs : BankArgs {
  const int *lm_in, *sf_in, *tel_in;
  int *lm, *sf, *tel;     // lmask [CN, P, K], seq_froze [CN, P], telem
                          // [CN, P, tel_w] (null: the spec has none)
  int tel_w;              // 3S + 1 with telemetry, else 0
  int arrays;             // the event's per-slot arrays (Wide::arr)
  int S;                  // the program's units
  int first_reads;        // unit 0's condition reads slot 0's captures
};

// A thread's column in words from its base (each word a row of kThreads
// floats): the captures (K * RC), then rows of K words: enter, seq,
// state, start, deadline (absent units), cnt_cur and cnt_prev (count
// units), lmask (logical units), the event's per-slot arrays; then the
// telemetry row (tel_w words).  ops/nfa.bank_wide_words mirrors it.
struct WideRows {
  int enter, seq, st, start, dl, cc, cp, lm, arr, tel, end;
};

__host__ __device__ inline WideRows wide_rows(const BankWideArgs& a) {
  const int K = a.K;
  WideRows r;
  int x = K * a.RC;
  r.enter = x;
  r.seq = x += K;
  r.st = x += K;
  r.start = x += K;
  r.dl = x += K;
  if (a.absent) x += K;
  r.cc = x;
  r.cp = a.counts ? x += K : x;
  if (a.counts) x += K;
  r.lm = x;
  if (a.lm_in) x += K;
  r.arr = x;
  r.tel = x += K * a.arrays;
  r.end = x + a.tel_w;
  return r;
}

// bank_layout's regions, then each thread's column (wide_rows) and the
// need table (one word a unit)
struct WideLayout {
  BankLayout b;
  int need, end;
};

__host__ __device__ inline WideLayout wide_layout(const BankWideArgs& a) {
  WideLayout w;
  w.b = bank_layout(a);
  w.need = w.b.col + kThreads * wide_rows(a).end;
  w.end = w.need + ((a.S + 3) & ~3);
  return w;
}

// The conditions a slot waiting at unit j can read in an event: its
// unit's (both sides of a logical one), those of the counts that append
// while it waits there, and, for an absent unit, those of the unit a
// deadline lands it at (SEQUENCE confirms a due absence before the event
// steps), transitively.
__device__ __forceinline__ unsigned need_of(const Prog& g, int j) {
  unsigned r = 0;
  for (int hop = 0; j >= 0 && j < g.S && hop <= g.S; ++hop) {
    const int* u = unit(g, j);
    if (u[uCond] >= 0) r |= 1u << u[uCond];
    if (u[uKind] == kLogical && unit_b(g, j)[bCond] >= 0)
      r |= 1u << unit_b(g, j)[bCond];
    if (g.has_count) {
      if (u[uApp0] >= 0) r |= 1u << unit(g, u[uApp0])[uCond];
      if (u[uApp1] >= 0) r |= 1u << unit(g, u[uApp1])[uCond];
    }
    if (u[uKind] != kAbsent) break;
    j = u[uLand];
  }
  return r;
}

// One thread per (pattern, lane), its K <= KM slots in its shared-memory
// column, each event Wide::event under the thread policy (see the notes
// above); kBankLanes maps the threads as in nfa_bank_thread_kernel.
template <int KM>
__global__ void __launch_bounds__(kThreads, 2)
    nfa_bank_wide_kernel(BankWideArgs a) {
  constexpr int LT = kBankLanes;                  // lanes of the tile
  constexpr int NPC = kThreads / LT;              // patterns of a group
  extern __shared__ int smem[];
  const int tid = threadIdx.x, wl = tid & 31, w = tid >> 5;
  const int l = LT == 32 ? wl : w;
  const int pi = LT == 32 ? w : wl;               // pattern in a group
  const int NG = NPC * a.groups;                  // patterns of the CTA
  const int pat0 = blockIdx.y * NG;
  const int p0 = blockIdx.x * LT;
  const int p = p0 + l;
  const int NA = 3 + a.A;
  const int RC = a.RC, K = a.K;
  const WideLayout lay = wide_layout(a);
  const WideRows wr = wide_rows(a);
  int* sprog = smem;
  float* sprm = reinterpret_cast<float*>(smem + lay.b.prm);
  float4* spc = reinterpret_cast<float4*>(smem + lay.b.pc);
  int* tiles = smem + lay.b.tiles;
  unsigned* sneed = reinterpret_cast<unsigned*>(smem + lay.need);
  float* col = reinterpret_cast<float*>(smem + lay.b.col) + tid;
  ColSlots sl;
  sl.cap = col;
  sl.RC = RC;
  sl.K = K;
  sl.xenter = wr.enter;
  sl.xseq = wr.seq;
  sl.xst = wr.st;
  sl.xstart = wr.start;
  sl.xdl = wr.dl;
  sl.xcc = wr.cc;
  sl.xcp = wr.cp;
  sl.xlm = wr.lm;
  sl.xa = wr.arr;
  int* stel = a.tel_w ? reinterpret_cast<int*>(col + wr.tel * kThreads)
                      : nullptr;
  auto rowp = [&](int x) { return col + x * kThreads; };

  for (int i = tid; i < a.prog_len; i += kThreads)
    cp_async4(sprog + i, a.prog + i);
  for (int i = tid; i < NG * a.n_params; i += kThreads) {
    const int n = pat0 + i / a.n_params;
    if (n < a.CN)
      cp_async4(sprm + i, a.params + static_cast<long long>(n) *
                                         a.n_params + i % a.n_params);
  }
  cp_async_commit();
  bank_stage<LT>(tiles, 0, a, p0);
  cp_async_commit();

  // a group's carry: the slot states, lane scalars and hot words (the
  // deadlines, lmask, telemetry row and slot 0's captures where the spec
  // has them); the cold words (start, enter, seq, count words, captures)
  // not in place, or in place for a lane that holds a partial
  const bool inplace = a.inplace;
  int pat = 0;
  long long lane = 0, lk = 0;
  bool on = false, cold = false;
  int arm_seq = 0, drop = 0, armed = 0, sf = 0;
  auto load_group = [&](int r) {
    pat = pat0 + r * NPC + pi;
    on = p < a.P && pat < a.CN;
    lane = static_cast<long long>(pat) * a.P + p;
    lk = lane * K;
    cold = false;
#pragma unroll 1
    for (int s = 0; s < K; ++s) sl.st(s) = -1;
    if (!on) return;
    int v[KM];
    load_words<KM>(v, a.st_in + lk, K, a.vec_slots);
#pragma unroll
    for (int s = 0; s < KM; ++s) {
      if (s >= K) break;
      sl.st(s) = v[s];
      cold |= v[s] >= 0;
    }
    cold |= !inplace;
    arm_seq = a.armseq_in[lane];
    drop = a.dropped_in[lane];
    armed = a.armed_in ? a.armed_in[lane] : 0;
    sf = a.sf_in ? a.sf_in[lane] : 0;
    if (a.absent) load_col(rowp(wr.dl), a.dl_in + lk, K);
    if (a.lm_in) load_col(rowp(wr.lm), a.lm_in + lk, K);
    if (stel) load_col(rowp(wr.tel), a.tel_in + lane * a.tel_w, a.tel_w);
    if (cold) {
      load_col(rowp(wr.start), a.start_in + lk, K);
      load_col(rowp(wr.enter), a.enter_in + lk, K);
      load_col(rowp(wr.seq), a.seq_in + lk, K);
      if (a.counts) {
        load_col(rowp(wr.cc), a.cc_in + lk, K);
        load_col(rowp(wr.cp), a.cp_in + lk, K);
      }
      load_col(col, a.caps_in + lk * RC, K * RC);
    } else if (a.first_reads) {
      load_col(col, a.caps_in + lk * RC, RC);
    }
  };
  load_group(0);                        // while the first tile lands
  cp_async_commit();                    // waited with the first tile
  cp_async_wait<2>();
  __syncthreads();                      // the program is in shared memory

  Prog g = parse(sprog);
  // the caller picks the instance and the build: a widened program with
  // at most kBankMaxPcmp constant compares, its leaves as the C entry
  // was told (condition programs in the -DNFA_PROG=1 build)
  if (!sprog[12] || g.n_pcmp > kBankMaxPcmp || g.S != a.S ||
      a.tel_w != (g.telem ? 3 * g.S + 1 : 0) ||
      (a.lm_in != nullptr) != (g.has_logical != 0) ||
      (a.cc_in != nullptr) != (g.has_count != 0) ||
      (a.dl_in != nullptr) != (g.has_absent != 0) ||
      (g.n_mid > 0 && a.arrays < 4 + g.n_mid) ||
      (g.tail_every >= 0 && a.arrays < 2))
    __trap();
  if constexpr (!kProg) {
    if (g.np) __trap();
    g.np = 0;
  }
  BankCta<LT> cta{a, spc, smem + lay.b.mask, NG, g.n_pcmp, l};
  cta.intervals(g, sprm, pat0);
  for (int j = tid; j < g.S; j += kThreads) sneed[j] = need_of(g, j);
  __syncthreads();
  cta.join();

  const unsigned cmask = (1u << g.n_cond) - 1u;
  const int S = g.S;
  const int tt_sh = __ffs(a.TT) - 1;
  // unit 0's conditions (arming), and a leading min-0 count's unit 1
  // (the virgin chain it arms)
  const unsigned need0 = sneed[0] | (g.eps && S > 1 ? sneed[1] : 0u);

  // Wide's StepArgs: the slot count and capture words (the bank writes
  // no rows)
  StepArgs wa{};
  wa.K = K;
  wa.RC = RC;
  const int n_tiles = (a.T + a.TT - 1) / a.TT;
  for (int r = 0; r < a.groups; ++r) {  // groups > 1: one tile, staged once
    if (r > 0) {
      load_group(r);
      cp_async_commit();
      cp_async_wait<0>();
    }
    const int n = r * NPC + pi;           // this pattern in the CTA
    if constexpr (kProg) g.prm = sprm + n * a.n_params;
    Wide<KM, true, true> wd{g, wa, sl, stel, nullptr, 1, 0, 0, l, p, K,
                            0, on, 0u, arm_seq, drop, armed, sf, 0};
    wd.LT = a.arr;
    wd.lmt = wd.lmk = 0;
    wd.wfull = wd.wcs = 0;
    wd.bind();
    bool dirty = false, tdirty = false;
    // bit s: slot s is used (state >= 0), live (>= 1: `within` expires
    // it), waits at an absent unit; the lane's dead events that need the
    // full step: any valid one (force_v: a leading min-0 count with no
    // virgin chain), any real one (force_r: a leading absent unit with no
    // partial at it, a SEQUENCE partial, a single-shot SEQUENCE not yet
    // armed)
    unsigned used = 0, live = 0, wait = 0;
    bool force_v = false, force_r = false;
    auto masks = [&]() {
      used = live = wait = 0;
      bool have0 = false, virgin = false;
#pragma unroll 1
      for (int s = 0; s < K; ++s) {
        const int x = sl.st(s);
        if (x < 0) continue;
        used |= 1u << s;
        if (x >= 1) live |= 1u << s;
        if (g.has_absent && unit(g, x)[uKind] == kAbsent) wait |= 1u << s;
        have0 |= x == 0;
        virgin |= g.eps && x == 1 && (!g.is_seq || sl.cp(s) >= 0);
      }
      force_v = g.eps && !virgin && (!g.arm_once || wd.armed == 0);
      force_r = (g.lead_absent && !have0) || (g.is_seq && used) ||
                (g.arm_once && g.is_seq && wd.armed == 0);
    };
    auto needs = [&]() {
      unsigned x = need0;
      for (unsigned b = used; b; b &= b - 1)
        x |= sneed[static_cast<int>(sl.st(__ffs(b) - 1))];
      return x;
    };
    for (int it = 0; it < n_tiles; ++it) {
      const int* cur = tiles + (it & 1) * NA * a.arr;
      const int tn = min(a.TT, a.T - it * a.TT);
      if (r == 0) {
        if (it + 1 < n_tiles) {
          bank_stage<LT>(tiles + ((it + 1) & 1) * NA * a.arr,
                         (it + 1) * a.TT, a, p0);
          cp_async_commit();
        }
        for (int i = tid; i < g.n_cond * cta.mstride; i += kThreads)
          cta.smask[i] = 0;
        if (it + 1 < n_tiles) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncthreads();
        cta.mark(cmask, cur, tn, p0, tt_sh);
        __syncthreads();
      }
      const int* row = cur + l * a.stride;
      if (on) masks();                    // the column has landed
      for (int wd32 = 0; on && wd32 < ((tn + 31) >> 5); ++wd32) {
        const int jb = wd32 << 5, je = min(tn, jb + 32);
        unsigned need = needs();
        unsigned al = cta.live_from(row, wd32, jb, need, n);
        for (int j = jb; j < je; ++j) {
          // no dead event changes the lane: on to the next live one
          if (!force_v && !force_r && !wait && !(g.has_within && live) &&
              !(stel && used)) {
            const unsigned rest = al & (~0u << (j - jb));
            if (!rest) break;
            j = jb + __ffs(rest) - 1;
          }
          const unsigned raw = static_cast<unsigned>(row[2 * a.arr + j]);
          const bool valid = raw & kValidBit;
          const int tsv = row[j];
          const int sv = row[a.arr + j];
          bool full = (al >> (j - jb)) & 1u;
          unsigned gw = full ? cta.gate(row, j, n) : raw & kValidBit;
          if (!full && valid) {
            full = force_v || (sv != -2 && force_r);
            for (unsigned b = wait; !full && b; b &= b - 1)
              full = static_cast<int>(sl.dl(__ffs(b) - 1)) <= tsv;
          }
          if (full) {
            // the plain step's order (Wide::event), with the pattern's
            // gate word or, for a dead event, a zero one
            wd.t = it * a.TT + j;
            wd.tsv = tsv;
            wd.sv = sv;
            wd.gw = gw;
            wd.at = reinterpret_cast<const float*>(row + 3 * a.arr + j);
            wd.v = valid;
            wd.event();
            dirty = true;
            tdirty |= stel != nullptr;
            masks();
            const unsigned nn = needs();
            if (nn & ~need) {
              need |= nn;
              al = cta.live_from(row, wd32, j + 1, need, n);
            }
            continue;
          }
          // a dead event that only expires slots and, with telemetry,
          // counts a fail for each slot at a unit whose stream it is on
          if (g.has_within && live && wd.expire(tsv, live)) {
            dirty = true;
            tdirty |= stel != nullptr;
            masks();
          }
          if (stel && valid) {
            for (unsigned b = used; b; b &= b - 1) {
              const int x = sl.st(__ffs(b) - 1);
              const int* ub = unit_b(g, x);
              if (sv == unit(g, x)[uStream] ||
                  (ub[bCond] >= 0 && sv == ub[bStream])) {
                wd.tel_add(2 * S + x, 1);
                tdirty = true;
              }
            }
          }
        }
      }
      if (n_tiles > 1) __syncthreads();   // the tile is free to refill
    }
    if (!on) continue;
    // the plain step's padding rows (invalid, at the last event's ts) run
    // only the `within` expiry: once more at that ts
    if (a.pad_within && g.has_within && a.T > 0) {
      const int tl = a.ts[static_cast<long long>(p) * a.T + a.T - 1];
      if (wd.expire(tl, ~0u)) {
        dirty = true;
        tdirty |= stel != nullptr;
      }
    }
    if (stel && a.T > 0) {                // the occupancy gauge
      for (int j = 0; j < S; ++j) {
        int c = 0;
#pragma unroll 1
        for (int s = 0; s < K; ++s) c += static_cast<int>(sl.st(s)) == j;
        if (stel[j * kThreads] != c) {
          stel[j * kThreads] = c;
          tdirty = true;
        }
      }
    }

    // in place needs no barrier: these words were read by this thread
    // alone; in place, words that did not change are not written
    if (!inplace || dirty) {
      store_col(rowp(wr.st), a.st + lk, K, a.vec_slots);
      a.armseq[lane] = wd.arm_seq;
      a.dropped[lane] = wd.drop;
      if (a.armed) a.armed[lane] = wd.armed;
      if (a.sf) a.sf[lane] = wd.sf;
      if (a.absent) store_col(rowp(wr.dl), a.dl + lk, K, a.vec_slots);
      if (a.lm) store_col(rowp(wr.lm), a.lm + lk, K, a.vec_slots);
    }
    if (cold) {
      if (!inplace || dirty) {
        store_col(rowp(wr.start), a.start + lk, K, a.vec_slots);
        store_col(rowp(wr.enter), a.enter + lk, K, a.vec_slots);
        store_col(rowp(wr.seq), a.seq + lk, K, a.vec_slots);
        if (a.counts) {
          store_col(rowp(wr.cc), a.cc + lk, K, a.vec_slots);
          store_col(rowp(wr.cp), a.cp + lk, K, a.vec_slots);
        }
        store_col(col, a.caps + lk * RC, K * RC, a.vec_caps);
      }
    } else {
      // a lane that held no partial: the slots this block armed
      for (unsigned b = wd.wfull | wd.wcs; b; b &= b - 1) {
        const int s = __ffs(b) - 1;
        const long long sk = lk + s;
        a.start[sk] = sl.start(s);
        if ((wd.wfull >> s) & 1u) {
          a.enter[sk] = sl.enter(s);
          a.seq[sk] = sl.seq(s);
          if (a.counts) {
            a.cc[sk] = sl.cc(s);
            a.cp[sk] = sl.cp(s);
          }
        }
        for (int i = 0; i < RC; ++i) a.caps[sk * RC + i] = sl.c(s, i);
      }
    }
    if (stel && (!inplace || tdirty))
      store_col(rowp(wr.tel), a.tel + lane * a.tel_w, a.tel_w, false);
    a.count[lane] = wd.cnt;
    a.lmt[lane] = wd.lmt;
    a.lmk[lane] = wd.lmk;
  }
}

}  // namespace

// Launch the bank step's widened thread instance (one thread per
// (pattern, lane), a widened program with K <= 16 and at most 8 constant
// compares; condition programs from the -DNFA_PROG=1 build) over CN
// patterns on `stream`: csrc/nfa_step.cu nfa_bank_thread's arguments
// (TT, smem and groups from ops/nfa.bank_geometry, which sizes the
// layout with the widened column), then the widened leaves in and out
// (lmask [CN, P, K], seq_froze [CN, P], telem [CN, P, tel_w]; null where
// the spec's carry has none; in and out may be the same tensors), tel_w
// (3S + 1 with telemetry, else 0), arrays (the event's per-slot arrays:
// 1, 2 with a trailing `every`, 4 + n_mid with mid-chain `every`
// groups), S (the program's units) and first_reads (unit 0's condition
// reads slot 0's captures).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int nfa_bank_thread_wide(
    const float* attrs, const int* ts, const int* strm, const int* gates,
    const int* prog, int prog_len, const float* params, int n_params,
    CARRY_PARAMS, int* count, int* lmt, int* lmk, int CN, int P, int T,
    int K, int TT, int A, int RC, int smem, int groups, int n_cond,
    int pad_within, const int* lm_in, const int* sf_in, const int* tel_in,
    int* lm, int* sf, int* tel, int tel_w, int arrays, int S,
    int first_reads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || CN <= 0) return 0;
  BankWideArgs a{};
  if (!make_thread_args(a, attrs, ts, strm, gates, prog, prog_len, params,
                        n_params, CARRY_IN, CARRY_OUT, count, lmt, lmk, CN,
                        P, T, K, TT, A, RC, groups, n_cond, pad_within) ||
      S < 1 || arrays < 1 ||
      bad_wide(lm_in, sf_in, tel_in, lm, sf, tel, kFlagWide, tel_w))
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec_slots = a.vec_slots && (!lm || aligned16(lm));
  a.inplace = a.inplace && lm == lm_in && sf == sf_in && tel == tel_in;
  a.lm_in = lm_in;
  a.sf_in = sf_in;
  a.tel_in = tel_in;
  a.lm = lm;
  a.sf = sf;
  a.tel = tel;
  a.tel_w = tel_w;
  a.arrays = arrays;
  a.S = S;
  a.first_reads = first_reads != 0;
  if (static_cast<size_t>(smem) > kSmemLimit ||
      static_cast<long long>(wide_layout(a).end) * 4 > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*const k)(BankWideArgs) = K <= 4   ? nfa_bank_wide_kernel<4>
                                   : K <= 8 ? nfa_bank_wide_kernel<8>
                                            : nfa_bank_wide_kernel<16>;
  return launch_bank(k, a, smem, s);
}
