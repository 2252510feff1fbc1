// Batched pattern (NFA) block step with fused egress compaction, for
// NVIDIA Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/nfa.py:579 _one_partition_step as the JAX package
// runs it under :1110 build_block_step (lax.scan over the block's T events
// inside vmap over P partition lanes), followed by the match compaction
// siddhi_tpu/plan/nfa_compiler.py:1837 pack (jnp.nonzero(size=cap) and
// gathers).  Contract (siddhi_tpu_torch/ops/nfa.py, nfa_block_step_plain
// then egress_pack_plain): per lane p, for each event t in order, within
// expiry of live partials, one transition per slot waiting at a unit whose
// condition holds (capture row written, advance or complete), then arming
// of a fresh partial at unit 0 in the first free slot; a NEW carry (the
// input carry is only read: grow-and-replay re-runs a chunk from it) and
// the egress slab [cap + 1, 4 + R*C] int32 of the matched slots in
// ascending flat index (p*T + t)*K + k: index, ts, enter, seq, capture row
// bitcast; rows past the count hold -1 in column 0; the tail row holds the
// true count and the summed `dropped`.  One status row follows the tail:
// the fullest scratch segment's row count and the segment size (the
// caller re-runs the step with larger segments when the first exceeds the
// second).  The dense [P, T, K, ...] outputs never reach device memory.
//
// The kernels' class (ops/nfa.kernel_class_reason and the compiler's
// condition split): every unit simple; PATTERN; `every` on the leading
// unit or none (arm_once); optional `within`; no telemetry.  Condition i
// is bit i of a block-wide gate word (its capture-free part, computed by
// the torch condition program) AND a table of `event lane <op> capture
// lane` compares; bit 31 of the word is the event's __valid.
//
// Arithmetic is exact: the only float work is the IEEE compares of the
// table (a NaN operand makes < <= > >= == false and != true, as torch's)
// and copies; int32 timestamp offsets subtract with two's-complement wrap.
//
// What bounds it on this card.  The function reads the block's inputs
// once, P*T*(4*n_lanes + 4 ts + 4 stream + 1 valid + n_gates) bytes, reads
// and writes the carry once (P*K*(16 + 4*R*C) + P*12 each way), and writes
// the slab, (4 + R*C)*4 bytes per matched slot.  At the main path's shape
// (P = 16384, T ~ 50, K = 8, R*C = 2, ~7,600 matches) that is ~19 MB
// against ~10^8 integer compares and selects: bound by bytes, ~6 us on
// HBM3 (chip_smoke.py computes it per launch).
//
// The design.
//  - nfa_step: a group of G threads per lane, G = K rounded up to a power
//    of two, at most 32, so at K = 8 four lanes share a warp and every
//    thread works; thread `gl` of a group owns slots gl, gl + G, ...
//    Instances for 1, 2 and 4 slots per thread keep state, start, enter
//    and seq in registers and the capture rows in thread-private shared
//    memory for the whole T loop (read once from the carry, written once
//    at the end).  A wider ring (K > 128) runs the "wide-ring" instance:
//    32 threads per lane working in place in the new carry (device memory,
//    L1-resident), which takes any K.
//  - The CTA's lanes are adjacent rows of the [P, T] inputs: T-tiles of
//    ts, stream, gate word and the kernel's attribute lanes are staged in
//    shared memory with cp.async, double-buffered, each tile a run of
//    coalesced loads per lane row; any T (T = 1 for TIMER and warm blocks,
//    thousands for a skewed key).
//  - Arming takes the first free slot of the lane: __ffs over the group's
//    bits of __ballot_sync, free meaning empty and not completed by this
//    event (from registers).  A completing slot's rank in its lane is the
//    lane's running count plus __popc(ballot & group & lanemask_lt), which
//    keeps (t, k) order; its row goes to the CTA's segment of a scratch
//    buffer at a place taken from a shared-memory counter, tagged with its
//    flat index, lane and rank.  Each lane's count goes to a [P] array and
//    the CTA's true fill (which may exceed the segment) to a [n_cta] array.
//  - nfa_compact: one CTA per step CTA; it sums the fills of the CTAs
//    before it, scans its lanes' counts, scatters each scratch row to
//    slab[offset(p) + rank] when that is below cap, writes -1 into column
//    0 of the rows past the count, and CTA 0 writes the tail (count,
//    summed dropped) and the status row.  A cap overflow re-runs this
//    kernel alone, from the same scratch.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 32 * 1024;   // both tile buffers together: at
                                        // K = 8 five CTAs fit an SM, so
                                        // P = 16384 runs in one wave
constexpr int kMaxTileEvents = 128;
constexpr int kHeader = 8;              // S, R, C, has_within, within_ms,
                                        // arm_once, n_cond, n_cmp
constexpr unsigned kValidBit = 0x80000000u;
constexpr unsigned kFull = 0xffffffffu;

struct Prog {
  int S, R, C, has_within, within, arm_once, n_cond, n_cmp;
  const int* units;       // S x (stream, cond, row)
  const int* row_src;     // R*C: attr index, -1 -> 0.0f, -2 -> 1.0f
  const int* cmp_start;   // n_cond + 1
  const int* cmp;         // n_cmp x (attr, row, lane, op)
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
  g.units = p + kHeader;
  g.row_src = g.units + 3 * g.S;
  g.cmp_start = g.row_src + g.R * g.C;
  g.cmp = g.cmp_start + g.n_cond + 1;
  return g;
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
  int *st, *start, *enter, *seq, *armseq;
  float* caps;
  int *dropped, *armed;
  int* rows;              // [n_cta, seg, 4 + RC + 2]
  int* lane_count;        // [P]
  int* fill;              // [n_cta]
  int prog_len, P, T, K, G, spt, L, TT, seg, A, RC;
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

// Slot storage.  SPT > 0: this thread's SPT slots in registers, their
// capture rows in its own column of shared memory (stride kThreads, so a
// warp's accesses never share a bank).
template <int SPT>
struct Slots {
  int st_[SPT], start_[SPT], enter_[SPT], seq_[SPT];
  float* cap;
  int RC;
  __device__ __forceinline__ int& st(int s) { return st_[s]; }
  __device__ __forceinline__ int& start(int s) { return start_[s]; }
  __device__ __forceinline__ int& enter(int s) { return enter_[s]; }
  __device__ __forceinline__ int& seq(int s) { return seq_[s]; }
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[(s * RC + i) * kThreads];
  }
};

// The wide-ring instance: the slots live in the new carry, slot s of this
// thread at k = gl + s*G.
template <>
struct Slots<0> {
  int *st_, *start_, *enter_, *seq_;
  float* cap;
  int G, RC;
  __device__ __forceinline__ int& st(int s) { return st_[s * G]; }
  __device__ __forceinline__ int& start(int s) { return start_[s * G]; }
  __device__ __forceinline__ int& enter(int s) { return enter_[s * G]; }
  __device__ __forceinline__ int& seq(int s) { return seq_[s * G]; }
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

// the event's lanes into capture row `row` of slot s
template <class SL>
__device__ __forceinline__ void write_row(const Prog& g, int row, SL& sl,
                                          int s, const float* at, int LT) {
  for (int c = 0; c < g.C; ++c) {
    const int src = g.row_src[row * g.C + c];
    sl.c(s, row * g.C + c) =
        src >= 0 ? at[src * LT] : (src == -2 ? 1.0f : 0.0f);
  }
}

// one matched slot's scratch row: flat index, ts, enter, seq, captures,
// rank in its lane, lane in the CTA
template <class SL>
__device__ __forceinline__ void emit_row(const StepArgs& a, SL& sl, int s,
                                         int pos, int p, int t, int k,
                                         int tsv, int enter, int seq,
                                         int rank, int l) {
  if (pos >= a.seg) return;
  const int W = 4 + a.RC;
  int* r = a.rows + (static_cast<long long>(blockIdx.x) * a.seg + pos) *
                        (W + 2);
  r[0] = static_cast<int>((static_cast<long long>(p) * a.T + t) * a.K + k);
  r[1] = tsv;
  r[2] = enter;
  r[3] = seq;
  for (int i = 0; i < a.RC; ++i) r[4 + i] = __float_as_int(sl.c(s, i));
  r[W] = rank;
  r[W + 1] = l;
}

template <int SPT>
__global__ void __launch_bounds__(kThreads) nfa_step_kernel(StepArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_fill;
  const int tid = threadIdx.x;
  const int prog_pad = (a.prog_len + 3) & ~3;
  const int LT = a.L * a.TT;
  const int tile_ints = (3 + a.A) * LT;
  int* sprog = smem;
  int* tiles = smem + prog_pad;
  const int p0 = blockIdx.x * a.L;

  for (int i = tid; i < a.prog_len; i += kThreads) sprog[i] = a.prog[i];
  if (tid == 0) s_fill = 0;
  load_tile(tiles, 0, a, p0);
  cp_async_commit();
  __syncthreads();

  const Prog g = parse(sprog);
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
  const long long lane_k = static_cast<long long>(p) * a.K;

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
      for (int i = 0; i < RC; ++i)
        sl.c(s, i) = on ? a.caps_in[sk * RC + i] : 0.0f;
    }
  } else {
    sl.st_ = a.st + lane_k + gl;
    sl.start_ = a.start + lane_k + gl;
    sl.enter_ = a.enter + lane_k + gl;
    sl.seq_ = a.seq + lane_k + gl;
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
      for (int i = 0; i < RC; ++i) a.caps[sk * RC + i] = a.caps_in[sk * RC + i];
    }
  }
  int arm_seq = lane_ok ? a.armseq_in[p] : 0;
  int drop = lane_ok ? a.dropped_in[p] : 0;
  int armed = (lane_ok && g.arm_once) ? a.armed_in[p] : 0;
  int cnt = 0;                          // rows this lane emitted so far
  const int* u0 = g.units;

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
      const unsigned gw = static_cast<unsigned>(cur[2 * LT + e]);
      const float* at = reinterpret_cast<const float*>(cur + 3 * LT) + e;
      const bool v = lane_ok && (gw & kValidBit);
      int ffree = -1;                   // first free slot of the lane

      // within expiry, then each slot's one transition (ops/nfa.py
      // _one_event_step: within, main transitions, land)
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        const int k = gl + s * G;
        bool m = false, fr = false;
        if (lane_ok && k < a.K) {
          int st = sl.st(s);
          if (g.has_within && st >= 1 &&
              static_cast<int>(static_cast<unsigned>(tsv) -
                               static_cast<unsigned>(sl.start(s))) > g.within)
            st = -1;
          if (v && st >= 0 && st < g.S) {
            const int* u = g.units + 3 * st;
            if (sv == u[0] && cond_ok(g, u[1], gw, sl, s, at, LT)) {
              if (u[2] >= 0) write_row(g, u[2], sl, s, at, LT);
              if (st + 1 >= g.S) {
                m = true;
                st = -1;
              } else {
                st += 1;
                sl.enter(s) = tsv;
              }
            }
          }
          sl.st(s) = st;
          fr = st < 0 && !m;
        }
        const unsigned bf = __ballot_sync(kFull, fr) & gmask;
        if (ffree < 0 && bf) ffree = s * G + (__ffs(bf) - 1 - gbase);
        const unsigned bm = __ballot_sync(kFull, m);
        if (bm) {                       // a row for each matched slot
          const unsigned mine = bm & gmask;
          int base = 0;
          if (mine && gl == 0) base = atomicAdd(&s_fill, __popc(mine));
          base = __shfl_sync(kFull, base, gbase);
          if (m) {
            const int off = __popc(mine & ltmask);
            emit_row(a, sl, s, base + off, p, t, k, tsv, sl.enter(s),
                     sl.seq(s), cnt + off, l);
          }
          cnt += __popc(mine);
        }
      }

      // arming at unit 0: the first free slot, free meaning empty and not
      // completed by this event
      const bool c0 = v && sv == u0[0] && ((gw >> u0[1]) & 1u);
      const bool want = c0 && (!g.arm_once || armed == 0);
      const bool arm_match = want && ffree >= 0 && g.S == 1;
      int abase = 0;
      if (__ballot_sync(kFull, arm_match)) {
        if (arm_match && gl == 0) abase = atomicAdd(&s_fill, 1);
        abase = __shfl_sync(kFull, abase, gbase);
      }
      if (want) {
        if (ffree >= 0) {
          if (g.arm_once) armed += 1;
#pragma unroll
          for (int s = 0; s < ns; ++s) {
            if (gl + s * G != ffree) continue;
            for (int i = 0; i < RC; ++i) sl.c(s, i) = 0.0f;
            if (u0[2] >= 0) write_row(g, u0[2], sl, s, at, LT);
            sl.start(s) = tsv;
            if (g.S == 1) {             // a one-unit chain completes as it
                                        // arms; the slot stays empty
              emit_row(a, sl, s, abase, p, t, ffree, tsv, tsv, arm_seq, cnt,
                       l);
            } else {
              sl.st(s) = 1;
              sl.enter(s) = tsv;
              sl.seq(s) = arm_seq;
            }
          }
          arm_seq += 1;
        } else {
          drop += 1;
        }
      }
      cnt += arm_match ? 1 : 0;
    }
    __syncthreads();                    // the tile is free to refill
  }

  if constexpr (SPT > 0) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int k = gl + s * G;
      if (!(lane_ok && k < a.K)) continue;
      const long long sk = lane_k + k;
      a.st[sk] = sl.st(s);
      a.start[sk] = sl.start(s);
      a.enter[sk] = sl.enter(s);
      a.seq[sk] = sl.seq(s);
      for (int i = 0; i < RC; ++i) a.caps[sk * RC + i] = sl.c(s, i);
    }
  }
  if (lane_ok && gl == 0) {
    a.armseq[p] = arm_seq;
    a.dropped[p] = drop;
    if (g.arm_once) a.armed[p] = armed;
    a.lane_count[p] = cnt;
  }
  if (tid == 0) a.fill[blockIdx.x] = s_fill;
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

// block-wide sum (op 0) or max (op 1); every thread gets the result
__device__ int block_reduce(int x, int op, int* red) {
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5;
  x = op ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (wl == 0) red[w] = x;
  __syncthreads();
  int y = wl < kThreads / 32 ? red[wl] : (op ? INT_MIN : 0);
  y = op ? warp_max(y) : warp_sum(y);
  return y;
}

struct PackArgs {
  const int* rows;
  const int* lane_count;
  const int* fill;
  const int* dropped;
  int* slab;              // [cap + 2, W]
  int P, L, seg, n_cta, cap, W;
};

__global__ void __launch_bounds__(kThreads) nfa_compact_kernel(PackArgs a) {
  __shared__ int s_off[kThreads];
  __shared__ int red[kThreads / 32];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int wl = tid & 31, w = tid >> 5;

  // rows of the CTAs before this one, rows in all, the fullest segment
  int before = 0, total = 0, mx = 0;
  for (int i = tid; i < a.n_cta; i += kThreads) {
    const int f = a.fill[i];
    total += f;
    if (i < c) before += f;
    mx = max(mx, f);
  }
  before = block_reduce(before, 0, red);
  total = block_reduce(total, 0, red);
  mx = block_reduce(mx, 1, red);

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
      else if (i == a.W) val = mx;            // status row
      else if (i == a.W + 1) val = a.seg;
      tail[i] = val;
    }
  }
}

template <int SPT>
int launch_step(const StepArgs& a, size_t smem, int grid, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfa_step_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nfa_step_kernel<SPT><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one block step on `stream`.  G (threads per lane: K rounded up
// to a power of two, at most 32) and seg (scratch rows per CTA) come from
// the caller, which sizes rows as ceil(P / (256 / G)) * seg * (6 + RC)
// int32.  Returns cudaGetLastError() after the launch (0 = cudaSuccess);
// the caller raises on anything else.
extern "C" int nfa_step(const float* attrs, const int* ts, const int* strm,
                        const int* gates, const int* prog, int prog_len,
                        const int* st_in, const int* start_in,
                        const int* enter_in, const int* seq_in,
                        const int* armseq_in, const float* caps_in,
                        const int* dropped_in, const int* armed_in, int* st,
                        int* start, int* enter, int* seq, int* armseq_out,
                        float* caps, int* dropped_out, int* armed_out,
                        int* rows, int* lane_count, int* fill, int P, int T,
                        int K, int G, int seg, int A, int RC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return 0;
  if (K <= 0 || T < 0 || G <= 0 || G > 32 || (G & (G - 1)) || seg < 0 ||
      A < 0 || RC <= 0 || prog_len < kHeader)
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a{attrs, ts, strm, gates, prog, st_in, start_in, enter_in,
             seq_in, armseq_in, caps_in, dropped_in, armed_in, st, start,
             enter, seq, armseq_out, caps, dropped_out, armed_out, rows,
             lane_count, fill};
  a.prog_len = prog_len;
  a.P = P;
  a.T = T;
  a.K = K;
  a.G = G;
  a.spt = (K + G - 1) / G;
  a.L = kThreads / G;
  a.seg = seg;
  a.A = A;
  a.RC = RC;
  // events per tile: both buffers within kTileBytes, a power of two
  int tt = kMaxTileEvents;
  while (tt > 1 && 2LL * (3 + A) * a.L * tt * 4 > kTileBytes) tt >>= 1;
  a.TT = tt;
  const int spt = a.spt <= 2 ? a.spt : (a.spt <= 4 ? 4 : 0);
  const size_t base = static_cast<size_t>((prog_len + 3) & ~3) * 4 +
                      2ull * (3 + A) * a.L * a.TT * 4;
  const size_t caps_smem = static_cast<size_t>(kThreads) * spt * RC * 4;
  const size_t limit = 227 * 1024;
  const int grid = (P + a.L - 1) / a.L;
  if (spt > 0 && base + caps_smem <= limit) {
    if (spt == 1) return launch_step<1>(a, base + caps_smem, grid, s);
    if (spt == 2) return launch_step<2>(a, base + caps_smem, grid, s);
    return launch_step<4>(a, base + caps_smem, grid, s);
  }
  if (base > limit) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step<0>(a, base, grid, s);
}

// The compaction of one step's scratch into the slab [cap + 2, W] (rows,
// tail, status).  Returns cudaGetLastError() after the launch.
extern "C" int nfa_compact(const int* rows, const int* lane_count,
                           const int* fill, const int* dropped, int* slab,
                           int P, int L, int seg, int n_cta, int cap, int W,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || n_cta <= 0 || L <= 0 || L > kThreads || cap < 0 || W < 5 ||
      seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a{rows, lane_count, fill, dropped, slab, P, L, seg, n_cta, cap, W};
  nfa_compact_kernel<<<n_cta, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
