// Batched pattern (NFA) block step for NVIDIA Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/nfa.py:579 _one_partition_step as the JAX package
// runs it under :1110 build_block_step: lax.scan over the block's T events
// inside vmap over P partition lanes, an XLA program of ~10^2 small ops per
// event.  Contract (siddhi_tpu_torch/ops/nfa.py, nfa_block_step_plain):
// per lane p, for each event t in order, within-expiry of live partials,
// one transition per slot waiting at a unit whose condition holds (capture
// row written, advance or complete), then arming of a fresh partial at
// unit 0 in the first free slot; the dense outputs (mask, caps, ts, enter,
// seq) per (p, t, slot) and a NEW carry (the input carry is only read: the
// engine's grow-and-replay re-runs a chunk from it).
//
// The kernel's class (ops/nfa.kernel_class_reason and the compiler's
// condition split): every unit simple; PATTERN; `every` on the leading
// unit or none (arm_once); optional `within`; no telemetry.  Condition i is
// bit i of a block-wide gate word (its capture-free part, computed by the
// torch condition program) AND a table of `event lane <op> capture lane`
// compares.  Anything else is rejected when the runtime is built.
//
// Arithmetic is exact: the only float work is the IEEE compares of the
// table (a NaN operand makes < <= > >= == false and != true, as torch's)
// and copies; int32 timestamp offsets subtract with two's-complement wrap,
// as the reference's int32 arrays do.
//
// What bounds it on this card.  Per launch the function reads the block's
// inputs, P*T*(4*n_lanes + 4 ts + 4 stream + 1 valid + n_gates) bytes, the
// carry once and writes it once (P*K*(16 + 4*R*C) + P*12), and writes the
// dense outputs, P*T*K*(1 + 12 + 4*R*C) bytes; its operations are a few
// integer compares and selects per (event, slot).  At the main path's shape
// (P = 16384, T ~ 50, K = 8, R*C = 2) that is ~170 MB against ~10^8
// operations: bound by bytes, ~50 us on HBM3 (chip_smoke.py computes it per
// run).  Nearly all of those bytes are the dense outputs; fusing the egress
// compaction so they never reach HBM is the next step, not this kernel's.
//
// The design (a simple first version): one warp per partition lane, four
// lanes per 128-thread CTA; thread `l` owns slots l, l+32, ... (any K).
// The static program (units, capture-row sources, compare table) is staged
// in shared memory.  Per event every thread reads the event's scalars
// (one broadcast load per warp, the lane's row is contiguous so successive
// events hit the same lines) and steps its own slots, whose state lives in
// the new carry in device memory (L1-resident: a lane's slots are touched by
// its warp only).  Arming takes the first free slot across the lane:
// jnp.argmax(free) becomes __ffs(__ballot_sync(...)) over 32-slot chunks;
// arm_seq, dropped and armed_total are per-lane registers every thread of
// the warp keeps alike.  No thread reads a location another thread wrote,
// so the warp needs no barrier beyond the ballot.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeader = 8;            // S, R, C, has_within, within_ms,
                                      // arm_once, n_cond, n_cmp

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

// condition i of event e against one slot's captures `ck`
__device__ __forceinline__ bool cond_ok(const Prog& g, int i, uint32_t gw,
                                        const float* ck, const float* attrs,
                                        long long e, long long PT) {
  if (!((gw >> i) & 1u)) return false;
  for (int q = g.cmp_start[i]; q < g.cmp_start[i + 1]; ++q) {
    const int* c = g.cmp + 4 * q;
    if (!compare(c[3], attrs[c[0] * PT + e], ck[c[1] * g.C + c[2]]))
      return false;
  }
  return true;
}

// the event's lanes into capture row `row` of one slot
__device__ __forceinline__ void write_row(const Prog& g, int row, float* ck,
                                          const float* attrs, long long e,
                                          long long PT) {
  for (int c = 0; c < g.C; ++c) {
    const int src = g.row_src[row * g.C + c];
    ck[row * g.C + c] =
        src >= 0 ? attrs[src * PT + e] : (src == -2 ? 1.0f : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads) nfa_step_kernel(
    const float* __restrict__ attrs, const int* __restrict__ ts,
    const int* __restrict__ strm, const uint8_t* __restrict__ valid,
    const int* __restrict__ gates, const int* __restrict__ prog,
    int prog_len, const int* __restrict__ st_in,
    const int* __restrict__ start_in, const int* __restrict__ enter_in,
    const int* __restrict__ seq_in, const int* __restrict__ armseq_in,
    const float* __restrict__ caps_in, const int* __restrict__ dropped_in,
    const int* __restrict__ armed_in, int* st, int* start, int* enter,
    int* seq, int* armseq_out, float* caps, int* dropped_out, int* armed_out,
    uint8_t* mask, float* mcaps, int* mts, int* menter, int* mseq, int P,
    int T, int K) {
  extern __shared__ int sprog[];
  for (int i = threadIdx.x; i < prog_len; i += blockDim.x) sprog[i] = prog[i];
  __syncthreads();
  const Prog g = parse(sprog);
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  const int RC = g.R * g.C;
  const long long PT = static_cast<long long>(P) * T;
  const long long lane_k = static_cast<long long>(p) * K;

  // the lane's carry, copied into the new carry and worked on there
  for (int k = lane; k < K; k += 32) {
    const long long sk = lane_k + k;
    st[sk] = st_in[sk];
    start[sk] = start_in[sk];
    enter[sk] = enter_in[sk];
    seq[sk] = seq_in[sk];
    for (int i = 0; i < RC; ++i) caps[sk * RC + i] = caps_in[sk * RC + i];
  }
  int arm_seq = armseq_in[p];
  int drop = dropped_in[p];
  int armed = g.arm_once ? armed_in[p] : 0;
  const int* u0 = g.units;

  for (int t = 0; t < T; ++t) {
    const long long e = static_cast<long long>(p) * T + t;
    const int tsv = ts[e];
    const int sv = strm[e];
    const bool v = valid[e] != 0;
    const uint32_t gw = static_cast<uint32_t>(gates[e]);

    // within expiry, then each slot's one transition (ops/nfa.py :603-611,
    // :734-751, land :401-477)
    for (int k = lane; k < K; k += 32) {
      const long long sk = lane_k + k;
      const long long o = e * K + k;
      float* ck = caps + sk * RC;
      int s = st[sk];
      if (g.has_within && s >= 1 &&
          static_cast<int>(static_cast<unsigned>(tsv) -
                           static_cast<unsigned>(start[sk])) > g.within)
        s = -1;
      bool m = false;
      if (v && s >= 0 && s < g.S) {
        const int* u = g.units + 3 * s;
        if (sv == u[0] && cond_ok(g, u[1], gw, ck, attrs, e, PT)) {
          if (u[2] >= 0) write_row(g, u[2], ck, attrs, e, PT);
          if (s + 1 >= g.S) {
            m = true;
            s = -1;
          } else {
            s += 1;
            enter[sk] = tsv;
          }
        }
      }
      st[sk] = s;
      mask[o] = m ? 1 : 0;
      mts[o] = m ? tsv : 0;
      menter[o] = m ? enter[sk] : 0;
      mseq[o] = m ? seq[sk] : 0;
      float* mc = mcaps + o * RC;
      for (int i = 0; i < RC; ++i) mc[i] = m ? ck[i] : 0.0f;
    }

    // arming at unit 0 (:959-1001): the first free slot, free meaning
    // empty and not completed by this event
    const bool c0 = v && sv == u0[0] && ((gw >> u0[1]) & 1u);
    if (c0 && (!g.arm_once || armed == 0)) {
      int f = -1;
      for (int base = 0; base < K; base += 32) {
        const int k = base + lane;
        const bool fr = k < K && st[lane_k + k] < 0 && !mask[e * K + k];
        const unsigned b = __ballot_sync(0xffffffffu, fr);
        if (b) {
          f = base + __ffs(b) - 1;
          break;
        }
      }
      if (f >= 0) {
        if (g.arm_once) armed += 1;
        if ((f & 31) == lane) {
          const long long sk = lane_k + f;
          float* ck = caps + sk * RC;
          for (int i = 0; i < RC; ++i) ck[i] = 0.0f;
          if (u0[2] >= 0) write_row(g, u0[2], ck, attrs, e, PT);
          start[sk] = tsv;
          if (g.S == 1) {  // a one-unit chain completes as it arms
            const long long o = e * K + f;
            mask[o] = 1;
            mts[o] = tsv;
            menter[o] = tsv;
            mseq[o] = arm_seq;
            for (int i = 0; i < RC; ++i) mcaps[o * RC + i] = ck[i];
          } else {
            st[sk] = 1;
            enter[sk] = tsv;
            seq[sk] = arm_seq;
          }
        }
        arm_seq += 1;
      } else {
        drop += 1;
      }
    }
  }
  if (lane == 0) {
    armseq_out[p] = arm_seq;
    dropped_out[p] = drop;
    if (g.arm_once) armed_out[p] = armed;
  }
}

}  // namespace

// Launch one block step on `stream`.  Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the caller raises on anything else.
extern "C" int nfa_step(const float* attrs, const int* ts, const int* strm,
                        const uint8_t* valid, const int* gates,
                        const int* prog, int prog_len, const int* st_in,
                        const int* start_in, const int* enter_in,
                        const int* seq_in, const int* armseq_in,
                        const float* caps_in, const int* dropped_in,
                        const int* armed_in, int* st, int* start, int* enter,
                        int* seq, int* armseq_out, float* caps,
                        int* dropped_out, int* armed_out, uint8_t* mask,
                        float* mcaps, int* mts, int* menter, int* mseq, int P,
                        int T, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return 0;
  const size_t smem = static_cast<size_t>(prog_len) * sizeof(int);
  if (K <= 0 || T < 0 || prog_len < kHeader || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (P + kWarps - 1) / kWarps;
  nfa_step_kernel<<<grid, kThreads, smem, s>>>(
      attrs, ts, strm, valid, gates, prog, prog_len, st_in, start_in,
      enter_in, seq_in, armseq_in, caps_in, dropped_in, armed_in, st, start,
      enter, seq, armseq_out, caps, dropped_out, armed_out, mask, mcaps, mts,
      menter, mseq, P, T, K);
  return static_cast<int>(cudaGetLastError());
}
