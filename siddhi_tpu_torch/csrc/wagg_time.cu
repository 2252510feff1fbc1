// Sliding time-window aggregation step (K6) for NVIDIA Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/windowed_agg.py:125 build_time_wagg_step (a jnp
// lax.scan over the block's events, vmapped over lanes; no Pallas kernel).
// Contract (siddhi_tpu_torch/ops/windowed_agg.py time_wagg_step_plain): per
// partition lane p, for each of the block's T events in order,
//   - the event's slot `pos` sets the sticky overflow flag when the ring is
//     full and the slot's entry is still inside the window (its ts offset
//     > t - window_ms, int32 wrapping as jnp's);
//   - an accepted event overwrites the slot (value, ts), pos = (pos+1) % C,
//     cnt = min(cnt+1, C), last_ts = t;
//   - every event (a rejected one too, against its own ts) emits a fresh
//     masked reduction over the slots [0, cnt) with ts > t - window_ms:
//     the sum, the count and, with want_minmax, the IEEE min and max (NaN
//     propagates, -0.0 < +0.0; +inf / -inf over an empty window).
// The sum is the pairwise tree of the plain version (pair_tree_sum): the C
// slots padded with +0.0 to a power of two Cp, adjacent pairs summed level
// by level.  float addition is commutative bit for bit, so a tree with the
// same leaves and the same pairs gives the plain version's sums, NaN
// payloads aside.  A masked leaf is +0.0 and is still added.
//
// The ring at each event has a closed form, which removes the serial chain
// over a lane's events.  Let X be the lane's entries in write order: X[j]
// for j < C is the carry's slot (pos0 + j) % C, X[C + a] the block's a-th
// accepted event.  With A_t the accepted events up to and including event
// t, slot s holds X[A_t + ((s - pos0 - A_t) mod C)] at event t (the last C
// entries of X before C + A_t, each in the slot it was written to), and
// cnt_t = min(cnt0 + A_t, C).  The a-th accepted event overwrites X[a]:
// it sets the overflow when cnt0 + a >= C and X[a].ts > its ts -
// window_ms.  The carry out is the ring at A_T.  Two launches:
//   1. prep (a CTA a lane): a block scan of `ok` gives A_t and compacts
//      the accepted (value, ts) pairs; the carry ring is rotated in front
//      of them, so X sits in device scratch; then the overflow (an OR over
//      the accepted events), the fresh carry ring and its scalars;
//   2. events (kChunk events of one lane a CTA, so a lane spreads over
//      ceil(T / kChunk) CTAs): the CTA copies the part of X its events
//      read, [A_e0, A_e1 + C), into shared memory (C * 8 + kChunk * 8 B,
//      padded against bank conflicts; above kSmemBudget it reads X in
//      device memory instead), and each warp takes one event at a time:
//      its lanes own Cp / 32 adjacent leaves each, sum them pairwise (in
//      registers by groups of kGroup, the groups by a binary-counter
//      stack), and shuffles at offsets 1, 2, 4, ... add neighbouring
//      lanes' subtrees: the plain version's tree, leaf for leaf.  The count and the min / max (as order keys, NaN
//      tracked apart) reduce by xor shuffles.
//
// What bounds it on this card.  The function reads values, ts and ok
// (9 B an event) and the carry, and writes sums, counts (8 B an event, 16
// with min/max) and the carry: bytes.  Its operations are the masked
// reductions: C leaves for every event, P*T*C masked adds (and compares),
// which is what bounds it once C reaches a few hundred slots — chip_smoke
// phase 18 computes both bounds per run.  The design puts every warp of
// the card on those leaves; no barrier is taken per event.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 256;           // prep: one CTA a lane
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kEvWarps = 8;                 // events: a warp an event
constexpr int kEvThreads = kEvWarps * 32;
constexpr int kChunk = 64;                  // events a CTA
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may use
constexpr int kGroup = 8;                   // leaves summed in registers
constexpr int kMaxLevels = 32;              // pairwise stack depth

__device__ __forceinline__ int isub(int a, int b) {     // wrapping int32
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// float -> int whose signed order is the float order with -0.0 < +0.0
// (NaN excluded: the caller tracks it apart)
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__host__ __device__ __forceinline__ int pow2_at_least(int c) {
  int cp = 1;
  while (cp < c) cp <<= 1;
  return cp;
}

__host__ __device__ __forceinline__ int log2_of(int n) {  // n a power of 2
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// Entries of the window a CTA of the events kernel holds, with the
// padding of one entry every `per` (see pad_index).
__host__ __device__ __forceinline__ size_t window_entries(int C) {
  const int cp = pow2_at_least(C);
  const int per = cp < 32 ? 1 : cp / 32;
  const size_t n = static_cast<size_t>(C) + kChunk;
  return n + (per > 1 ? n / per + 1 : 0);
}

// Exclusive sum of one int a thread over the prep CTA; total out.
__device__ int prep_scan(int v, int& total) {
  __shared__ int ws[kPrepWarps];
  const int lid = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, o);
    if (lid >= o) inc += u;
  }
  if (lid == 31) ws[wid] = inc;
  __syncthreads();
  int pre = 0;
  total = 0;
  for (int w = 0; w < kPrepWarps; ++w) {
    if (w < wid) pre += ws[w];
    total += ws[w];
  }
  __syncthreads();                       // ws is reused by the next call
  return pre + inc - v;
}

// ---------------------------------------------------------------- pass 1

__global__ void __launch_bounds__(kPrepThreads)
wagg_time_prep(const float* __restrict__ values, const int* __restrict__ ts,
               const unsigned char* __restrict__ ok,
               const float* __restrict__ ring_in,
               const int* __restrict__ rts_in, const int* __restrict__ pos_in,
               const int* __restrict__ cnt_in,
               const int* __restrict__ last_in,
               const unsigned char* __restrict__ ovf_in,
               float* __restrict__ ring_out, int* __restrict__ rts_out,
               int* __restrict__ pos_out, int* __restrict__ cnt_out,
               int* __restrict__ last_out,
               unsigned char* __restrict__ ovf_out, int* __restrict__ acnt,
               int2* __restrict__ X, int P, int T, int C, int window_ms) {
  const int tid = threadIdx.x;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t row = static_cast<size_t>(p) * C;
    const size_t ev0 = static_cast<size_t>(p) * T;
    int2* x = X + static_cast<size_t>(p) * (static_cast<size_t>(C) + T);
    const int pos0 = pos_in[p], cnt0 = cnt_in[p];
    for (int j = tid; j < C; j += kPrepThreads) {     // the carry, rotated
      int s = pos0 + j;
      if (s >= C) s -= C;
      x[j] = make_int2(__float_as_int(ring_in[row + s]), rts_in[row + s]);
    }
    int n = 0;                                        // accepted so far
    for (int t0 = 0; t0 < T; t0 += kPrepThreads) {
      const int t = t0 + tid;
      const int a = t < T && ok[ev0 + t] != 0;
      int total;
      const int ex = prep_scan(a, total);
      if (t < T) {
        acnt[ev0 + t] = n + ex + a;
        if (a)
          x[C + n + ex] = make_int2(__float_as_int(values[ev0 + t]),
                                    ts[ev0 + t]);
      }
      n += total;
    }
    __syncthreads();                       // X is complete for this lane
    int o = 0;
    for (int a = tid; a < n; a += kPrepThreads) {
      if (cnt0 + a >= C && x[a].y > isub(x[C + a].y, window_ms)) o = 1;
    }
    o = __syncthreads_or(o);
    const int nm = n % C;
    for (int s = tid; s < C; s += kPrepThreads) {     // the ring at A_T
      int d = (s - pos0 - nm) % C;
      if (d < 0) d += C;
      const int2 e = x[n + d];
      ring_out[row + s] = __int_as_float(e.x);
      rts_out[row + s] = e.y;
    }
    if (tid == 0) {
      pos_out[p] = (pos0 + nm) % C;
      cnt_out[p] = cnt0 + n < C ? cnt0 + n : C;
      last_out[p] = n > 0 ? x[C + n - 1].y : last_in[p];
      ovf_out[p] = static_cast<unsigned char>((ovf_in[p] != 0) | o);
    }
    __syncthreads();                       // X's lane is done
  }
}

// ---------------------------------------------------------------- pass 2

// shared-memory index of window entry jj: one pad entry every `per`
// entries (shift = log2(per)), so that the 32 lanes, `per` entries apart,
// read 32 different banks; shift 31 = no padding (device memory)
__device__ __forceinline__ int pad_index(int jj, int shift) {
  return jj + (jj >> shift);
}

template <bool kMinMax>
__global__ void __launch_bounds__(kEvThreads)
wagg_time_events(const int* __restrict__ ts, const int* __restrict__ pos_in,
                 const int* __restrict__ cnt_in,
                 const int* __restrict__ acnt, const int2* __restrict__ X,
                 float* __restrict__ sums, int* __restrict__ counts,
                 float* __restrict__ mins, float* __restrict__ maxs, int P,
                 int T, int C, int window_ms, int n_chunks, int in_smem) {
  extern __shared__ __align__(16) int2 win[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int cp = pow2_at_least(C);
  const int n_leaf = cp < 32 ? cp : 32;               // leaf lanes
  const int per = cp / n_leaf;                        // leaves a lane
  const int group = per < kGroup ? per : kGroup;      // leaves a group
  const int n_groups = per / group;
  const int top = log2_of(n_groups);
  const int shift = in_smem && per > 1 ? log2_of(per) : 31;
  const int kinf = order_key(__int_as_float(0x7f800000));
  const int kninf = order_key(__int_as_float(0xff800000));
  const long long n_cta = static_cast<long long>(P) * n_chunks;
  for (long long b = blockIdx.x; b < n_cta; b += gridDim.x) {
    const int p = static_cast<int>(b / n_chunks);
    const int e0 = static_cast<int>(b % n_chunks) * kChunk;
    const int e1 = e0 + kChunk < T ? e0 + kChunk : T;
    const size_t ev0 = static_cast<size_t>(p) * T;
    const int2* x = X + static_cast<size_t>(p) * (static_cast<size_t>(C) + T);
    const int jlo = acnt[ev0 + e0];
    const int2* w = x + jlo;
    if (in_smem) {
      const int jn = acnt[ev0 + e1 - 1] + C - jlo;
      for (int jj = threadIdx.x; jj < jn; jj += kEvThreads)
        win[pad_index(jj, shift)] = x[jlo + jj];
      __syncthreads();
      w = win;
    }
    const int pos0 = pos_in[p], cnt0 = cnt_in[p];
    for (int t = e0 + wid; t < e1; t += kEvWarps) {
      const int A = acnt[ev0 + t];
      const int cut = isub(ts[ev0 + t], window_ms);
      const int cnt = cnt0 + A < C ? cnt0 + A : C;
      const int base = A - jlo;                       // X[A] in the window
      float stk[kMaxLevels];
      float total = 0.0f;
      int c = 0, kmin = kinf, kmax = kninf, nan = 0;
      if (lane < n_leaf) {
        const int s0 = lane * per;
        int k = (s0 - pos0 - A) % C;                  // X[A + k] is slot s0
        if (k < 0) k += C;
        for (int gi = 0; gi < n_groups; ++gi) {
          // kGroup adjacent leaves: their subtree in registers
          float lv[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int s = s0 + gi * group + g;
            float v = 0.0f;
            if (g < group && s < C) {
              const int2 e = w[pad_index(base + k, shift)];
              if (++k == C) k = 0;
              if (s < cnt && e.y > cut) {
                v = __int_as_float(e.x);
                ++c;
                if (kMinMax) {
                  if ((e.x & 0x7fffffff) > 0x7f800000) {
                    nan = 1;
                  } else {
                    const int key = e.x ^ ((e.x >> 31) & 0x7fffffff);
                    kmin = key < kmin ? key : kmin;
                    kmax = key > kmax ? key : kmax;
                  }
                }
              }
            }
            lv[g] = v;
          }
#pragma unroll
          for (int wd = 1; wd < kGroup; wd <<= 1) {
            if (wd < group) {
#pragma unroll
              for (int g = 0; g < kGroup; g += 2 * wd)
                lv[g] = lv[g] + lv[g + wd];
            }
          }
          // the groups' subtrees pairwise (a binary-counter stack)
          float v = lv[0];
          int lvl = 0;
          for (unsigned ii = static_cast<unsigned>(gi); ii & 1u; ii >>= 1) {
            v = stk[lvl] + v;
            ++lvl;
          }
          stk[lvl] = v;
        }
        total = stk[top];
      }
      // neighbouring lanes: the tree's next levels
      for (int off = 1; off < n_leaf; off <<= 1) {
        const float o = __shfl_down_sync(kFull, total, off);
        if ((lane & (2 * off - 1)) == 0) total = total + o;
      }
      for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
      if (kMinMax) {
        for (int off = 16; off > 0; off >>= 1) {
          const int a = __shfl_xor_sync(kFull, kmin, off);
          const int bb = __shfl_xor_sync(kFull, kmax, off);
          kmin = a < kmin ? a : kmin;
          kmax = bb > kmax ? bb : kmax;
        }
        nan = __any_sync(kFull, nan);
      }
      if (lane == 0) {
        sums[ev0 + t] = total;
        counts[ev0 + t] = c;
        if (kMinMax) {
          const float q = __int_as_float(0x7fc00000);
          mins[ev0 + t] = nan ? q : from_order_key(kmin);
          maxs[ev0 + t] = nan ? q : from_order_key(kmax);
        }
      }
    }
    if (in_smem) __syncthreads();          // the window is reused
  }
}

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

}  // namespace

extern "C" {

// Bytes of device scratch one step needs: A_t a event, X a lane.
long long wagg_time_scratch_bytes(int P, int T, int C) {
  if (P <= 0) return 0;
  const size_t p = static_cast<size_t>(P);
  return static_cast<long long>(
      align16(p * T * 4) + align16(p * (static_cast<size_t>(C) + T) * 8));
}

// One step over a [P, T] block; the carry in is read, the carry out
// written (no aliasing).  scratch holds scratch_bytes bytes, at least
// wagg_time_scratch_bytes(P, T, C).  Returns the CUDA error of the
// launches (0 = ok).
int wagg_time_step(const void* values, const void* ts, const void* ok,
                   const void* ring_in, const void* rts_in,
                   const void* pos_in, const void* cnt_in,
                   const void* last_in, const void* ovf_in, void* ring_out,
                   void* rts_out, void* pos_out, void* cnt_out,
                   void* last_out, void* ovf_out, void* sums, void* counts,
                   void* mins, void* maxs, void* scratch,
                   long long scratch_bytes, int P, int T, int C,
                   int window_ms, int want_minmax, void* stream) {
  if (P <= 0) return 0;
  if (C <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (scratch == nullptr || scratch_bytes < wagg_time_scratch_bytes(P, T, C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  int* acnt = reinterpret_cast<int*>(s);
  int2* X = reinterpret_cast<int2*>(s + align16(static_cast<size_t>(P) * T * 4));
  const int grid_p = P < 65535 * 16 ? P : 65535 * 16;
  wagg_time_prep<<<grid_p, kPrepThreads, 0, st>>>(
      static_cast<const float*>(values), static_cast<const int*>(ts),
      static_cast<const unsigned char*>(ok),
      static_cast<const float*>(ring_in), static_cast<const int*>(rts_in),
      static_cast<const int*>(pos_in), static_cast<const int*>(cnt_in),
      static_cast<const int*>(last_in),
      static_cast<const unsigned char*>(ovf_in),
      static_cast<float*>(ring_out), static_cast<int*>(rts_out),
      static_cast<int*>(pos_out), static_cast<int*>(cnt_out),
      static_cast<int*>(last_out), static_cast<unsigned char*>(ovf_out),
      acnt, X, P, T, C, window_ms);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || T == 0) return static_cast<int>(e);
  const size_t win_bytes = window_entries(C) * sizeof(int2);
  const int in_smem = win_bytes <= kSmemBudget;
  const size_t smem = in_smem ? win_bytes : 0;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const long long n_cta = static_cast<long long>(P) * n_chunks;
  const unsigned grid = static_cast<unsigned>(
      n_cta < 65535LL * 64 ? n_cta : 65535LL * 64);
  if (want_minmax) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(wagg_time_events<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    wagg_time_events<true><<<grid, kEvThreads, smem, st>>>(
        static_cast<const int*>(ts), static_cast<const int*>(pos_in),
        static_cast<const int*>(cnt_in), acnt, X, static_cast<float*>(sums),
        static_cast<int*>(counts), static_cast<float*>(mins),
        static_cast<float*>(maxs), P, T, C, window_ms, n_chunks, in_smem);
  } else {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(wagg_time_events<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    wagg_time_events<false><<<grid, kEvThreads, smem, st>>>(
        static_cast<const int*>(ts), static_cast<const int*>(pos_in),
        static_cast<const int*>(cnt_in), acnt, X, static_cast<float*>(sums),
        static_cast<int*>(counts), nullptr, nullptr, P, T, C, window_ms,
        n_chunks, in_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
