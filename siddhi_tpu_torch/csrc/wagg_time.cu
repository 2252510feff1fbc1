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
// by level.  The kernel computes that tree exactly: each of N = min(128,
// Cp) threads owns Cp / N adjacent leaves and sums them pairwise in
// registers (a binary-counter stack), the warps combine neighbouring
// threads by shuffles at offsets 1, 2, 4, ..., and thread 0 combines the
// warps' partials in the same tree.  float addition is commutative bit for
// bit, so the sums equal the plain version's, NaN payloads aside.
//
// The carry is written FRESH (ring_out etc.): on an overflow the caller
// rewinds to the carry it passed in, grows C and replays the block.
//
// What bounds it on this card.  The function reads values, ts and ok
// (9 B an event) and the carry, and writes sums, counts (8 B an event, 16
// with min/max) and the carry: bytes.  Its operations are the masked
// reductions: C slots for every event, P*T*C masked adds (and compares),
// which is what bounds it once C reaches a few hundred slots — chip_smoke
// phase 18 computes both bounds per run.  The design, one CTA of 128
// threads per lane: the lane's ring and timestamps sit in shared memory
// when C * 8 B fits the budget (else the kernel works on ring_out in device
// memory); per event thread 0 reads the evicted slot's ts and writes the
// new entry, one barrier, every thread reduces its leaves, one barrier,
// thread 0 combines and stores.  Two barriers and C / 128 slot reads a
// thread an event: a serial chain over the lane's events, parallel over
// the ring.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;               // one CTA per lane
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may use
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

struct Partial {
  float sum;
  int cnt, kmin, kmax, nan;
};

__global__ void __launch_bounds__(kThreads)
wagg_time_kernel(const float* __restrict__ values,
                 const int* __restrict__ ts,
                 const unsigned char* __restrict__ ok,
                 const float* __restrict__ ring_in,
                 const int* __restrict__ rts_in,
                 const int* __restrict__ pos_in,
                 const int* __restrict__ cnt_in,
                 const int* __restrict__ last_in,
                 const unsigned char* __restrict__ ovf_in,
                 float* __restrict__ ring_out, int* __restrict__ rts_out,
                 int* __restrict__ pos_out, int* __restrict__ cnt_out,
                 int* __restrict__ last_out,
                 unsigned char* __restrict__ ovf_out,
                 float* __restrict__ sums, int* __restrict__ counts,
                 float* __restrict__ mins, float* __restrict__ maxs,
                 int P, int T, int C, int window_ms, int want_minmax,
                 int in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Partial part[kWarps];
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int wid = tid >> 5;
  int cp = 1;
  while (cp < C) cp <<= 1;
  const int n_leaf = cp < kThreads ? cp : kThreads;   // leaf threads
  const int per = cp / n_leaf;                         // leaves a thread
  const int n_warp = (n_leaf + 31) >> 5;
  const int kinf = order_key(__int_as_float(0x7f800000));
  const int kninf = order_key(__int_as_float(0xff800000));

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t row = static_cast<size_t>(p) * C;
    float* R;
    int* RT;
    if (in_smem) {
      R = reinterpret_cast<float*>(smem);
      RT = reinterpret_cast<int*>(smem + sizeof(float) * C);
    } else {
      R = ring_out + row;
      RT = rts_out + row;
    }
    for (int s = tid; s < C; s += kThreads) {
      R[s] = ring_in[row + s];
      RT[s] = rts_in[row + s];
    }
    int pos = pos_in[p], cnt = cnt_in[p], last = last_in[p];
    int ovf = ovf_in[p] != 0;
    __syncthreads();
    const size_t ev0 = static_cast<size_t>(p) * T;
    for (int e = 0; e < T; ++e) {
      const float x = values[ev0 + e];
      const int t = ts[ev0 + e];
      const bool acc = ok[ev0 + e] != 0;
      const int cut = isub(t, window_ms);
      if (tid == 0) {
        const int old_ts = RT[pos];
        if (acc && cnt == C && old_ts > cut) ovf = 1;
        if (acc) {
          R[pos] = x;
          RT[pos] = t;
        }
      }
      if (acc) {
        pos = (pos + 1) % C;
        cnt = cnt + 1 < C ? cnt + 1 : C;
        last = t;
      }
      __syncthreads();
      // this thread's leaves [tid * per, tid * per + per): a pairwise sum
      float stk[kMaxLevels];
      float total = 0.0f;
      int c = 0, kmin = kinf, kmax = kninf, nan = 0;
      if (tid < n_leaf) {
        const int s0 = tid * per;
        for (int i = 0; i < per; ++i) {
          const int s = s0 + i;
          float v = 0.0f;
          if (s < C && s < cnt && RT[s] > cut) {
            const float r = R[s];
            v = r;
            ++c;
            if (r != r) {
              nan = 1;
            } else {
              const int k = order_key(r);
              kmin = k < kmin ? k : kmin;
              kmax = k > kmax ? k : kmax;
            }
          }
          int lvl = 0;
          for (unsigned ii = static_cast<unsigned>(i); ii & 1u; ii >>= 1) {
            v = stk[lvl] + v;
            ++lvl;
          }
          stk[lvl] = v;
        }
        int top = 0;
        while ((1 << top) < per) ++top;
        total = stk[top];
      }
      // neighbouring threads: the tree's next levels inside the warp
      for (int off = 1; off < 32 && off < n_leaf; off <<= 1) {
        const float o = __shfl_down_sync(kFull, total, off);
        if ((lane_id & (2 * off - 1)) == 0) total = total + o;
      }
      for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_xor_sync(kFull, c, off);
        const int a = __shfl_xor_sync(kFull, kmin, off);
        const int b = __shfl_xor_sync(kFull, kmax, off);
        kmin = a < kmin ? a : kmin;
        kmax = b > kmax ? b : kmax;
      }
      nan = __any_sync(kFull, nan);
      if (lane_id == 0 && wid < n_warp) {
        part[wid].sum = total;
        part[wid].cnt = c;
        part[wid].kmin = kmin;
        part[wid].kmax = kmax;
        part[wid].nan = nan;
      }
      __syncthreads();
      if (tid == 0) {
        float s;
        if (n_warp == 1) {
          s = part[0].sum;
        } else if (n_warp == 2) {
          s = part[0].sum + part[1].sum;
        } else {
          s = (part[0].sum + part[1].sum) + (part[2].sum + part[3].sum);
        }
        int cc = 0, mn = kinf, mx = kninf, nn = 0;
        for (int w = 0; w < n_warp; ++w) {
          cc += part[w].cnt;
          mn = part[w].kmin < mn ? part[w].kmin : mn;
          mx = part[w].kmax > mx ? part[w].kmax : mx;
          nn |= part[w].nan;
        }
        sums[ev0 + e] = s;
        counts[ev0 + e] = cc;
        if (want_minmax) {
          const float q = __int_as_float(0x7fc00000);
          mins[ev0 + e] = nn ? q : from_order_key(mn);
          maxs[ev0 + e] = nn ? q : from_order_key(mx);
        }
      }
    }
    if (in_smem) {
      for (int s = tid; s < C; s += kThreads) {
        ring_out[row + s] = R[s];
        rts_out[row + s] = RT[s];
      }
    }
    if (tid == 0) {
      pos_out[p] = pos;
      cnt_out[p] = cnt;
      last_out[p] = last;
      ovf_out[p] = static_cast<unsigned char>(ovf);
    }
    __syncthreads();            // the shared ring is reused by the next lane
  }
}

}  // namespace

extern "C" {

// One step over a [P, T] block; the carry in is read, the carry out
// written (no aliasing).  Returns the CUDA error of the launch (0 = ok).
int wagg_time_step(const void* values, const void* ts, const void* ok,
                   const void* ring_in, const void* rts_in,
                   const void* pos_in, const void* cnt_in,
                   const void* last_in, const void* ovf_in, void* ring_out,
                   void* rts_out, void* pos_out, void* cnt_out,
                   void* last_out, void* ovf_out, void* sums, void* counts,
                   void* mins, void* maxs, int P, int T, int C,
                   int window_ms, int want_minmax, void* stream) {
  if (P <= 0) return 0;
  if (C <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t ring_bytes = static_cast<size_t>(C) * 8;
  const int in_smem = ring_bytes <= kSmemBudget;
  const size_t smem = in_smem ? ring_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wagg_time_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = P < 65535 * 16 ? P : 65535 * 16;
  wagg_time_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(ts),
      static_cast<const unsigned char*>(ok),
      static_cast<const float*>(ring_in), static_cast<const int*>(rts_in),
      static_cast<const int*>(pos_in), static_cast<const int*>(cnt_in),
      static_cast<const int*>(last_in),
      static_cast<const unsigned char*>(ovf_in),
      static_cast<float*>(ring_out), static_cast<int*>(rts_out),
      static_cast<int*>(pos_out), static_cast<int*>(cnt_out),
      static_cast<int*>(last_out), static_cast<unsigned char*>(ovf_out),
      static_cast<float*>(sums), static_cast<int*>(counts),
      static_cast<float*>(mins), static_cast<float*>(maxs), P, T, C,
      window_ms, want_minmax, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
