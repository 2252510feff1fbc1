// Grouped window / running aggregation steps (K7) for NVIDIA Hopper (sm_90a).
//
// Replaces the per-event lax.scan of siddhi_tpu/ops/grouped_agg.py:
//   K7a gagg_step       <- :119 build_grouped_step (length window, W > 0, and
//                          the running mode, W == 0)
//   K7b gagg_time_step  <- :283 build_grouped_time_step (time window ring)
// Contract (siddhi_tpu_torch/ops/grouped_agg.py, the plain twins): per lane
// p, for each of the block's T events in order, update the arriving event's
// group (evicting the ring's oldest entry from ITS group first) and emit 13
// planes: fsum hi/lo, isum hi/lo, count, windowed min/max per bank, forever
// min/max per bank.  Rows with ok == 0 change nothing but still emit (junk
// the host discards; the checks hold it bit for bit too).
//
// Layout: the JAX package's row-major planes: rings [P, W, V], group slabs
// [P, G, V], events [P, T, V].  Pointers arrive as one host array, in the
// order of ops/grouped_agg.py _launch: event inputs, the carry in, the carry
// out, the 13 output planes, the scratch (gagg_scratch_words() words of
// int32, from torch.empty in the wrapper).  K7a writes a fresh carry or,
// where the JAX package donates it, updates the carry in place (the two
// pointer sets are equal); K7b always writes a fresh one (a ring-overflow
// replay rewinds to the pre-step carry).
//
// What bounds it on this card.  Per event the function reads its inputs and
// writes 13 output rows: by bytes, a few microseconds for the unkeyed cells'
// 262,144 events (chip_smoke.py phase 12 computes the bound per launch).
// The JAX package's structure — vmap over P lanes, scan over T — puts the
// unkeyed query (P = 1) on one warp of one SM.  Its semantics do not need
// that:
//   - the ring at event t is the lane's last W accepted entries: number the
//     entries by a virtual index v (the carry's cnt0 live entries oldest
//     first, then the block's accepted events at cnt0 + accepted rank); the
//     window at t is [max(0, hi - W), hi), hi = cnt0 + the accepted events
//     up to t, and entry v sits in slot (first + v) % W (the ring fills from
//     slot 0: pos == cnt until it is full);
//   - everything windowed reads only that window: K7a's windowed min/max,
//     K7b's sums, count and min/max (the ring overflow too).  Min, max and
//     the wrapping int sums are associative and commutative (IEEE min/max
//     with NaN propagating and -0.0 < +0.0 included); K7b's float sum is the
//     pairwise tree over SLOT positions, a function of the live slots alone;
//   - K7a's float sums are running two-float accumulators (evict, then add,
//     on one pair): not associative, so the same bits need each group's
//     operations in event order.  Groups are independent.  The forever
//     extrema ride the same walk.
//
// The passes (one stream, one C entry per kernel; tiles of split_tile()
// items, the carry's ceil(W / tile) tiles of entries before the block's
// tiles of events; ops/grouped_agg.grouped_split_model is their CPU model):
//   count    a CTA per (lane, tile): per item its accepted rank and its
//            same-group ranks in the tile (warp matches, the warps in turn),
//            per tile and group the counts of events (EVC) and of entries
//            (ENT);
//   scan     per (lane, group) the two count columns in tile order; per lane
//            the group totals in group order and the tiles' accepted counts;
//   scatter  a CTA per (lane, tile): every item to its place — a stable
//            counting sort (ranks, never atomics: an atomic scatter is not
//            stable) — the event chains EVC and the entry chains ENT, each
//            with a copy of its items' values in chain order, the entry
//            array E, and per event hi and b (its group's entries before
//            hi);
//   walk     C: a thread per (lane, group) walks its event chain with its
//            entries' evictions merged in (entry v has left the window at an
//            event when v < hi - W: it is evicted before that event's add),
//            and writes the sums, count and forever planes at every event of
//            the group, then the group's slabs.  The only serial pass: its
//            depth is the longest group chain (the whole lane when G == 1),
//            and the chain-ordered copies keep each of its steps to loads
//            that wait on no other;
//   windows  D: a thread per event; its group's live entries are ENT's range
//            that ends at b and starts at the first v >= hi - W.  A range of
//            at most kShort entries one thread reduces (K7b: the pairwise
//            tree over its live slots, ordered by bit-reversed slot so that
//            each level's siblings are neighbours); a longer one the warp
//            (K7a: down the chain 32 entries a step; K7b: the dense tree
//            over the W slots in shared memory).  K7b's sticky overflow is
//            an OR over the lane's events;
//   ring     E: each slot takes the newest entry that lands in it, then pos
//            and cnt.  Last, so every pass read the pre-step carry (the
//            in-place step's ring is E's source until here).
// gagg_time_passes() records CUDA events between the passes (chip_smoke.py
// times each pass's share with it).
//
// Bits.  Built without --use_fast_math and with --fmad=false
// (ops/_kernels.py), so every float operation is the JAX package's, one for
// one:
//   - the evicted value is the JAX one-hot sum, sum(where(onehot, ring, 0)),
//     i.e. the slot plus +0.0 (a -0.0 slot evicts as +0.0);
//   - evict first, then add, on the same (hi, lo) pair when the evicted
//     entry's group is the arriving one;
//   - min/max are IEEE minimum/maximum, as jnp.min and .at[].min are: NaN
//     propagates and -0.0 < +0.0 (fminf/fmaxf drop NaN, so the compares are
//     written out);
//   - the time step's float sums are the pairwise two-float tree of
//     _pair_tree_sum: level by level, element i meets element i + half; a
//     node with no live leaf below it is (+0.0, +0.0) and still meets its
//     sibling with the same operations;
//   - int lanes split at 2^16 (arithmetic >> 16, & 65535) with wrapping
//     int32 adds, as XLA's.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;                  // threads of the tiled passes
constexpr int kWarps = kBlock / 32;
constexpr int kGroupThreads = 128;           // threads of the group scan
constexpr int kWalkThreads = 32;             // threads of a walk CTA
constexpr int kLanes = 4;                    // value lanes a walk holds
constexpr size_t kSmemMax = 160 * 1024;      // D's trees (K7b, long ranges)
constexpr long long kCountBytes = 64LL << 20;  // the count matrices' budget
constexpr int kShort = 32;  // a range one thread reduces (0: every one a warp)
constexpr int kShortArr = kShort > 0 ? kShort : 1;
constexpr int kNever = 0x7fffffff;
constexpr int kI32Max = 2147483647;
constexpr int kI32Min = -2147483647 - 1;
constexpr int kMarks = 7;                    // pass boundaries timed

cudaEvent_t g_marks[kMarks];
int g_n_marks = 0;

__device__ __forceinline__ int iadd(int a, int b) {     // wrapping int32 add
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float fmin_ieee(float a, float b) {
  if (a != a || b != b) return qnan();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;                 // equal: -0.0 is the smaller
}

__device__ __forceinline__ float fmax_ieee(float a, float b) {
  if (a != a || b != b) return qnan();
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;                 // equal: +0.0 is the larger
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

// _pair_add with ok: (hi, lo) += x, renormalised
__device__ __forceinline__ void pair_add(float& hi, float& lo, float x) {
  float s, e;
  two_sum(hi, x, s, e);
  const float lo2 = lo + e;
  const float hi2 = s + lo2;
  lo = lo2 - (hi2 - s);
  hi = hi2;
}

// One node of _pair_tree_sum: (ah, al) of the lower slots meets (bh, bl).
__device__ __forceinline__ void tree_node(float ah, float al, float bh,
                                          float bl, float& h, float& l) {
  float sm, er;
  two_sum(ah, bh, sm, er);
  const float lo2 = (al + bl) + er;
  h = sm + lo2;
  l = lo2 - (h - sm);
}

__device__ __forceinline__ float warp_fmin(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmin_ieee(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_fmax(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmax_ieee(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_imin(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_imax(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_iadd(int x) {
  for (int o = 16; o > 0; o >>= 1) x = iadd(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The scratch, per lane (ops/grouped_agg._launch allocates it): the count
// matrices, in-tile ranks, chain offsets, chains and the entry array.
// words() is gagg_scratch_words().
struct Split {
  int tile, ntc, ntb, nt, ne;  // tile; carry, block, all tiles; entries W+T
  int *cnt_ent, *cnt_evc;      // [P][nt][G], [P][ntb][G]: counts, then bases
  int* tile_acc;               // [P][ntb]: accepted a tile, then bases
  int *acc_in, *kall_in, *kacc_in;  // [P][T] ranks in the tile
  int* kent_in;                // [P][W]
  int *ent_off, *ent_len, *evc_off, *evc_len;  // [P][G]
  int* lane;                   // [P][4]: cnt0, first, accepted, pos0
  int *hi, *bpos;              // [P][T] per event
  int *evc, *evc_hi;           // [P][T] EVC: t (~t rejected), its hi
  float* evc_f;                // [P][T][VF] EVC's values
  int* evc_i;                  // [P][T][VI]
  int *ent, *ent_ts;           // [P][ne] ENT: v, its ts (K7b)
  float* ent_f;                // [P][ne][VF] ENT's values
  int* ent_i;                  // [P][ne][VI]
  int *e_g, *e_ts;             // [P][ne] E, by virtual index
  float* e_f;                  // [P][ne][VF]
  int* e_i;                    // [P][ne][VI]
  size_t words;
};

// One block of threads, doubled while the per-tile group counts of the P
// lanes would pass kCountBytes (a CTA then walks its tile kBlock items at
// a time).  Mirrored by ops/grouped_agg.split_tile.
int split_tile(int P, int T, int W, int G) {
  long long tile = kBlock;
  while (tile < std::max(std::max(T, W), 1)) {
    const long long n = (W + tile - 1) / tile + 2 * ((T + tile - 1) / tile);
    if (static_cast<long long>(P) * n * G * 4 <= kCountBytes) break;
    tile *= 2;
  }
  return static_cast<int>(tile);
}

Split split_layout(int P, int T, int W, int G, int VF, int VI, bool time,
                   int* base) {
  Split s;
  s.tile = split_tile(P, T, W, G);
  s.ntc = (W + s.tile - 1) / s.tile;
  s.ntb = (T + s.tile - 1) / s.tile;
  s.nt = s.ntc + s.ntb;
  s.ne = W + T;
  size_t w = 0;
  const size_t p = static_cast<size_t>(P);
  auto take_words = [&](size_t n) {
    int* at = base ? base + w : nullptr;
    w += n;
    return at;
  };
  s.cnt_ent = take_words(p * s.nt * G);
  s.cnt_evc = take_words(p * s.ntb * G);
  s.tile_acc = take_words(p * s.ntb);
  s.acc_in = take_words(p * T);
  s.kall_in = take_words(p * T);
  s.kacc_in = take_words(p * T);
  s.kent_in = take_words(p * W);
  s.ent_off = take_words(p * G);
  s.ent_len = take_words(p * G);
  s.evc_off = take_words(p * G);
  s.evc_len = take_words(p * G);
  s.lane = take_words(p * 4);
  s.hi = take_words(p * T);
  s.bpos = take_words(p * T);
  s.evc = take_words(p * T);
  s.evc_hi = take_words(p * T);
  s.evc_f = reinterpret_cast<float*>(take_words(p * T * VF));
  s.evc_i = take_words(p * T * VI);
  s.ent = take_words(p * s.ne);
  s.ent_ts = take_words(time ? p * s.ne : 0);
  s.ent_f = reinterpret_cast<float*>(take_words(p * s.ne * VF));
  s.ent_i = take_words(p * s.ne * VI);
  s.e_g = take_words(p * s.ne);
  s.e_ts = take_words(time ? p * s.ne : 0);
  s.e_f = reinterpret_cast<float*>(take_words(p * s.ne * VF));
  s.e_i = take_words(p * s.ne * VI);
  s.words = w;
  return s;
}

// Both kernels' arguments (K7a leaves the ts, ring_ts and overflow pointers
// null and the slab pointers of the sums set; K7b the other way round).
struct Args {
  const float* vf; const int* vi; const int* gid; const int* ts;
  const uint8_t* ok;
  const float* rf0; const int* ri0; const int* rg0; const int* rts0;
  const int* pos0; const int* cnt0; const uint8_t* ovf0;
  const float* fhi0; const float* flo0; const int* ihi0; const int* ilo0;
  const int* gc0; const float* mnf0; const float* mxf0; const int* mni0;
  const int* mxi0;
  float* rf; int* ri; int* rg; int* rts; int* pos; int* cnt; uint8_t* ovf;
  float* fhi; float* flo; int* ihi; int* ilo; int* gc; float* mnf;
  float* mxf; int* mni; int* mxi;
  float* o_fhi; float* o_flo; int* o_ihi; int* o_ilo; int* o_cnt;
  float* o_wmnf; float* o_wmxf; int* o_wmni; int* o_wmxi;
  float* o_amnf; float* o_amxf; int* o_amni; int* o_amxi;
  int P, T, W, G, VF, VI, window_ms, minmax, forever, inplace, time;
  Split sp;
};

// Exclusive scan of in[0, n) into out (may be in) by the whole CTA of
// kBlock threads; returns the total.
__device__ int block_scan(const int* in, int* out, int n) {
  __shared__ int s_w[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int run = 0;
  for (int j0 = 0; j0 < n; j0 += kBlock) {
    const int j = j0 + tid;
    const int x = j < n ? in[j] : 0;
    int y = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    if (lane == 31) s_w[warp] = y;
    __syncthreads();
    int pre = 0, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      pre += w < warp ? s_w[w] : 0;
      tot += s_w[w];
    }
    if (j < n) out[j] = run + pre + y - x;
    __syncthreads();                         // s_w read before it is reused
    run += tot;
  }
  return run;
}

// ---------------------------------------------------------------- count

__global__ void __launch_bounds__(kBlock) gagg_count_kernel(const Args a) {
  const Split& s = a.sp;
  const int p = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int T = a.T, W = a.W, G = a.G;
  const bool carry_tile = c < s.ntc;
  const int b = c - s.ntc;
  int* cent = s.cnt_ent + (static_cast<size_t>(p) * s.nt + c) * G;
  int* cevc = carry_tile ? nullptr
                         : s.cnt_evc + (static_cast<size_t>(p) * s.ntb + b) * G;
  for (int q = tid; q < G; q += kBlock) {
    cent[q] = 0;
    if (cevc) cevc[q] = 0;
  }
  const int cnt0 = a.cnt0[p];
  const int first = (W > 0 && cnt0 >= W) ? a.pos0[p] : 0;
  const int i0 = (carry_tile ? c : b) * s.tile;
  const int n_items = min(s.tile, (carry_tile ? cnt0 : T) - i0);
  __shared__ int s_acc[kWarps];
  int run = 0;                               // accepted in the tile so far
  __syncthreads();
  for (int j0 = 0; j0 < n_items; j0 += kBlock) {
    const int j = j0 + tid, i = i0 + j;
    int q = -1;
    bool ok = false;
    if (j < n_items) {
      if (carry_tile) {
        q = a.rg0[static_cast<size_t>(p) * W + (first + i) % W];
        if (q < 0 || q >= G) q = -1;         // (a step's carry: never)
        ok = q >= 0;
      } else {
        const size_t e = static_cast<size_t>(p) * T + i;
        q = a.gid[e];
        ok = a.ok[e] != 0;
      }
    }
    const unsigned same = __match_any_sync(kFull, q);
    const unsigned okm = __ballot_sync(kFull, ok);
    const unsigned lt = (1u << lane) - 1u;
    const int r_all = __popc(same & lt), r_acc = __popc(same & okm & lt);
    const bool leader = q >= 0 && (same >> lane) == 1u;  // its group's last
    if (lane == 0) s_acc[warp] = __popc(okm);
    int k_all = 0, k_acc = 0;
    for (int w = 0; w < kWarps; ++w) {       // the warps in turn
      __syncthreads();
      if (warp == w && q >= 0) {
        k_all = (cevc ? cevc[q] : 0) + r_all;
        k_acc = cent[q] + r_acc;
      }
      __syncwarp();
      if (warp == w && leader) {
        if (cevc) cevc[q] = k_all + 1;
        cent[q] = k_acc + (ok ? 1 : 0);
      }
    }
    __syncthreads();
    int pre = run + __popc(okm & lt), tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      pre += w < warp ? s_acc[w] : 0;
      tot += s_acc[w];
    }
    __syncthreads();                         // s_acc read before it is reused
    run += tot;
    if (j < n_items) {
      if (carry_tile) {
        if (q >= 0) s.kent_in[static_cast<size_t>(p) * W + i] = k_acc;
      } else {
        const size_t e = static_cast<size_t>(p) * T + i;
        s.acc_in[e] = pre;
        s.kall_in[e] = k_all;
        s.kacc_in[e] = k_acc;
      }
    }
  }
  if (!carry_tile && tid == 0)
    s.tile_acc[static_cast<size_t>(p) * s.ntb + b] = run;
}

// ----------------------------------------------------------------- scan

// In place, the exclusive scan of a column of n counts `stride` apart;
// returns the total.  Loads go ahead of the stores in batches of 8.
__device__ int scan_column(int* col, int n, size_t stride) {
  int run = 0;
  for (int c0 = 0; c0 < n; c0 += 8) {
    int x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = c0 + k < n ? col[(c0 + k) * stride] : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < n) col[(c0 + k) * stride] = run;
      run += x[k];
    }
  }
  return run;
}

__global__ void __launch_bounds__(kGroupThreads)
gagg_scan_groups_kernel(const Args a) {
  const Split& s = a.sp;
  const int p = blockIdx.x, q = blockIdx.y * kGroupThreads + threadIdx.x;
  const int G = a.G;
  if (q >= G) return;
  const size_t pg = static_cast<size_t>(p) * G + q;
  s.ent_len[pg] = scan_column(s.cnt_ent + static_cast<size_t>(p) * s.nt * G
                              + q, s.nt, G);
  s.evc_len[pg] = scan_column(s.cnt_evc + static_cast<size_t>(p) * s.ntb * G
                              + q, s.ntb, G);
}

__global__ void __launch_bounds__(kBlock) gagg_scan_lane_kernel(const Args a) {
  const Split& s = a.sp;
  const int p = blockIdx.x, G = a.G, W = a.W;
  const size_t pg = static_cast<size_t>(p) * G;
  block_scan(s.ent_len + pg, s.ent_off + pg, G);
  block_scan(s.evc_len + pg, s.evc_off + pg, G);
  const int acc = block_scan(s.tile_acc + static_cast<size_t>(p) * s.ntb,
                             s.tile_acc + static_cast<size_t>(p) * s.ntb,
                             s.ntb);
  if (threadIdx.x == 0) {
    const int cnt0 = a.cnt0[p], pos0 = a.pos0[p];
    int* L = s.lane + static_cast<size_t>(p) * 4;
    L[0] = cnt0;
    L[1] = (W > 0 && cnt0 >= W) ? pos0 : 0;
    L[2] = acc;
    L[3] = pos0;
    if (a.time) a.ovf[p] = a.ovf0[p];
  }
}

// -------------------------------------------------------------- scatter

__global__ void __launch_bounds__(kBlock)
gagg_scatter_kernel(const Args a) {
  const Split& s = a.sp;
  const int p = blockIdx.x, c = blockIdx.y;
  const int T = a.T, W = a.W, G = a.G, VF = a.VF, VI = a.VI;
  const int* L = s.lane + static_cast<size_t>(p) * 4;
  const int cnt0 = L[0], first = L[1];
  const size_t pg = static_cast<size_t>(p) * G;
  const size_t pe = static_cast<size_t>(p) * s.ne;
  const bool carry_tile = c < s.ntc;
  const int b = c - s.ntc;
  const int i0 = (carry_tile ? c : b) * s.tile;
  const int n_items = min(s.tile, (carry_tile ? cnt0 : T) - i0);
  const int* cent = s.cnt_ent + (static_cast<size_t>(p) * s.nt + c) * G;
  for (int j = threadIdx.x; j < n_items; j += kBlock) {
    if (carry_tile) {
      const int v = i0 + j;
      const size_t o = static_cast<size_t>(p) * W + (first + v) % W;
      const size_t ev = pe + v;
      for (int f = 0; f < VF; ++f) s.e_f[ev * VF + f] = a.rf0[o * VF + f];
      for (int f = 0; f < VI; ++f) s.e_i[ev * VI + f] = a.ri0[o * VI + f];
      const int q = a.rg0[o];
      s.e_g[ev] = q;
      if (a.time) s.e_ts[ev] = a.rts0[o];
      if (q >= 0 && q < G) {
        const size_t kk = pe + s.ent_off[pg + q] + cent[q] +
                          s.kent_in[static_cast<size_t>(p) * W + v];
        s.ent[kk] = v;
        for (int f = 0; f < VF; ++f) s.ent_f[kk * VF + f] = a.rf0[o * VF + f];
        for (int f = 0; f < VI; ++f) s.ent_i[kk * VI + f] = a.ri0[o * VI + f];
        if (a.time) s.ent_ts[kk] = a.rts0[o];
      }
    } else {
      const int t = i0 + j;
      const size_t e = static_cast<size_t>(p) * T + t;
      const int q = a.gid[e];
      const int ok = a.ok[e] != 0;
      const int r = s.tile_acc[static_cast<size_t>(p) * s.ntb + b] +
                    s.acc_in[e];
      const int k = cent[q] + s.kacc_in[e];
      s.hi[e] = cnt0 + r + ok;
      s.bpos[e] = k + ok;
      if (!a.time || a.forever) {            // EVC: the walk's alone
        const size_t j = static_cast<size_t>(p) * T + s.evc_off[pg + q] +
                         s.cnt_evc[(static_cast<size_t>(p) * s.ntb + b) * G +
                                   q] + s.kall_in[e];
        s.evc[j] = ok ? t : ~t;
        s.evc_hi[j] = cnt0 + r + ok;
        for (int f = 0; f < VF; ++f) s.evc_f[j * VF + f] = a.vf[e * VF + f];
        for (int f = 0; f < VI; ++f) s.evc_i[j * VI + f] = a.vi[e * VI + f];
      }
      if (ok) {
        const int v = cnt0 + r;
        const size_t ev = pe + v, kk = pe + s.ent_off[pg + q] + k;
        for (int f = 0; f < VF; ++f) {
          s.e_f[ev * VF + f] = a.vf[e * VF + f];
          s.ent_f[kk * VF + f] = a.vf[e * VF + f];
        }
        for (int f = 0; f < VI; ++f) {
          s.e_i[ev * VI + f] = a.vi[e * VI + f];
          s.ent_i[kk * VI + f] = a.vi[e * VI + f];
        }
        s.e_g[ev] = q;
        if (a.time) {
          s.e_ts[ev] = a.ts[e];
          s.ent_ts[kk] = a.ts[e];
        }
        s.ent[kk] = v;
      }
    }
  }
}

// ------------------------------------------------------------ walk (C)

// A thread per (lane, group), kWalkThreads to a CTA (the groups of one lane
// spread over SMs): kLanes float and int lanes at a time in registers, one
// walk of the group's chains per kLanes lanes.  Entry v has left the window
// at an event when v < its hi - W: every such entry of the group is evicted
// before the event's add (the entry the event itself evicts included), the
// rest after the group's last event.  Both chains are read as the scatter's
// chain-ordered copies, so no load waits on another; the next event's are
// issued before the current one is applied.
__global__ void __launch_bounds__(kWalkThreads) gagg_walk_kernel(const Args a) {
  const Split& s = a.sp;
  const int p = blockIdx.x, q = blockIdx.y * kWalkThreads + threadIdx.x;
  const int T = a.T, W = a.W, G = a.G, VF = a.VF, VI = a.VI;
  if (q >= G) return;
  const int* L = s.lane + static_cast<size_t>(p) * 4;
  const int end = L[0] + L[2];               // cnt0 + the accepted events
  const bool time = a.time != 0;
  const bool upd = a.forever || (!time && a.minmax && W == 0);
  const bool windowed = time || (a.minmax && W > 0);
  const bool walk = !time || a.forever;
  const size_t pq = static_cast<size_t>(p) * G + q;
  const size_t jo = static_cast<size_t>(p) * T + s.evc_off[pq];
  const size_t ko = static_cast<size_t>(p) * s.ne + s.ent_off[pq];
  const int* evc = s.evc + jo;
  const int* ehi = s.evc_hi + jo;
  const float* evf = s.evc_f + jo * VF;
  const int* evi = s.evc_i + jo * VI;
  const int* ent = s.ent + ko;
  const float* enf = s.ent_f + ko * VF;
  const int* eni = s.ent_i + ko * VI;
  const int n_evc = walk ? s.evc_len[pq] : 0;
  const int n_ent = (time || W == 0) ? 0 : s.ent_len[pq];
  const int nl = max(max(VF, VI), 1);
  for (int l0 = 0; l0 < nl; l0 += kLanes) {
    const int nf = min(max(VF - l0, 0), kLanes);
    const int ni = min(max(VI - l0, 0), kLanes);
    float fh[kLanes], fl[kLanes], mnf[kLanes], mxf[kLanes], nx[kLanes];
    int ih[kLanes], il[kLanes], mni[kLanes], mxi[kLanes], nxi[kLanes];
#pragma unroll
    for (int m = 0; m < kLanes; ++m) {
      const size_t of = pq * VF + l0 + m, oi = pq * VI + l0 + m;
      fh[m] = fl[m] = mnf[m] = mxf[m] = nx[m] = 0.0f;
      ih[m] = il[m] = mni[m] = mxi[m] = nxi[m] = 0;
      if (m < nf) {
        if (!time) {
          fh[m] = a.fhi0[of];
          fl[m] = a.flo0[of];
        }
        mnf[m] = a.mnf0[of];
        mxf[m] = a.mxf0[of];
      }
      if (m < ni) {
        if (!time) {
          ih[m] = a.ihi0[oi];
          il[m] = a.ilo0[oi];
        }
        mni[m] = a.mni0[oi];
        mxi[m] = a.mxi0[oi];
      }
    }
    int gc = time ? 0 : a.gc0[pq];
    int ntt = 0, nhi = end;                  // the next event, loaded ahead
    auto load_event = [&](int j) {
      ntt = evc[j];
      nhi = ehi[j];
#pragma unroll
      for (int m = 0; m < kLanes; ++m) {
        if (m < nf) nx[m] = evf[static_cast<size_t>(j) * VF + l0 + m];
        if (m < ni) nxi[m] = evi[static_cast<size_t>(j) * VI + l0 + m];
      }
    };
    if (n_evc > 0) load_event(0);
    int k = 0, nv = n_ent > 0 ? ent[0] : kNever;
    for (int j = 0; j <= n_evc; ++j) {
      const int tt = ntt, lim = nhi - W;
      float xf[kLanes];
      int xi[kLanes];
#pragma unroll
      for (int m = 0; m < kLanes; ++m) {
        xf[m] = nx[m];
        xi[m] = nxi[m];
      }
      if (j + 1 < n_evc) {
        load_event(j + 1);
      } else {
        nhi = end;                           // after the last: the rest
      }
      while (nv < lim) {                     // evict before the add
        const size_t kv = k;
        const int after = k + 1 < n_ent ? ent[k + 1] : kNever;
#pragma unroll
        for (int m = 0; m < kLanes; ++m) {
          if (m < nf) pair_add(fh[m], fl[m], -(enf[kv * VF + l0 + m] + 0.0f));
          if (m < ni) {
            const int old = eni[kv * VI + l0 + m];
            ih[m] = iadd(ih[m], -(old >> 16));
            il[m] = iadd(il[m], -(old & 65535));
          }
        }
        gc = iadd(gc, -1);
        ++k;
        nv = after;
      }
      if (j == n_evc) break;
      const bool ok = tt >= 0;
      const size_t e = static_cast<size_t>(p) * T + (ok ? tt : ~tt);
      if (ok) {
#pragma unroll
        for (int m = 0; m < kLanes; ++m) {
          if (m < nf) {
            if (!time) pair_add(fh[m], fl[m], xf[m]);
            if (upd) {
              mnf[m] = fmin_ieee(mnf[m], xf[m]);
              mxf[m] = fmax_ieee(mxf[m], xf[m]);
            }
          }
          if (m < ni) {
            if (!time) {
              ih[m] = iadd(ih[m], xi[m] >> 16);
              il[m] = iadd(il[m], xi[m] & 65535);
            }
            if (upd) {
              mni[m] = min(mni[m], xi[m]);
              mxi[m] = max(mxi[m], xi[m]);
            }
          }
        }
        gc = iadd(gc, 1);
      }
#pragma unroll
      for (int m = 0; m < kLanes; ++m) {
        if (m < nf) {
          const size_t o = e * VF + l0 + m;
          if (!time) {
            a.o_fhi[o] = fh[m];
            a.o_flo[o] = fl[m];
          }
          if (!windowed) {
            a.o_wmnf[o] = mnf[m];
            a.o_wmxf[o] = mxf[m];
          }
          a.o_amnf[o] = mnf[m];
          a.o_amxf[o] = mxf[m];
        }
        if (m < ni) {
          const size_t o = e * VI + l0 + m;
          if (!time) {
            a.o_ihi[o] = ih[m];
            a.o_ilo[o] = il[m];
          }
          if (!windowed) {
            a.o_wmni[o] = mni[m];
            a.o_wmxi[o] = mxi[m];
          }
          a.o_amni[o] = mni[m];
          a.o_amxi[o] = mxi[m];
        }
      }
      if (!time && l0 == 0) a.o_cnt[e] = gc;
    }
#pragma unroll
    for (int m = 0; m < kLanes; ++m) {
      const size_t of = pq * VF + l0 + m, oi = pq * VI + l0 + m;
      if (m < nf) {
        if (!time) {
          a.fhi[of] = fh[m];
          a.flo[of] = fl[m];
        }
        a.mnf[of] = mnf[m];
        a.mxf[of] = mxf[m];
      }
      if (m < ni) {
        if (!time) {
          a.ihi[oi] = ih[m];
          a.ilo[oi] = il[m];
        }
        a.mni[oi] = mni[m];
        a.mxi[oi] = mxi[m];
      }
    }
    if (!time && l0 == 0) a.gc[pq] = gc;
  }
}

// --------------------------------------------------------- windows (D)

// The slot of virtual index v, and the entry in slot sl at an event whose
// window ends at hi (negative: a slot not yet filled).
__device__ __forceinline__ int rev_slot(int sl, int W) {
  return W > 1 ? static_cast<int>(__brev(static_cast<unsigned>(sl)) >>
                                  (32 - (31 - __clz(W))))
               : 0;
}

// One thread: the live entries of a short range, at ENT positions
// cand[0, n) of the lane's copies (K7b: sorted here by bit-reversed slot).
__device__ void short_range(const Args& a, size_t e, size_t pe,
                            const int* cand, int n, int first) {
  const Split& s = a.sp;
  const int VF = a.VF, VI = a.VI, W = a.W;
  for (int f = 0; f < VF; ++f) {
    float mn = INFINITY, mx = -INFINITY;
    for (int k = 0; k < n; ++k) {
      const float x = s.ent_f[(pe + cand[k]) * VF + f];
      mn = fmin_ieee(mn, x);
      mx = fmax_ieee(mx, x);
    }
    a.o_wmnf[e * VF + f] = mn;
    a.o_wmxf[e * VF + f] = mx;
  }
  for (int f = 0; f < VI; ++f) {
    int sh = 0, sl = 0, mn = kI32Max, mx = kI32Min;
    for (int k = 0; k < n; ++k) {
      const int x = s.ent_i[(pe + cand[k]) * VI + f];
      sh = iadd(sh, x >> 16);
      sl = iadd(sl, x & 65535);
      mn = min(mn, x);
      mx = max(mx, x);
    }
    a.o_wmni[e * VI + f] = mn;
    a.o_wmxi[e * VI + f] = mx;
    if (a.time) {
      a.o_ihi[e * VI + f] = sh;
      a.o_ilo[e * VI + f] = sl;
    }
  }
  if (!a.time) return;
  a.o_cnt[e] = n;
  // the sparse tree: nodes (slot, hi, lo) in bit-reversed slot order, so
  // that siblings i and i + half are neighbours at every level
  int slot[kShortArr], key[kShortArr], vv[kShortArr];
  for (int k = 0; k < n; ++k) {
    const int sl = (first + s.ent[pe + cand[k]]) & (W - 1);
    const int ky = rev_slot(sl, W);
    int m = k;
    for (; m > 0 && key[m - 1] > ky; --m) {
      key[m] = key[m - 1];
      slot[m] = slot[m - 1];
      vv[m] = vv[m - 1];
    }
    key[m] = ky;
    slot[m] = sl;
    vv[m] = cand[k];
  }
  for (int f = 0; f < VF; ++f) {
    int id[kShortArr];
    float th[kShortArr], tl[kShortArr];
    for (int k = 0; k < n; ++k) {
      id[k] = slot[k];
      th[k] = s.ent_f[(pe + vv[k]) * VF + f];
      tl[k] = 0.0f;
    }
    int m = n;
    for (int w = W; w > 1; w >>= 1) {
      const int half = w >> 1;
      int out = 0, k = 0;
      while (k < m) {
        const int i = id[k];
        float ah = 0.0f, al = 0.0f, bh = 0.0f, bl = 0.0f;
        if (i & half) {
          bh = th[k];
          bl = tl[k];
          k += 1;
        } else if (k + 1 < m && id[k + 1] == i + half) {
          ah = th[k];
          al = tl[k];
          bh = th[k + 1];
          bl = tl[k + 1];
          k += 2;
        } else {
          ah = th[k];
          al = tl[k];
          k += 1;
        }
        tree_node(ah, al, bh, bl, th[out], tl[out]);
        id[out++] = i & (half - 1);
      }
      m = out;
    }
    a.o_fhi[e * VF + f] = m ? th[0] : 0.0f;
    a.o_flo[e * VF + f] = m ? tl[0] : 0.0f;
  }
}

// The warp, K7a: the group's chain (from ENT position ko of the lane's
// copies) walked down from b - 1, 32 entries a step, until one falls below
// the window.
__device__ void long_walk(const Args& a, size_t e, size_t ko, int b,
                          int lo) {
  const Split& s = a.sp;
  const int l = threadIdx.x & 31, VF = a.VF, VI = a.VI;
  const int* ent = s.ent + ko;
  for (int f = 0; f < VF; ++f) {
    float mn = INFINITY, mx = -INFINITY;
    for (int top = b - 1;; top -= 32) {
      const int k = top - l;
      const bool in = k >= 0 && ent[k] >= lo;
      if (in) {
        const float x = s.ent_f[(ko + k) * VF + f];
        mn = fmin_ieee(mn, x);
        mx = fmax_ieee(mx, x);
      }
      if (__ballot_sync(kFull, in) != kFull) break;
    }
    mn = warp_fmin(mn);
    mx = warp_fmax(mx);
    if (l == 0) {
      a.o_wmnf[e * VF + f] = mn;
      a.o_wmxf[e * VF + f] = mx;
    }
  }
  for (int f = 0; f < VI; ++f) {
    int mn = kI32Max, mx = kI32Min;
    for (int top = b - 1;; top -= 32) {
      const int k = top - l;
      const bool in = k >= 0 && ent[k] >= lo;
      if (in) {
        const int x = s.ent_i[(ko + k) * VI + f];
        mn = min(mn, x);
        mx = max(mx, x);
      }
      if (__ballot_sync(kFull, in) != kFull) break;
    }
    mn = warp_imin(mn);
    mx = warp_imax(mx);
    if (l == 0) {
      a.o_wmni[e * VI + f] = mn;
      a.o_wmxi[e * VI + f] = mx;
    }
  }
}

// The warp, K7b: every plane over the W slots of the ring at the event,
// the float sums by the dense tree in shared memory (TH, TL: W / 2 pairs).
__device__ void long_tree(const Args& a, size_t e, int q, int hi, int lo_ts,
                          int first, float* TH) {
  const Split& s = a.sp;
  const int l = threadIdx.x & 31, W = a.W, VF = a.VF, VI = a.VI;
  const int half = W > 1 ? W / 2 : 1;
  float* TL = TH + half;
  const size_t pe = (e / a.T) * s.ne;
  auto entry = [&](int sl) {                 // the live entry in slot sl
    const int v = hi - 1 - ((hi - 1 + first - sl) & (W - 1));
    return (v >= 0 && s.e_g[pe + v] == q && s.e_ts[pe + v] > lo_ts) ? v : -1;
  };
  const float z = 0.0f;
  for (int f = 0; f < VF; ++f) {
    float mn = INFINITY, mx = -INFINITY;
    if (W == 1) {
      if (l == 0) {
        const int v = entry(0);
        TH[0] = v >= 0 ? s.e_f[(pe + v) * VF + f] : 0.0f;
        TL[0] = 0.0f;
        if (v >= 0) mn = mx = TH[0];
      }
    } else {
      for (int i = l; i < half; i += 32) {   // level 1 while reading
        const int va = entry(i), vb = entry(i + half);
        const float ah = va >= 0 ? s.e_f[(pe + va) * VF + f] : 0.0f;
        const float bh = vb >= 0 ? s.e_f[(pe + vb) * VF + f] : 0.0f;
        if (va >= 0) { mn = fmin_ieee(mn, ah); mx = fmax_ieee(mx, ah); }
        if (vb >= 0) { mn = fmin_ieee(mn, bh); mx = fmax_ieee(mx, bh); }
        tree_node(ah, z, bh, z, TH[i], TL[i]);
      }
      __syncwarp();
      for (int w = half; w > 1; w >>= 1) {
        const int h2 = w >> 1;
        for (int i = l; i < h2; i += 32)
          tree_node(TH[i], TL[i], TH[i + h2], TL[i + h2], TH[i], TL[i]);
        __syncwarp();
      }
    }
    mn = warp_fmin(mn);
    mx = warp_fmax(mx);
    if (l == 0) {
      a.o_fhi[e * VF + f] = TH[0];
      a.o_flo[e * VF + f] = TL[0];
      a.o_wmnf[e * VF + f] = mn;
      a.o_wmxf[e * VF + f] = mx;
    }
    __syncwarp();                            // TH[0] read before reuse
  }
  int c = 0;
  for (int sl = l; sl < W; sl += 32) c += entry(sl) >= 0 ? 1 : 0;
  c = warp_iadd(c);
  if (l == 0) a.o_cnt[e] = c;
  for (int f = 0; f < VI; ++f) {
    int sh = 0, sl_ = 0, mn = kI32Max, mx = kI32Min;
    for (int sl = l; sl < W; sl += 32) {
      const int v = entry(sl);
      if (v < 0) continue;
      const int x = s.e_i[(pe + v) * VI + f];
      sh = iadd(sh, x >> 16);
      sl_ = iadd(sl_, x & 65535);
      mn = min(mn, x);
      mx = max(mx, x);
    }
    sh = warp_iadd(sh);
    sl_ = warp_iadd(sl_);
    mn = warp_imin(mn);
    mx = warp_imax(mx);
    if (l == 0) {
      a.o_ihi[e * VI + f] = sh;
      a.o_ilo[e * VI + f] = sl_;
      a.o_wmni[e * VI + f] = mn;
      a.o_wmxi[e * VI + f] = mx;
    }
  }
}

__global__ void __launch_bounds__(kBlock) gagg_windows_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Split& s = a.sp;
  const int p = blockIdx.x, T = a.T, W = a.W, G = a.G;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const bool valid = t < T;
  const int* L = s.lane + static_cast<size_t>(p) * 4;
  const int first = L[1];
  const size_t e = static_cast<size_t>(p) * T + (valid ? t : 0);
  const size_t pe = static_cast<size_t>(p) * s.ne;
  int q = 0, hi = 0, b = 0, lo = 0, lo_ts = 0, base = 0;
  bool lng = false;
  if (valid) {
    q = a.gid[e];
    hi = s.hi[e];
    b = s.bpos[e];
    lo = max(0, hi - W);
    base = s.ent_off[static_cast<size_t>(p) * G + q];
    if (a.time) lo_ts = iadd(a.ts[e], -a.window_ms);
    const int* ent = s.ent + pe + base;
    lng = b - 1 - kShort >= 0 && ent[b - 1 - kShort] >= lo;
    if (!lng) {
      int cand[kShortArr], n = 0;
      for (int k = b - 1, m = 0; k >= 0 && m < kShort; --k, ++m) {
        if (ent[k] < lo) break;
        if (!a.time || s.ent_ts[pe + base + k] > lo_ts) cand[n++] = base + k;
      }
      short_range(a, e, pe, cand, n, first);
    }
    if (a.time) {
      const int v = hi - 1 - W;              // the entry this event evicts
      if (a.ok[e] && v >= 0 &&
          s.e_ts[static_cast<size_t>(p) * s.ne + v] > lo_ts)
        a.ovf[p] = 1;
      if (!a.forever) {                      // the carry's extrema stand
        const size_t pq = static_cast<size_t>(p) * G + q;
        for (int f = 0; f < a.VF; ++f) {
          a.o_amnf[e * a.VF + f] = a.mnf0[pq * a.VF + f];
          a.o_amxf[e * a.VF + f] = a.mxf0[pq * a.VF + f];
        }
        for (int f = 0; f < a.VI; ++f) {
          a.o_amni[e * a.VI + f] = a.mni0[pq * a.VI + f];
          a.o_amxi[e * a.VI + f] = a.mxi0[pq * a.VI + f];
        }
      }
    }
  }
  float* TH = smem + (threadIdx.x >> 5) * static_cast<size_t>(max(W, 2));
  for (unsigned todo = __ballot_sync(kFull, lng); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int tt = __shfl_sync(kFull, t, src);
    const int q_ = __shfl_sync(kFull, q, src);
    const int hi_ = __shfl_sync(kFull, hi, src);
    const size_t e_ = static_cast<size_t>(p) * T + tt;
    if (a.time)
      long_tree(a, e_, q_, hi_, __shfl_sync(kFull, lo_ts, src), first, TH);
    else
      long_walk(a, e_, pe + __shfl_sync(kFull, base, src),
                __shfl_sync(kFull, b, src), __shfl_sync(kFull, lo, src));
  }
}

// ------------------------------------------------------------- ring (E)

__global__ void __launch_bounds__(kBlock) gagg_ring_kernel(const Args a) {
  const Split& s = a.sp;
  const int p = blockIdx.x, W = a.W, VF = a.VF, VI = a.VI;
  const int sl = blockIdx.y * kBlock + threadIdx.x;
  const int* L = s.lane + static_cast<size_t>(p) * 4;
  const int cnt0 = L[0], first = L[1], n_acc = L[2], pos0 = L[3];
  if (sl < W) {
    const int end = cnt0 + n_acc;
    int d = (end - 1 + first - sl) % W;
    if (d < 0) d += W;
    const int v = end - 1 - d;               // the newest entry in slot sl
    const size_t o = static_cast<size_t>(p) * W + sl;
    if (v >= cnt0) {
      const size_t ev = static_cast<size_t>(p) * s.ne + v;
      for (int f = 0; f < VF; ++f) a.rf[o * VF + f] = s.e_f[ev * VF + f];
      for (int f = 0; f < VI; ++f) a.ri[o * VI + f] = s.e_i[ev * VI + f];
      a.rg[o] = s.e_g[ev];
      if (a.time) a.rts[o] = s.e_ts[ev];
    } else if (!a.inplace) {                 // the carry's slot stands
      for (int f = 0; f < VF; ++f) a.rf[o * VF + f] = a.rf0[o * VF + f];
      for (int f = 0; f < VI; ++f) a.ri[o * VI + f] = a.ri0[o * VI + f];
      a.rg[o] = a.rg0[o];
      if (a.time) a.rts[o] = a.rts0[o];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    a.pos[p] = W > 0 ? (pos0 + n_acc) % W : pos0;
    a.cnt[p] = W > 0 ? min(cnt0 + n_acc, W) : cnt0;
  }
}

void mark(int k, cudaStream_t st) {
  if (k < g_n_marks) cudaEventRecord(g_marks[k], st);
}

// Every pass of one step on stream st; returns cudaGetLastError() after
// each launch (the first failure).
int run_passes(Args& a, void* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.sp = split_layout(a.P, a.T, a.W, a.G, a.VF, a.VI, a.time != 0,
                      static_cast<int*>(scratch));
  const Split& s = a.sp;
  const dim3 tiles(a.P, s.nt), groups(a.P, (a.G + kGroupThreads - 1) /
                                                kGroupThreads);
  const bool windowed = a.time || (a.minmax && a.W > 0);
  int warps = kWarps;
  size_t smem = 0;
  if (a.time) {                              // a tree of W floats a warp
    const size_t tree = static_cast<size_t>(std::max(a.W, 2)) * 4;
    if (tree > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    warps = static_cast<int>(std::min(static_cast<size_t>(kWarps),
                                      kSmemMax / tree));
    smem = tree * warps;
  }
  const int bd = 32 * warps;
  const int ring_tiles = std::max((a.W + kBlock - 1) / kBlock, 1);
  if (s.nt > 65535 || groups.y > 65535 || (a.T + bd - 1) / bd > 65535 ||
      ring_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  mark(0, st);
  gagg_count_kernel<<<tiles, kBlock, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mark(1, st);
  gagg_scan_groups_kernel<<<groups, kGroupThreads, 0, st>>>(a);
  gagg_scan_lane_kernel<<<a.P, kBlock, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mark(2, st);
  gagg_scatter_kernel<<<tiles, kBlock, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mark(3, st);
  gagg_walk_kernel<<<dim3(a.P, (a.G + kWalkThreads - 1) / kWalkThreads),
                     kWalkThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mark(4, st);
  if (windowed) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             reinterpret_cast<const void*>(gagg_windows_kernel),
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return static_cast<int>(err);
    gagg_windows_kernel<<<dim3(a.P, (a.T + bd - 1) / bd), bd, smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  mark(5, st);
  gagg_ring_kernel<<<dim3(a.P, ring_tiles), kBlock, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mark(6, st);
  return 0;
}

template <typename X>
X take(void* const* ptrs, int& k) {
  return static_cast<X>(ptrs[k++]);
}

}  // namespace

// Words of int32 scratch one step needs (time: K7b).
extern "C" long long gagg_scratch_words(int P, int T, int W, int G, int VF,
                                        int VI, int time) {
  if (P <= 0 || T <= 0) return 0;
  return static_cast<long long>(
      split_layout(P, T, W, G, VF, VI, time != 0, nullptr).words);
}

// Record events[k] (cudaEvent_t handles) at the k-th pass boundary of every
// later step, k < n (at most 7: before count, after count, the scans,
// scatter, walk, windows and ring); n = 0 stops.
extern "C" int gagg_time_passes(void* const* events, int n) {
  g_n_marks = n < 0 ? 0 : (n > kMarks ? kMarks : n);
  for (int k = 0; k < g_n_marks; ++k)
    g_marks[k] = static_cast<cudaEvent_t>(events[k]);
  return 0;
}

// K7a.  ptrs: vals_f, vals_i, gids, accepted, the carry in (14 leaves in
// GroupedAggCarry order), the carry out (14; equal to the carry in when in
// place), the 13 output planes, the scratch.  dims: P, T, W, G, VF, VI,
// want_minmax, want_forever, inplace.  Returns the first failed launch's
// cudaGetLastError(), else 0.
extern "C" int gagg_step(void* const* ptrs, const int* dims, void* stream) {
  Args a = {};
  int k = 0;
  a.vf = take<const float*>(ptrs, k);
  a.vi = take<const int*>(ptrs, k);
  a.gid = take<const int*>(ptrs, k);
  a.ok = take<const uint8_t*>(ptrs, k);
  a.rf0 = take<const float*>(ptrs, k);
  a.ri0 = take<const int*>(ptrs, k);
  a.rg0 = take<const int*>(ptrs, k);
  a.pos0 = take<const int*>(ptrs, k);
  a.cnt0 = take<const int*>(ptrs, k);
  a.fhi0 = take<const float*>(ptrs, k);
  a.flo0 = take<const float*>(ptrs, k);
  a.ihi0 = take<const int*>(ptrs, k);
  a.ilo0 = take<const int*>(ptrs, k);
  a.gc0 = take<const int*>(ptrs, k);
  a.mnf0 = take<const float*>(ptrs, k);
  a.mxf0 = take<const float*>(ptrs, k);
  a.mni0 = take<const int*>(ptrs, k);
  a.mxi0 = take<const int*>(ptrs, k);
  a.rf = take<float*>(ptrs, k);
  a.ri = take<int*>(ptrs, k);
  a.rg = take<int*>(ptrs, k);
  a.pos = take<int*>(ptrs, k);
  a.cnt = take<int*>(ptrs, k);
  a.fhi = take<float*>(ptrs, k);
  a.flo = take<float*>(ptrs, k);
  a.ihi = take<int*>(ptrs, k);
  a.ilo = take<int*>(ptrs, k);
  a.gc = take<int*>(ptrs, k);
  a.mnf = take<float*>(ptrs, k);
  a.mxf = take<float*>(ptrs, k);
  a.mni = take<int*>(ptrs, k);
  a.mxi = take<int*>(ptrs, k);
  a.o_fhi = take<float*>(ptrs, k);
  a.o_flo = take<float*>(ptrs, k);
  a.o_ihi = take<int*>(ptrs, k);
  a.o_ilo = take<int*>(ptrs, k);
  a.o_cnt = take<int*>(ptrs, k);
  a.o_wmnf = take<float*>(ptrs, k);
  a.o_wmxf = take<float*>(ptrs, k);
  a.o_wmni = take<int*>(ptrs, k);
  a.o_wmxi = take<int*>(ptrs, k);
  a.o_amnf = take<float*>(ptrs, k);
  a.o_amxf = take<float*>(ptrs, k);
  a.o_amni = take<int*>(ptrs, k);
  a.o_amxi = take<int*>(ptrs, k);
  void* scratch = ptrs[k];
  a.P = dims[0];
  a.T = dims[1];
  a.W = dims[2];
  a.G = dims[3];
  a.VF = dims[4];
  a.VI = dims[5];
  a.minmax = dims[6];
  a.forever = dims[7];
  a.inplace = dims[8];
  a.time = 0;
  if (a.P <= 0 || a.T <= 0) return 0;
  if (a.W < 0 || a.G <= 0 || a.VF < 0 || a.VI < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return run_passes(a, scratch, stream);
}

// K7b.  ptrs: vals_f, vals_i, gids, ts, accepted, the carry in (11 leaves in
// GroupedTimeCarry order), the carry out (11, distinct), the 13 output
// planes, the scratch.  dims: P, T, W (the ring's capacity, a power of two),
// G, VF, VI, window_ms, want_forever.  Returns the first failed launch's
// cudaGetLastError(), else 0.
extern "C" int gagg_time_step(void* const* ptrs, const int* dims,
                              void* stream) {
  Args a = {};
  int k = 0;
  a.vf = take<const float*>(ptrs, k);
  a.vi = take<const int*>(ptrs, k);
  a.gid = take<const int*>(ptrs, k);
  a.ts = take<const int*>(ptrs, k);
  a.ok = take<const uint8_t*>(ptrs, k);
  a.rf0 = take<const float*>(ptrs, k);
  a.ri0 = take<const int*>(ptrs, k);
  a.rg0 = take<const int*>(ptrs, k);
  a.rts0 = take<const int*>(ptrs, k);
  a.pos0 = take<const int*>(ptrs, k);
  a.cnt0 = take<const int*>(ptrs, k);
  a.ovf0 = take<const uint8_t*>(ptrs, k);
  a.mnf0 = take<const float*>(ptrs, k);
  a.mxf0 = take<const float*>(ptrs, k);
  a.mni0 = take<const int*>(ptrs, k);
  a.mxi0 = take<const int*>(ptrs, k);
  a.rf = take<float*>(ptrs, k);
  a.ri = take<int*>(ptrs, k);
  a.rg = take<int*>(ptrs, k);
  a.rts = take<int*>(ptrs, k);
  a.pos = take<int*>(ptrs, k);
  a.cnt = take<int*>(ptrs, k);
  a.ovf = take<uint8_t*>(ptrs, k);
  a.mnf = take<float*>(ptrs, k);
  a.mxf = take<float*>(ptrs, k);
  a.mni = take<int*>(ptrs, k);
  a.mxi = take<int*>(ptrs, k);
  a.o_fhi = take<float*>(ptrs, k);
  a.o_flo = take<float*>(ptrs, k);
  a.o_ihi = take<int*>(ptrs, k);
  a.o_ilo = take<int*>(ptrs, k);
  a.o_cnt = take<int*>(ptrs, k);
  a.o_wmnf = take<float*>(ptrs, k);
  a.o_wmxf = take<float*>(ptrs, k);
  a.o_wmni = take<int*>(ptrs, k);
  a.o_wmxi = take<int*>(ptrs, k);
  a.o_amnf = take<float*>(ptrs, k);
  a.o_amxf = take<float*>(ptrs, k);
  a.o_amni = take<int*>(ptrs, k);
  a.o_amxi = take<int*>(ptrs, k);
  void* scratch = ptrs[k];
  a.P = dims[0];
  a.T = dims[1];
  a.W = dims[2];
  a.G = dims[3];
  a.VF = dims[4];
  a.VI = dims[5];
  a.window_ms = dims[6];
  a.forever = dims[7];
  a.minmax = 1;
  a.inplace = 0;
  a.time = 1;
  if (a.P <= 0 || a.T <= 0) return 0;
  if (a.W <= 0 || (a.W & (a.W - 1)) || a.G <= 0 || a.VF < 0 || a.VI < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return run_passes(a, scratch, stream);
}
