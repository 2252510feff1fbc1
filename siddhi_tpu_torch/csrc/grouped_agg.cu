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
// out, the 13 output planes.  K7a writes a fresh carry or, where the JAX
// package donates it, updates the carry in place (the two pointer sets are
// equal); K7b always writes a fresh one (a ring-overflow replay rewinds to
// the pre-step carry).
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
//     _pair_tree_sum: level by level, element i meets element i + half; the
//     first level is done while the live slots are read, the rest in shared
//     memory;
//   - int lanes split at 2^16 (arithmetic >> 16, & 65535) with wrapping
//     int32 adds, as XLA's.
//
// What bounds it on this card.  Per event the function reads its inputs
// and writes 13 output rows, and the masked reductions read the live ring
// of the lane (W slots); K7a with min/max and K7b do O(W) compares or adds
// per event, which at W = 1000 and the cells' T makes them bound by
// operations on paper (chip_smoke.py phase 12 computes the bound per
// launch).  What stands in the way is the serial chain the semantics fix:
// each event's outputs depend on every earlier event of the lane, and the
// unkeyed query is one lane holding the whole stream (the JAX package's
// own structure: vmap over P = 1, scan over T).
//
// The design (simple first): one warp per lane (a CTA of 32 threads, grid
// P) walks its events in order.  Shared memory holds, in this order of
// priority (gagg_plan() below sizes it):
//   - a tile of kTile events' inputs, loaded together (coalesced) ahead of
//     the walk, so no event waits on a device-memory load of its own;
//   - K7b's pairwise tree, [W/2] (hi, lo) pairs, and sparse_tree's scratch;
//   - the lane's group slabs, when they fit;
//   - the lane's ring, when it fits;
//   - each group's live slots as a list (struct Lists), when it fits.
// What does not fit works from the out carry in device memory through the
// same generic pointers.  A group holding at most kShort live entries is
// reduced by thread 0 walking its list (K7b rebuilds the pairwise tree from
// the entries' slot positions, sparse_tree); a longer one by the whole warp
// in a pass over the ring (threads split the W slots, shuffles combine).
// Threads split the value lanes V for the updates; __syncwarp orders the
// steps of an event.  At the unkeyed cells' shapes (P = 1, 1,024 groups
// over a 1,000-entry window) nearly every group is short: chip_smoke.py
// phase 12 times the kernels there.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 32;                 // one warp per lane
constexpr int kTile = 128;                   // events staged at a time
constexpr size_t kSmemMax = 160 * 1024;      // a CTA's shared-memory budget
constexpr int kShort = 32;  // group lists one thread walks (0: no lists)
constexpr int kI32Max = 2147483647;
constexpr int kI32Min = -2147483647 - 1;

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

template <typename X>
__device__ __forceinline__ void lane_copy(X* dst, const X* src, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// The group slabs of lane p: in shared memory or in the out carry (copied
// from the carry in first unless the step is in place).
struct Groups {
  float *fhi, *flo, *mnf, *mxf;
  int *ihi, *ilo, *mni, *mxi, *gc;
};

// Where a lane's working set lives: word offsets into the dynamic shared
// memory, -1 for a part kept in device memory or left out (gagg_plan()
// decides).
struct Layout {
  int tile, tree, scratch, groups, ring, lists;
  size_t words;
};

// The event tile: kTile events' inputs, staged together.
struct Tile {
  float* f;
  int *i, *g, *ok, *ts;
};

__device__ __forceinline__ Tile tile_at(float* smem, int off, int VF,
                                        int VI) {
  Tile tl;
  tl.f = smem + off;
  tl.i = reinterpret_cast<int*>(tl.f + kTile * VF);
  tl.g = tl.i + kTile * VI;
  tl.ok = tl.g + kTile;
  tl.ts = tl.ok + kTile;
  return tl;
}

// Stage events [t0, t0 + n) of lane p (row e0 = p * T + t0); ts may be
// null (K7a).
__device__ __forceinline__ void load_tile(const Tile& tl, size_t e0, int n,
                                          int VF, int VI, const float* vf,
                                          const int* vi, const int* gid,
                                          const uint8_t* ok, const int* ts) {
  for (int i = threadIdx.x; i < n * VF; i += kThreads)
    tl.f[i] = vf[e0 * VF + i];
  for (int i = threadIdx.x; i < n * VI; i += kThreads)
    tl.i[i] = vi[e0 * VI + i];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    tl.g[i] = gid[e0 + i];
    tl.ok[i] = ok[e0 + i];
    if (ts != nullptr) tl.ts[i] = ts[e0 + i];
  }
}

// Each group's live ring slots in arrival order, a list linked through
// nxt[] (kept by thread 0): a group holding at most kShort entries is
// reduced by walking its list instead of a pass over the whole ring.  Min,
// max and int sums do not depend on the order of their terms; K7b's float
// tree is rebuilt from the slots' positions (sparse_tree), so both ways
// give the same bits.
struct Lists {
  int *nxt, *head, *tail, *len;
};

__device__ __forceinline__ Lists lists_at(float* smem, int off, int W,
                                          int G) {
  Lists L;
  L.nxt = reinterpret_cast<int*>(smem + off);
  L.head = L.nxt + W;
  L.tail = L.head + G;
  L.len = L.tail + G;
  return L;
}

__device__ __forceinline__ void list_append(const Lists& L, int s, int g) {
  L.nxt[s] = -1;
  if (L.tail[g] >= 0)
    L.nxt[L.tail[g]] = s;
  else
    L.head[g] = s;
  L.tail[g] = s;
  L.len[g] += 1;
}

// Unlink slot s from group g's list (the head whenever the ring evicts
// its oldest entry).
__device__ __forceinline__ void list_remove(const Lists& L, int s, int g) {
  int prev = -1, cur = L.head[g];
  while (cur >= 0 && cur != s) {
    prev = cur;
    cur = L.nxt[cur];
  }
  if (cur < 0) return;
  if (prev < 0)
    L.head[g] = L.nxt[s];
  else
    L.nxt[prev] = L.nxt[s];
  if (L.tail[g] == s) L.tail[g] = prev;
  L.len[g] -= 1;
}

// The lists of the live slots [0, cnt), oldest first: a ring fills from
// slot 0 (pos == cnt until it is full), and a full ring's oldest slot is
// pos.  Every step keeps that invariant.
__device__ void lists_build(const Lists& L, const int* RG, int W, int G,
                            int pos, int cnt) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    L.head[g] = L.tail[g] = -1;
    L.len[g] = 0;
  }
  __syncwarp();
  if (threadIdx.x == 0) {
    const int first = cnt < W ? 0 : pos;
    for (int i = 0; i < cnt; ++i) {
      const int s = (first + i) % W;
      const int g = RG[s];
      if (g >= 0 && g < G) list_append(L, s, g);
    }
  }
  __syncwarp();
}

// The pairwise two-float tree of _pair_tree_sum over W leaves, of which only
// the k live slots live[] carry values (the rest are +0.0): level by level,
// node i meets node i + half, and a node with no live leaf below it is
// exactly (+0.0, +0.0), so only the nodes above live leaves are computed,
// with the same operations.  Thread 0; sc holds 8 * kShort words.
__device__ void sparse_tree(const float* RF, int VF, int v, const int* live,
                            int k, int W, float* sc, float& out_hi,
                            float& out_lo) {
  int* idx = reinterpret_cast<int*>(sc);
  float* hi = sc + kShort;
  float* lo = hi + kShort;
  int* nidx = reinterpret_cast<int*>(lo + kShort);
  float* ah = reinterpret_cast<float*>(nidx + kShort);
  float* al = ah + kShort;
  float* bh = al + kShort;
  float* bl = bh + kShort;
  for (int n = 0; n < k; ++n) {
    idx[n] = live[n];
    hi[n] = RF[static_cast<size_t>(live[n]) * VF + v];
    lo[n] = 0.0f;
  }
  for (int w = W; w > 1; w >>= 1) {
    const int half = w >> 1;
    int m = 0;
    for (int n = 0; n < k; ++n) {
      const int j = idx[n] & (half - 1);
      int q = 0;
      while (q < m && nidx[q] != j) ++q;
      if (q == m) {
        nidx[m] = j;
        ah[m] = al[m] = bh[m] = bl[m] = 0.0f;
        ++m;
      }
      if (idx[n] & half) {
        bh[q] = hi[n];
        bl[q] = lo[n];
      } else {
        ah[q] = hi[n];
        al[q] = lo[n];
      }
    }
    for (int q = 0; q < m; ++q) {
      float sm, er;
      two_sum(ah[q], bh[q], sm, er);
      const float lo2 = (al[q] + bl[q]) + er;
      const float h = sm + lo2;
      idx[q] = nidx[q];
      hi[q] = h;
      lo[q] = lo2 - (h - sm);
    }
    k = m;
  }
  out_hi = k ? hi[0] : 0.0f;
  out_lo = k ? lo[0] : 0.0f;
}

// ------------------------------------------------------------------ K7a

struct LenArgs {
  const float* vf; const int* vi; const int* gid; const uint8_t* ok;
  const float* rf0; const int* ri0; const int* rg0; const int* pos0;
  const int* cnt0; const float* fhi0; const float* flo0; const int* ihi0;
  const int* ilo0; const int* gc0; const float* mnf0; const float* mxf0;
  const int* mni0; const int* mxi0;
  float* rf; int* ri; int* rg; int* pos; int* cnt; float* fhi; float* flo;
  int* ihi; int* ilo; int* gc; float* mnf; float* mxf; int* mni; int* mxi;
  float* o_fhi; float* o_flo; int* o_ihi; int* o_ilo; int* o_cnt;
  float* o_wmnf; float* o_wmxf; int* o_wmni; int* o_wmxi;
  float* o_amnf; float* o_amxf; int* o_amni; int* o_amxi;
  int P, T, W, G, VF, VI, minmax, forever, inplace;
  Layout lay;
};

__global__ void __launch_bounds__(kThreads)
gagg_step_kernel(const LenArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x, l = threadIdx.x;
  const int T = a.T, W = a.W, G = a.G, VF = a.VF, VI = a.VI;
  const size_t gf = static_cast<size_t>(p) * G * VF;
  const size_t gi = static_cast<size_t>(p) * G * VI;
  const size_t gc = static_cast<size_t>(p) * G;
  const size_t wf = static_cast<size_t>(p) * W * VF;
  const size_t wi = static_cast<size_t>(p) * W * VI;
  const size_t wg = static_cast<size_t>(p) * W;
  const size_t nf = static_cast<size_t>(G) * VF, ni = static_cast<size_t>(G) * VI;
  Groups s;
  if (a.lay.groups >= 0) {
    s.fhi = smem + a.lay.groups;
    s.flo = s.fhi + nf;
    s.mnf = s.flo + nf;
    s.mxf = s.mnf + nf;
    s.ihi = reinterpret_cast<int*>(s.mxf + nf);
  } else {
    s = Groups{a.fhi + gf, a.flo + gf, a.mnf + gf, a.mxf + gf,
               a.ihi + gi, a.ilo + gi, a.mni + gi, a.mxi + gi, a.gc + gc};
  }
  if (a.lay.groups >= 0) {
    s.ilo = s.ihi + ni;
    s.mni = s.ilo + ni;
    s.mxi = s.mni + ni;
    s.gc = s.mxi + ni;
  }
  if (a.lay.groups >= 0 || !a.inplace) {
    lane_copy(s.fhi, a.fhi0 + gf, nf);
    lane_copy(s.flo, a.flo0 + gf, nf);
    lane_copy(s.mnf, a.mnf0 + gf, nf);
    lane_copy(s.mxf, a.mxf0 + gf, nf);
    lane_copy(s.ihi, a.ihi0 + gi, ni);
    lane_copy(s.ilo, a.ilo0 + gi, ni);
    lane_copy(s.mni, a.mni0 + gi, ni);
    lane_copy(s.mxi, a.mxi0 + gi, ni);
    lane_copy(s.gc, a.gc0 + gc, static_cast<size_t>(G));
  }
  float* RF;
  int *RI, *RG;
  if (a.lay.ring >= 0) {
    RF = smem + a.lay.ring;
    RI = reinterpret_cast<int*>(RF + static_cast<size_t>(W) * VF);
    RG = RI + static_cast<size_t>(W) * VI;
  } else {
    RF = a.rf + wf;
    RI = a.ri + wi;
    RG = a.rg + wg;
  }
  if (a.lay.ring >= 0 || !a.inplace) {
    lane_copy(RF, a.rf0 + wf, static_cast<size_t>(W) * VF);
    lane_copy(RI, a.ri0 + wi, static_cast<size_t>(W) * VI);
    lane_copy(RG, a.rg0 + wg, static_cast<size_t>(W));
  }
  const Tile tl = tile_at(smem, a.lay.tile, VF, VI);
  int pos = a.pos0[p], cnt = a.cnt0[p];
  const bool upd_forever = a.forever || (a.minmax && W == 0);
  const bool lists = a.lay.lists >= 0;
  Lists L{};
  __syncwarp();
  if (lists) {
    L = lists_at(smem, a.lay.lists, W, G);
    lists_build(L, RG, W, G, pos, cnt);
  }

  for (int t = 0; t < T; ++t) {
    const size_t e = static_cast<size_t>(p) * T + t;
    const int k = t % kTile;
    if (k == 0) {
      load_tile(tl, e, min(kTile, T - t), VF, VI, a.vf, a.vi, a.gid, a.ok,
                nullptr);
      __syncwarp();
    }
    const int g = tl.g[k];
    const bool ok = tl.ok[k] != 0;
    const float* xf = tl.f + k * VF;
    const int* xi = tl.i + k * VI;
    if (W > 0) {
      if (ok && cnt == W) {                  // evict the oldest entry
        const int og = RG[pos];
        for (int v = l; v < VF; v += kThreads) {
          const float old = RF[static_cast<size_t>(pos) * VF + v] + 0.0f;
          const size_t k = static_cast<size_t>(og) * VF + v;
          float hi = s.fhi[k], lo = s.flo[k];
          pair_add(hi, lo, -old);
          s.fhi[k] = hi;
          s.flo[k] = lo;
        }
        for (int v = l; v < VI; v += kThreads) {
          const int old = RI[static_cast<size_t>(pos) * VI + v];
          const size_t k = static_cast<size_t>(og) * VI + v;
          s.ihi[k] = iadd(s.ihi[k], -(old >> 16));
          s.ilo[k] = iadd(s.ilo[k], -(old & 65535));
        }
        if (l == 0) {
          s.gc[og] = iadd(s.gc[og], -1);
          if (lists) list_remove(L, pos, og);
        }
      }
      __syncwarp();                          // RG[pos] read before it moves
      if (ok) {
        for (int v = l; v < VF; v += kThreads)
          RF[static_cast<size_t>(pos) * VF + v] = xf[v];
        for (int v = l; v < VI; v += kThreads)
          RI[static_cast<size_t>(pos) * VI + v] = xi[v];
        if (l == 0) {
          RG[pos] = g;
          if (lists) list_append(L, pos, g);
        }
        pos = (pos + 1) % W;
        cnt = min(cnt + 1, W);
      }
    }
    if (ok) {                                // add the arriving event
      for (int v = l; v < VF; v += kThreads) {
        const size_t k = static_cast<size_t>(g) * VF + v;
        float hi = s.fhi[k], lo = s.flo[k];
        pair_add(hi, lo, xf[v]);
        s.fhi[k] = hi;
        s.flo[k] = lo;
        if (upd_forever) {
          s.mnf[k] = fmin_ieee(s.mnf[k], xf[v]);
          s.mxf[k] = fmax_ieee(s.mxf[k], xf[v]);
        }
      }
      for (int v = l; v < VI; v += kThreads) {
        const size_t k = static_cast<size_t>(g) * VI + v;
        s.ihi[k] = iadd(s.ihi[k], xi[v] >> 16);
        s.ilo[k] = iadd(s.ilo[k], xi[v] & 65535);
        if (upd_forever) {
          s.mni[k] = min(s.mni[k], xi[v]);
          s.mxi[k] = max(s.mxi[k], xi[v]);
        }
      }
      if (l == 0) s.gc[g] = iadd(s.gc[g], 1);
    }
    __syncwarp();
    for (int v = l; v < VF; v += kThreads) {
      const size_t k = static_cast<size_t>(g) * VF + v;
      a.o_fhi[e * VF + v] = s.fhi[k];
      a.o_flo[e * VF + v] = s.flo[k];
      a.o_amnf[e * VF + v] = s.mnf[k];
      a.o_amxf[e * VF + v] = s.mxf[k];
    }
    for (int v = l; v < VI; v += kThreads) {
      const size_t k = static_cast<size_t>(g) * VI + v;
      a.o_ihi[e * VI + v] = s.ihi[k];
      a.o_ilo[e * VI + v] = s.ilo[k];
      a.o_amni[e * VI + v] = s.mni[k];
      a.o_amxi[e * VI + v] = s.mxi[k];
    }
    if (l == 0) a.o_cnt[e] = s.gc[g];
    if (a.minmax && W > 0 && lists && L.len[g] <= kShort) {
      if (l == 0) {                          // walk group g's live slots
        for (int v = 0; v < VF; ++v) {
          float mn = INFINITY, mx = -INFINITY;
          for (int j = L.head[g]; j >= 0; j = L.nxt[j]) {
            const float x = RF[static_cast<size_t>(j) * VF + v];
            mn = fmin_ieee(mn, x);
            mx = fmax_ieee(mx, x);
          }
          a.o_wmnf[e * VF + v] = mn;
          a.o_wmxf[e * VF + v] = mx;
        }
        for (int v = 0; v < VI; ++v) {
          int mn = kI32Max, mx = kI32Min;
          for (int j = L.head[g]; j >= 0; j = L.nxt[j]) {
            const int x = RI[static_cast<size_t>(j) * VI + v];
            mn = min(mn, x);
            mx = max(mx, x);
          }
          a.o_wmni[e * VI + v] = mn;
          a.o_wmxi[e * VI + v] = mx;
        }
      }
    } else if (a.minmax && W > 0) {
      // masked reductions over the live slots [0, cnt) of group g
      for (int v = 0; v < VF; ++v) {
        float mn = INFINITY, mx = -INFINITY;
        for (int j = l; j < cnt; j += kThreads) {
          if (RG[j] != g) continue;
          const float x = RF[static_cast<size_t>(j) * VF + v];
          mn = fmin_ieee(mn, x);
          mx = fmax_ieee(mx, x);
        }
        mn = warp_fmin(mn);
        mx = warp_fmax(mx);
        if (l == 0) {
          a.o_wmnf[e * VF + v] = mn;
          a.o_wmxf[e * VF + v] = mx;
        }
      }
      for (int v = 0; v < VI; ++v) {
        int mn = kI32Max, mx = kI32Min;
        for (int j = l; j < cnt; j += kThreads) {
          if (RG[j] != g) continue;
          const int x = RI[static_cast<size_t>(j) * VI + v];
          mn = min(mn, x);
          mx = max(mx, x);
        }
        mn = warp_imin(mn);
        mx = warp_imax(mx);
        if (l == 0) {
          a.o_wmni[e * VI + v] = mn;
          a.o_wmxi[e * VI + v] = mx;
        }
      }
    } else {                                 // the forever lanes stand in
      for (int v = l; v < VF; v += kThreads) {
        const size_t k = static_cast<size_t>(g) * VF + v;
        a.o_wmnf[e * VF + v] = s.mnf[k];
        a.o_wmxf[e * VF + v] = s.mxf[k];
      }
      for (int v = l; v < VI; v += kThreads) {
        const size_t k = static_cast<size_t>(g) * VI + v;
        a.o_wmni[e * VI + v] = s.mni[k];
        a.o_wmxi[e * VI + v] = s.mxi[k];
      }
    }
    __syncwarp();                            // next event's writes wait
  }
  if (l == 0) {
    a.pos[p] = pos;
    a.cnt[p] = cnt;
  }
  __syncwarp();
  if (a.lay.groups >= 0) {
    lane_copy(a.fhi + gf, s.fhi, nf);
    lane_copy(a.flo + gf, s.flo, nf);
    lane_copy(a.mnf + gf, s.mnf, nf);
    lane_copy(a.mxf + gf, s.mxf, nf);
    lane_copy(a.ihi + gi, s.ihi, ni);
    lane_copy(a.ilo + gi, s.ilo, ni);
    lane_copy(a.mni + gi, s.mni, ni);
    lane_copy(a.mxi + gi, s.mxi, ni);
    lane_copy(a.gc + gc, s.gc, static_cast<size_t>(G));
  }
  if (a.lay.ring >= 0) {
    lane_copy(a.rf + wf, RF, static_cast<size_t>(W) * VF);
    lane_copy(a.ri + wi, RI, static_cast<size_t>(W) * VI);
    lane_copy(a.rg + wg, RG, static_cast<size_t>(W));
  }
}

// ------------------------------------------------------------------ K7b

struct TimeArgs {
  const float* vf; const int* vi; const int* gid; const int* ts;
  const uint8_t* ok;
  const float* rf0; const int* ri0; const int* rg0; const int* rts0;
  const int* pos0; const int* cnt0; const uint8_t* ovf0; const float* mnf0;
  const float* mxf0; const int* mni0; const int* mxi0;
  float* rf; int* ri; int* rg; int* rts; int* pos; int* cnt; uint8_t* ovf;
  float* mnf; float* mxf; int* mni; int* mxi;
  float* o_fhi; float* o_flo; int* o_ihi; int* o_ilo; int* o_cnt;
  float* o_wmnf; float* o_wmxf; int* o_wmni; int* o_wmxi;
  float* o_amnf; float* o_amxf; int* o_amni; int* o_amxi;
  int P, T, W, G, VF, VI, window_ms, forever;
  Layout lay;
};

__global__ void __launch_bounds__(kThreads)
gagg_time_kernel(const TimeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x, l = threadIdx.x;
  const int T = a.T, W = a.W, G = a.G, VF = a.VF, VI = a.VI;
  const int half = W > 1 ? W / 2 : 1;
  const size_t gf = static_cast<size_t>(p) * G * VF;
  const size_t gi = static_cast<size_t>(p) * G * VI;
  const size_t wf = static_cast<size_t>(p) * W * VF;
  const size_t wi = static_cast<size_t>(p) * W * VI;
  const size_t wg = static_cast<size_t>(p) * W;
  const size_t nf = static_cast<size_t>(G) * VF, ni = static_cast<size_t>(G) * VI;
  float* TH = smem + a.lay.tree;                  // the tree: [half] pairs
  float* TL = TH + half;
  float *mnf, *mxf;
  int *mni, *mxi;
  if (a.lay.groups >= 0) {
    mnf = smem + a.lay.groups;
    mxf = mnf + nf;
    mni = reinterpret_cast<int*>(mxf + nf);
    mxi = mni + ni;
  } else {
    mnf = a.mnf + gf;
    mxf = a.mxf + gf;
    mni = a.mni + gi;
    mxi = a.mxi + gi;
  }
  lane_copy(mnf, a.mnf0 + gf, nf);
  lane_copy(mxf, a.mxf0 + gf, nf);
  lane_copy(mni, a.mni0 + gi, ni);
  lane_copy(mxi, a.mxi0 + gi, ni);
  float* RF;
  int *RI, *RG, *RT;
  if (a.lay.ring >= 0) {
    RF = smem + a.lay.ring;
    RI = reinterpret_cast<int*>(RF + static_cast<size_t>(W) * VF);
    RG = RI + static_cast<size_t>(W) * VI;
    RT = RG + W;
  } else {
    RF = a.rf + wf;
    RI = a.ri + wi;
    RG = a.rg + wg;
    RT = a.rts + wg;
  }
  lane_copy(RF, a.rf0 + wf, static_cast<size_t>(W) * VF);
  lane_copy(RI, a.ri0 + wi, static_cast<size_t>(W) * VI);
  lane_copy(RG, a.rg0 + wg, static_cast<size_t>(W));
  lane_copy(RT, a.rts0 + wg, static_cast<size_t>(W));
  const Tile tl = tile_at(smem, a.lay.tile, VF, VI);
  int pos = a.pos0[p], cnt = a.cnt0[p];
  bool ovf = a.ovf0[p] != 0;
  const float z = 0.0f;
  float* sc = smem + a.lay.scratch;               // sparse_tree's scratch
  int* live = reinterpret_cast<int*>(sc + 8 * kShort);
  const bool lists = a.lay.lists >= 0;
  Lists L{};
  __syncwarp();
  if (lists) {
    L = lists_at(smem, a.lay.lists, W, G);
    lists_build(L, RG, W, G, pos, cnt);
  }

  for (int t = 0; t < T; ++t) {
    const size_t e = static_cast<size_t>(p) * T + t;
    const int k = t % kTile;
    if (k == 0) {
      load_tile(tl, e, min(kTile, T - t), VF, VI, a.vf, a.vi, a.gid, a.ok,
                a.ts);
      __syncwarp();
    }
    const int g = tl.g[k];
    const bool ok = tl.ok[k] != 0;
    const int ts = tl.ts[k];
    const int lo_ts = iadd(ts, -a.window_ms);        // int32, as XLA's
    const float* xf = tl.f + k * VF;
    const int* xi = tl.i + k * VI;
    if (ok && cnt == W && RT[pos] > lo_ts) ovf = true;
    __syncwarp();                            // RT[pos] read before it moves
    if (ok) {
      for (int v = l; v < VF; v += kThreads)
        RF[static_cast<size_t>(pos) * VF + v] = xf[v];
      for (int v = l; v < VI; v += kThreads)
        RI[static_cast<size_t>(pos) * VI + v] = xi[v];
      if (l == 0) {
        if (lists) {
          if (cnt == W) list_remove(L, pos, RG[pos]);
          list_append(L, pos, g);
        }
        RG[pos] = g;
        RT[pos] = ts;
      }
      pos = (pos + 1) % W;
      cnt = min(cnt + 1, W);
      if (a.forever) {
        for (int v = l; v < VF; v += kThreads) {
          const size_t k = static_cast<size_t>(g) * VF + v;
          mnf[k] = fmin_ieee(mnf[k], xf[v]);
          mxf[k] = fmax_ieee(mxf[k], xf[v]);
        }
        for (int v = l; v < VI; v += kThreads) {
          const size_t k = static_cast<size_t>(g) * VI + v;
          mni[k] = min(mni[k], xi[v]);
          mxi[k] = max(mxi[k], xi[v]);
        }
      }
    }
    __syncwarp();
    if (lists && L.len[g] <= kShort) {
      if (l == 0) {                          // walk group g's slots
        int k = 0;
        for (int j = L.head[g]; j >= 0; j = L.nxt[j])
          if (RT[j] > lo_ts) live[k++] = j;
        a.o_cnt[e] = k;
        for (int v = 0; v < VF; ++v) {
          float mn = INFINITY, mx = -INFINITY, hi, lo;
          for (int n = 0; n < k; ++n) {
            const float x = RF[static_cast<size_t>(live[n]) * VF + v];
            mn = fmin_ieee(mn, x);
            mx = fmax_ieee(mx, x);
          }
          sparse_tree(RF, VF, v, live, k, W, sc, hi, lo);
          a.o_fhi[e * VF + v] = hi;
          a.o_flo[e * VF + v] = lo;
          a.o_wmnf[e * VF + v] = mn;
          a.o_wmxf[e * VF + v] = mx;
        }
        for (int v = 0; v < VI; ++v) {
          int sh = 0, sl = 0, mn = kI32Max, mx = kI32Min;
          for (int n = 0; n < k; ++n) {
            const int x = RI[static_cast<size_t>(live[n]) * VI + v];
            sh = iadd(sh, x >> 16);
            sl = iadd(sl, x & 65535);
            mn = min(mn, x);
            mx = max(mx, x);
          }
          a.o_ihi[e * VI + v] = sh;
          a.o_ilo[e * VI + v] = sl;
          a.o_wmni[e * VI + v] = mn;
          a.o_wmxi[e * VI + v] = mx;
        }
      }
    } else {
      // float banks: min/max and the pairwise two-float tree per value lane
      for (int v = 0; v < VF; ++v) {
        float mn = INFINITY, mx = -INFINITY;
        if (W == 1) {
          if (l == 0) {
            const bool lv = 0 < cnt && RT[0] > lo_ts && RG[0] == g;
            TH[0] = lv ? RF[v] : 0.0f;
            TL[0] = 0.0f;
            if (lv) mn = mx = RF[v];
          }
        } else {
          for (int i = l; i < half; i += kThreads) {   // level 1 while reading
            const int j = i + half;
            const bool la = i < cnt && RT[i] > lo_ts && RG[i] == g;
            const bool lb = j < cnt && RT[j] > lo_ts && RG[j] == g;
            const float ah = la ? RF[static_cast<size_t>(i) * VF + v] : 0.0f;
            const float bh = lb ? RF[static_cast<size_t>(j) * VF + v] : 0.0f;
            if (la) { mn = fmin_ieee(mn, ah); mx = fmax_ieee(mx, ah); }
            if (lb) { mn = fmin_ieee(mn, bh); mx = fmax_ieee(mx, bh); }
            float sm, er;
            two_sum(ah, bh, sm, er);
            const float lo2 = (z + z) + er;    // the zero lo lanes of level 0
            const float hi = sm + lo2;
            TH[i] = hi;
            TL[i] = lo2 - (hi - sm);
          }
          __syncwarp();
          for (int w = half; w > 1; w >>= 1) {
            const int h2 = w >> 1;
            for (int i = l; i < h2; i += kThreads) {
              float sm, er;
              two_sum(TH[i], TH[i + h2], sm, er);
              const float lo2 = (TL[i] + TL[i + h2]) + er;
              const float hi = sm + lo2;
              TH[i] = hi;
              TL[i] = lo2 - (hi - sm);
            }
            __syncwarp();
          }
        }
        mn = warp_fmin(mn);
        mx = warp_fmax(mx);
        if (l == 0) {
          a.o_fhi[e * VF + v] = TH[0];
          a.o_flo[e * VF + v] = TL[0];
          a.o_wmnf[e * VF + v] = mn;
          a.o_wmxf[e * VF + v] = mx;
        }
        __syncwarp();                          // TH[0] read before reuse
      }
      // int banks and the count
      int c = 0;
      for (int j = l; j < cnt; j += kThreads)
        c += (RT[j] > lo_ts && RG[j] == g) ? 1 : 0;
      c = warp_iadd(c);
      for (int v = 0; v < VI; ++v) {
        int sh = 0, sl = 0, mn = kI32Max, mx = kI32Min;
        for (int j = l; j < cnt; j += kThreads) {
          if (!(RT[j] > lo_ts && RG[j] == g)) continue;
          const int x = RI[static_cast<size_t>(j) * VI + v];
          sh = iadd(sh, x >> 16);
          sl = iadd(sl, x & 65535);
          mn = min(mn, x);
          mx = max(mx, x);
        }
        sh = warp_iadd(sh);
        sl = warp_iadd(sl);
        mn = warp_imin(mn);
        mx = warp_imax(mx);
        if (l == 0) {
          a.o_ihi[e * VI + v] = sh;
          a.o_ilo[e * VI + v] = sl;
          a.o_wmni[e * VI + v] = mn;
          a.o_wmxi[e * VI + v] = mx;
        }
      }
      if (l == 0) a.o_cnt[e] = c;
    }
    for (int v = l; v < VF; v += kThreads) {
      const size_t k = static_cast<size_t>(g) * VF + v;
      a.o_amnf[e * VF + v] = mnf[k];
      a.o_amxf[e * VF + v] = mxf[k];
    }
    for (int v = l; v < VI; v += kThreads) {
      const size_t k = static_cast<size_t>(g) * VI + v;
      a.o_amni[e * VI + v] = mni[k];
      a.o_amxi[e * VI + v] = mxi[k];
    }
    __syncwarp();
  }
  if (l == 0) {
    a.pos[p] = pos;
    a.cnt[p] = cnt;
    a.ovf[p] = ovf ? 1 : 0;
  }
  __syncwarp();
  if (a.lay.groups >= 0) {
    lane_copy(a.mnf + gf, mnf, nf);
    lane_copy(a.mxf + gf, mxf, nf);
    lane_copy(a.mni + gi, mni, ni);
    lane_copy(a.mxi + gi, mxi, ni);
  }
  if (a.lay.ring >= 0) {
    lane_copy(a.rf + wf, RF, static_cast<size_t>(W) * VF);
    lane_copy(a.ri + wi, RI, static_cast<size_t>(W) * VI);
    lane_copy(a.rg + wg, RG, static_cast<size_t>(W));
    lane_copy(a.rts + wg, RT, static_cast<size_t>(W));
  }
}

template <typename X>
X take(void* const* ptrs, int& k) {
  return static_cast<X>(ptrs[k++]);
}

// Shared memory of one CTA: the event tile and K7b's tree always, then
// the group slabs and the ring where they still fit within kSmemMax.
Layout gagg_plan(int W, int G, int VF, int VI, bool time) {
  Layout lay;
  size_t w = 0;
  lay.tile = 0;
  w += static_cast<size_t>(kTile) * (VF + VI + 3);
  lay.tree = static_cast<int>(w);
  if (time) w += 2 * static_cast<size_t>(W > 1 ? W / 2 : 1);
  lay.scratch = static_cast<int>(w);
  if (time) w += 9 * kShort;
  const size_t groups = time ? static_cast<size_t>(G) * 2 * (VF + VI)
                             : static_cast<size_t>(G) * (4 * (VF + VI) + 1);
  const size_t ring = static_cast<size_t>(W) * (VF + VI + (time ? 2 : 1));
  const size_t lists = static_cast<size_t>(W) + 3 * static_cast<size_t>(G);
  lay.groups = lay.ring = lay.lists = -1;
  if ((w + groups) * 4 <= kSmemMax) {
    lay.groups = static_cast<int>(w);
    w += groups;
  }
  if (W > 0 && (w + ring) * 4 <= kSmemMax) {
    lay.ring = static_cast<int>(w);
    w += ring;
  }
  if (kShort > 0 && W > 0 && (w + lists) * 4 <= kSmemMax) {
    lay.lists = static_cast<int>(w);
    w += lists;
  }
  lay.words = w;
  return lay;
}

cudaError_t launch_with_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

}  // namespace

// K7a.  ptrs: vals_f, vals_i, gids, accepted, the carry in (14 leaves in
// GroupedAggCarry order), the carry out (14; equal to the carry in when in
// place), the 13 output planes.  dims: P, T, W, G, VF, VI, want_minmax,
// want_forever, inplace.  Returns cudaGetLastError() after the launch.
extern "C" int gagg_step(void* const* ptrs, const int* dims, void* stream) {
  LenArgs a;
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
  a.P = dims[0];
  a.T = dims[1];
  a.W = dims[2];
  a.G = dims[3];
  a.VF = dims[4];
  a.VI = dims[5];
  a.minmax = dims[6];
  a.forever = dims[7];
  a.inplace = dims[8];
  if (a.P <= 0 || a.T <= 0) return 0;
  if (a.W < 0 || a.G <= 0 || a.VF < 0 || a.VI < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.lay = gagg_plan(a.W, a.G, a.VF, a.VI, false);
  const size_t smem = a.lay.words * 4;
  cudaError_t err =
      launch_with_smem(reinterpret_cast<const void*>(gagg_step_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gagg_step_kernel<<<a.P, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K7b.  ptrs: vals_f, vals_i, gids, ts, accepted, the carry in (11 leaves in
// GroupedTimeCarry order), the carry out (11, distinct), the 13 output
// planes.  dims: P, T, W (the ring's capacity, a power of two), G, VF, VI,
// window_ms, want_forever.  Returns cudaGetLastError() after the launch.
extern "C" int gagg_time_step(void* const* ptrs, const int* dims,
                              void* stream) {
  TimeArgs a;
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
  a.P = dims[0];
  a.T = dims[1];
  a.W = dims[2];
  a.G = dims[3];
  a.VF = dims[4];
  a.VI = dims[5];
  a.window_ms = dims[6];
  a.forever = dims[7];
  if (a.P <= 0 || a.T <= 0) return 0;
  if (a.W <= 0 || (a.W & (a.W - 1)) || a.G <= 0 || a.VF < 0 || a.VI < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.lay = gagg_plan(a.W, a.G, a.VF, a.VI, true);
  const size_t smem = a.lay.words * 4;
  cudaError_t err =
      launch_with_smem(reinterpret_cast<const void*>(gagg_time_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gagg_time_kernel<<<a.P, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
