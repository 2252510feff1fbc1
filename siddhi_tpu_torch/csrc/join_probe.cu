// The join probe (K11) for NVIDIA Hopper (sm_90a): the fused probe and
// the mask route's compaction.
//
// Both replace siddhi_tpu/core/join.py:367 probe (an XLA program: the
// on-condition's [nl2, nr2] mask AND the valid rows and columns, then
// jnp.nonzero(size=cap, fill_value=-1) and an int32 sum).  Contract: idx
// [cap] holds the first cap flat row-major indices f = i * nr2 + j of the
// cells with the condition true, i < nl and j < nr, in order, -1 past the
// count; count is the exact number of such cells.
//
// probe_fused (ops/join_probe.py probe_fused_plain, bit for bit): the
// condition as a small program (plan/join_program.py) evaluated cell by
// cell; no mask reaches device memory.  One launch of persistent CTAs
// (as many as are resident) that take work from one atomic counter in
// start order, so a CTA waits only on work already taken by a running
// CTA:
//   1. eval tiles (kEval rows, then kEval columns each): a side's program
//      once a row or column into its slots (scratch);
//   2. probe tiles: TR <= 32 rows by the valid columns (or, for a row
//      wider than kMaxWords match words, one row by a column range), so
//      the tiles in counter order are the cells in row-major order.  A
//      tile waits for the eval tiles it reads, copies its rows' left
//      slots to shared memory, and walks its columns 256 at a time, a
//      thread a column: its right slots (loaded one chunk ahead), then
//      each atom's values down the tile's rows as a 32-bit mask (an atom
//      that reads no left slot is all ones or none; an atom on a left
//      slot compares the rows with the column's operand, the compare
//      a template instance so its loop has no branch), the and/or/not tree
//      on the masks (one bitwise operation a node), and a warp transpose
//      of its 32 columns' masks gives lane r row r's word, written to the
//      tile's words (shared memory);
//   3. the tile's exclusive offset by decoupled look-back over the tiles'
//      counts, a warp reading 32 at a time (radix.cuh warp_lookback),
//      then the words scattered in order as flat indices below cap;
//   4. the last tile writes the count; every CTA, once it finds no work
//      left, waits for the last tile's prefix and fills its share of the
//      -1 tail.
// One launch is faster than a count pass and a scatter pass that would
// each evaluate the condition: a tile's words (4 B for 32 cells) wait in
// shared memory instead.  What bounds it on this card: operations, the
// cells times the atoms' compares (the lanes are (nl + nr) x lanes x 4 B,
// the indices 4 B each).  Masks keep it near that: about two
// instructions a cell an atom on a left slot, the tree and the transpose
// a few a 32 cells.  f32 arithmetic (one side's, in its program)
// rounds as torch's (--fmad=false, IEEE division); compares as torch's:
// != is true with a NaN operand, every other compare false, -0.0 ==
// +0.0.  Arithmetic that reads both sides stays on the mask route: run
// per cell here it was slower than the torch program's planes.
//
// probe_compact (ops/join_probe.py probe_compact_plain, bit for bit): the
// mask route, for a condition outside the program's class: the torch
// program writes the mask, and an order-preserving compaction in three
// launches on one stream reads its valid cells only.  The cells are
// walked in a row-major "virtual" space of nl rows of `width` cells:
// when nr2 is a multiple of kVec, width is nr rounded up to kVec, so a
// thread's kVec cells lie in one row (one 16-byte load when the mask is
// aligned) and the columns j >= width of a row are never read; otherwise
// width is nr2 and the virtual space is the flat mask itself.  Rows at or
// past nl are never read.
//   1. count: a CTA a tile of kTile virtual cells, a thread kVec adjacent
//      cells a sub-tile, the valid bounds applied per cell; the tile's
//      count to scratch;
//   2. scan: one CTA turns the tile counts into exclusive offsets and
//      writes the total to count;
//   3. scatter: a tile whose offset is below cap re-reads its cells; per
//      sub-tile an exclusive scan of the threads' counts in order places
//      each set cell's flat index; the CTAs also fill idx[min(count, cap)
//      .. cap) with -1.
// What bounds it: bytes.  The valid cells are read once to count and
// again only for the tiles that hold the first cap indices; 4 B an index
// written.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "radix.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kB = 256;                  // threads a CTA
constexpr int kWarps = kB / 32;
constexpr int kVec = 16;                 // cells a thread a sub-tile
constexpr int kSub = kB * kVec;          // cells a sub-tile
constexpr int kSubs = 4;                 // sub-tiles a tile
constexpr int kTile = kSub * kSubs;      // cells a CTA
constexpr int kScanThreads = 1024;

struct Probe {
  const unsigned char* mask;
  int nl, nr, nr2, cap;
  int width;             // virtual cells a row (<= nr2)
  int chunked;           // width % kVec == 0: a thread's cells in one row
  int live;              // nl * width virtual cells (< 2^31)
  int ntiles;
  int vec;               // the mask is 16-byte aligned
  int* idx;
  int* count;
  int* tile;             // [ntiles] counts, then exclusive offsets
};

// bit q set when virtual cell v + q is set and valid (v % kVec == 0,
// v < live); *at = the flat index of cell v (bit q's is *at + q)
__device__ __forceinline__ unsigned cells16(const Probe& p, int v, int* at) {
  int i = v / p.width;
  int j = v - i * p.width;
  const int a = i * p.nr2 + j;
  *at = a;
  union {
    uint4 v;
    unsigned char c[kVec];
  } u;
  unsigned bits = 0u;
  if (p.chunked) {                        // j .. j + kVec - 1 < width
    if (p.vec) {
      u.v = *reinterpret_cast<const uint4*>(p.mask + a);
    } else {
#pragma unroll
      for (int q = 0; q < kVec; ++q) u.c[q] = p.mask[a + q];
    }
#pragma unroll
    for (int q = 0; q < kVec; ++q)
      if (u.c[q] != 0 && j + q < p.nr) bits |= 1u << q;
    return bits;
  }
  // width == nr2: a == v, the cells may run past a row's end
  if (p.vec && v + kVec <= p.live) {
    u.v = *reinterpret_cast<const uint4*>(p.mask + a);
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q)
      u.c[q] = v + q < p.live ? p.mask[a + q] : 0;
  }
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    if (j == p.nr2) {
      j = 0;
      ++i;
    }
    if (u.c[q] != 0 && j < p.nr) bits |= 1u << q;
    ++j;
  }
  return bits;
}

__global__ void __launch_bounds__(kB) probe_count(Probe p) {
  __shared__ int ws[kWarps];
  int c = 0;
  for (int s = 0; s < kSubs; ++s) {
    const long long v = static_cast<long long>(blockIdx.x) * kTile +
                        s * kSub + threadIdx.x * kVec;
    int at;
    if (v < p.live) c += __popc(cells16(p, static_cast<int>(v), &at));
  }
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += ws[w];
    p.tile[blockIdx.x] = t;
  }
}

// one CTA: tile counts to exclusive offsets, the total to count
__global__ void __launch_bounds__(kScanThreads) probe_scan(Probe p) {
  const int tot = radix::cta_exclusive_scan<kScanThreads>(p.tile, p.ntiles);
  if (threadIdx.x == 0) *p.count = tot;
}

__global__ void __launch_bounds__(kB) probe_scatter(Probe p) {
  __shared__ int ws[kWarps];
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  const int n = *p.count;
  const int stride = gridDim.x * kB;
  for (int k = (n < p.cap ? n : p.cap) + blockIdx.x * kB + tid; k < p.cap;
       k += stride)
    p.idx[k] = -1;
  int off = p.tile[blockIdx.x];
  if (off >= p.cap) return;               // the same for the whole CTA
  for (int s = 0; s < kSubs; ++s) {
    const long long v = static_cast<long long>(blockIdx.x) * kTile +
                        s * kSub + tid * kVec;
    int at = 0;
    unsigned bits = v < p.live ? cells16(p, static_cast<int>(v), &at) : 0u;
    const int c = __popc(bits);
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, o);
      if (lid >= o) inc += u;
    }
    if (lid == 31) ws[wid] = inc;
    __syncthreads();
    int pre = 0, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < wid) pre += ws[w];
      tot += ws[w];
    }
    int pos = off + pre + inc - c;
    while (bits != 0u && pos < p.cap) {
      const int q = __ffs(static_cast<int>(bits)) - 1;
      p.idx[pos++] = at + q;
      bits &= bits - 1u;
    }
    off += tot;
    __syncthreads();                      // ws is read before its reuse
    if (off >= p.cap) break;
  }
}

// ---------------------------------------------------------------- fused

// the host block (ops/join_probe.py kernel_block) and the program's
// limits (plan/join_program.py)
constexpr int kMaxAtoms = 8;
constexpr int kMaxSlots = 8;
constexpr int kMaxLanes = 16;
constexpr int kMaxConsts = 16;
constexpr int kMaxCode = 128;
constexpr int kStack = 8;
constexpr int kHdr = 16;
constexpr int kCodeAt = kHdr;
constexpr int kConstsAt = kCodeAt + kMaxCode;
constexpr int kAtomsAt = kConstsAt + kMaxConsts;
constexpr int kTreeAt = kAtomsAt + 6 * kMaxAtoms;
constexpr int kMaxTree = 64;

enum Op { OP_LANE = 0, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_I2F,
          OP_CMPF, OP_CMPI, OP_AND, OP_OR, OP_NOT, OP_STORE };
enum Cmp { CMP_LT = 0, CMP_LE, CMP_GT, CMP_GE, CMP_EQ, CMP_NE };
enum Kind { K_LSLOT = 0, K_RSLOT, K_CONST };
enum Tree { T_ATOM = 0, T_TRUE, T_FALSE, T_AND, T_OR, T_NOT };

constexpr int kFB = 256;                 // threads a CTA
constexpr int kFWarps = kFB / 32;
constexpr int kMaxTR = 32;               // rows a tile: a mask's bits
constexpr int kMaxWords = 16384;         // match words a tile (64 KB)
constexpr int kEval = 256;               // rows or columns an eval tile

struct Fused {
  int code[kMaxCode];
  unsigned consts[kMaxConsts];
  int atoms[kMaxAtoms * 6];
  int tree[kMaxTree];
  int tree_len;
  const unsigned* lanes[2 * kMaxLanes];  // left, then right
  int left_len, right_len, natoms, nls, nrs;
  int nl, nr, nr2, cap;
  int tr, cw, ncolt, ntiles;             // probe tile geometry
  int nel, ner;                          // eval tiles: left, right
  int* idx;
  int* count;
  unsigned long long* status;            // [ntiles] look-back words
  int* counter;                          // tiles handed out
  int* done;                             // [nel + ner] eval tiles written
  unsigned* lslots;                      // [nls][nl] left slots
  unsigned* rslots;                      // [nrs][nr] right slots
};

__device__ __forceinline__ float u2f(unsigned u) { return __uint_as_float(u); }
__device__ __forceinline__ unsigned f2u(float f) { return __float_as_uint(f); }

// The compares: != is true with a NaN operand, every other compare
// false; -0.0 == +0.0 (T: float or int).
template <typename T, int C>
__device__ __forceinline__ bool cmp_t(T x, T y) {
  if (C == CMP_LT) return x < y;
  if (C == CMP_LE) return x <= y;
  if (C == CMP_GT) return x > y;
  if (C == CMP_GE) return x >= y;
  if (C == CMP_EQ) return x == y;
  return !(x == y);
}

template <typename T>
__device__ __forceinline__ unsigned compare(int c, T a, T b) {
  switch (c) {
    case CMP_LT: return cmp_t<T, CMP_LT>(a, b);
    case CMP_LE: return cmp_t<T, CMP_LE>(a, b);
    case CMP_GT: return cmp_t<T, CMP_GT>(a, b);
    case CMP_GE: return cmp_t<T, CMP_GE>(a, b);
    case CMP_EQ: return cmp_t<T, CMP_EQ>(a, b);
    default: return cmp_t<T, CMP_NE>(a, b);
  }
}

// A side's postfix program over 32-bit words (plan/join_program.py) for
// its row or column `at`: OP_LANE reads lanes[k][at]; OP_STORE writes
// slot k: out[k * stride].
__device__ __noinline__ void run_code(const int* code, int len,
                                      const unsigned* consts,
                                      const unsigned* const* lanes, int at,
                                      unsigned* out, int stride) {
  unsigned st[kStack];
  int sp = 0;
  for (int k = 0; k < len; ++k) {
    const int w = code[k];
    const int op = w & 0xff, arg = w >> 8;
    switch (op) {
      case OP_LANE: st[sp++] = lanes[arg][at]; break;
      case OP_CONST: st[sp++] = consts[arg]; break;
      case OP_I2F:
        st[sp - 1] = f2u(__int2float_rn(static_cast<int>(st[sp - 1])));
        break;
      case OP_NOT: st[sp - 1] = st[sp - 1] == 0u; break;
      case OP_STORE:
        out[static_cast<size_t>(arg) * stride] = st[--sp];
        break;
      default: {
        const unsigned b = st[--sp], a = st[sp - 1];
        unsigned r;
        switch (op) {
          case OP_ADD: r = f2u(__fadd_rn(u2f(a), u2f(b))); break;
          case OP_SUB: r = f2u(__fsub_rn(u2f(a), u2f(b))); break;
          case OP_MUL: r = f2u(__fmul_rn(u2f(a), u2f(b))); break;
          case OP_DIV: r = f2u(__fdiv_rn(u2f(a), u2f(b))); break;
          case OP_CMPF: r = compare<float>(arg, u2f(a), u2f(b)); break;
          case OP_CMPI:
            r = compare<int>(arg, static_cast<int>(a), static_cast<int>(b));
            break;
          case OP_AND: r = (a != 0u) & (b != 0u); break;
          default: r = (a != 0u) | (b != 0u); break;      // OP_OR
        }
        st[sp - 1] = r;
      }
    }
  }
}

// An atom on a left slot down the tile's rows: bit r is row r's value
// lv[r] <C> y (T: float or int), rows < 32 (32: every row unrolled).
template <typename T, int C>
__device__ __forceinline__ unsigned rows_mask(const unsigned* lv, unsigned y,
                                              int rows) {
  T yv;
  memcpy(&yv, &y, 4);
  const uint4* v4 = reinterpret_cast<const uint4*>(lv);
  unsigned m = 0u;
  if (rows == 32) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4 v = v4[k];
      const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        T xv;
        memcpy(&xv, &x[q], 4);
        if (cmp_t<T, C>(xv, yv)) m |= 1u << (4 * k + q);
      }
    }
    return m;
  }
  for (int k = 0; 4 * k < rows; ++k) {
    const uint4 v = v4[k];
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
    unsigned b = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T xv;
      memcpy(&xv, &x[q], 4);
      if (cmp_t<T, C>(xv, yv)) b |= 1u << q;
    }
    m |= b << (4 * k);
  }
  return m;
}

template <typename T>
__device__ unsigned rows_mask_as(int c, const unsigned* lv, unsigned y,
                                 int rows) {
  switch (c) {
    case CMP_LT: return rows_mask<T, CMP_LT>(lv, y, rows);
    case CMP_LE: return rows_mask<T, CMP_LE>(lv, y, rows);
    case CMP_GT: return rows_mask<T, CMP_GT>(lv, y, rows);
    case CMP_GE: return rows_mask<T, CMP_GE>(lv, y, rows);
    case CMP_EQ: return rows_mask<T, CMP_EQ>(lv, y, rows);
    default: return rows_mask<T, CMP_NE>(lv, y, rows);
  }
}

// A warp's 32 x 32 bit block transposed: lane j's bit r becomes lane r's
// bit j (five butterfly stages of shuffles).
__device__ __forceinline__ unsigned warp_transpose(unsigned x, int lid) {
  const unsigned lo[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                          0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int sft = 16 >> k;
    const unsigned y = __shfl_xor_sync(kFull, x, sft);
    x = (lid & sft) ? (x & ~lo[k]) | ((y & ~lo[k]) >> sft)
                    : (x & lo[k]) | ((y & lo[k]) << sft);
  }
  return x;
}

__global__ void __launch_bounds__(kFB) probe_fused_kernel(const Fused p) {
  extern __shared__ unsigned words[];    // the tile's match words
  __shared__ int s_code[kMaxCode];
  __shared__ unsigned s_consts[kMaxConsts];
  __shared__ int s_atoms[kMaxAtoms * 6];
  __shared__ int4 s_rat[kMaxAtoms];      // atoms on a left slot a row:
                                         // (a | op << 8 | i32 << 16, xa,
                                         // y kind, y argument)
  __shared__ int s_nra;
  __shared__ int s_tree[kMaxTree];
  __shared__ unsigned amask[kMaxAtoms][kFB];  // an atom down the rows
  __shared__ unsigned stk[kStack][kFB];       // the tree's stack
  __shared__ const unsigned* s_lanes[2 * kMaxLanes];
  __shared__ __align__(16) unsigned lval[kMaxSlots][kMaxTR];
  __shared__ unsigned rval[kMaxSlots][kFB];
  __shared__ int s_scan[kFB];
  __shared__ int s_wcnt[kFWarps];
  __shared__ int s_tile, s_excl;
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  for (int k = tid; k < kMaxCode; k += kFB) s_code[k] = p.code[k];
  if (tid < kMaxConsts) s_consts[tid] = p.consts[tid];
  if (tid < kMaxAtoms * 6) s_atoms[tid] = p.atoms[tid];
  if (tid < kMaxTree) s_tree[tid] = p.tree[tid];
  if (tid < 2 * kMaxLanes) s_lanes[tid] = p.lanes[tid];
  const int* rcode = s_code + p.left_len;
  if (tid == 0) {
    int nra = 0;
    for (int a = 0; a < p.natoms; ++a) {
      const int* at = p.atoms + 6 * a;
      if (at[2] == K_LSLOT)
        s_rat[nra++] = make_int4(a | at[0] << 8 | at[1] << 16, at[3], at[4],
                                 at[5]);
    }
    s_nra = nra;
  }
  const int nall = p.nel + p.ner + p.ntiles;
  for (;;) {
    if (tid == 0) s_tile = atomicAdd(p.counter, 1);
    __syncthreads();                     // s_tile; the program; words free
    const int t0 = s_tile;
    if (t0 >= nall) break;
    if (t0 < p.nel + p.ner) {            // an eval tile: one side's slots
      const bool left = t0 < p.nel;
      const int e = left ? t0 : t0 - p.nel;
      const int n = left ? p.nl : p.nr;
      const int end = min((e + 1) * kEval, n);
      for (int i = e * kEval + tid; i < end; i += kFB)
        if (left)
          run_code(s_code, p.left_len, s_consts, s_lanes, i, p.lslots + i,
                   p.nl);
        else
          run_code(rcode, p.right_len, s_consts, s_lanes + kMaxLanes, i,
                   p.rslots + i, p.nr);
      __threadfence();
      __syncthreads();
      if (tid == 0) *reinterpret_cast<volatile int*>(p.done + t0) = 1;
      continue;
    }
    const int t = t0 - p.nel - p.ner;    // a probe tile
    const int rt = t / p.ncolt, ct = t - rt * p.ncolt;
    const int r0 = rt * p.tr;
    const int rows = min(p.tr, p.nl - r0);
    const int c0 = ct * p.cw;
    const int c1 = min(c0 + p.cw, p.nr);
    const int tw = (c1 - c0 + 31) >> 5;  // words a tile row
    if (tid == 0) {                      // the eval tiles it reads
      const volatile int* dn = p.done;
      for (int e = r0 / kEval; e <= (r0 + rows - 1) / kEval; ++e)
        while (dn[e] == 0) __nanosleep(100);
      for (int e = c0 / kEval; e <= (c1 - 1) / kEval; ++e)
        while (dn[p.nel + e] == 0) __nanosleep(100);
      __threadfence();
    }
    __syncthreads();
    if (tid < rows)
      for (int s = 0; s < p.nls; ++s)
        lval[s][tid] = __ldcg(p.lslots + static_cast<size_t>(s) * p.nl +
                              r0 + tid);
    __syncthreads();
    int cnt = 0;                         // lane r: row r's matches
    // this thread's column's right slots, one chunk ahead
    unsigned nxt[kMaxSlots];
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      nxt[s] = s < p.nrs && c0 + tid < c1
                   ? __ldcg(p.rslots + static_cast<size_t>(s) * p.nr + c0 +
                            tid)
                   : 0u;
    for (int cb = c0; cb < c1; cb += kFB) {
      const int col = cb + tid;
      const bool cv = col < c1;
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
        if (s < p.nrs) rval[s][tid] = nxt[s];   // this thread's own column
        nxt[s] = s < p.nrs && col + kFB < c1
                     ? __ldcg(p.rslots + static_cast<size_t>(s) * p.nr + col +
                              kFB)
                     : 0u;
      }
      const int wcol = ((cb - c0) >> 5) + wid;
      // each atom's values down the tile's rows: bit r for row r.  Atoms
      // that read no left slot hold for every row of the column
      for (int a = 0; a < p.natoms; ++a) {
        const int* at = s_atoms + 6 * a;
        if (at[2] == K_LSLOT) continue;
        const unsigned x = at[2] == K_RSLOT ? rval[at[3]][tid] : s_consts[at[3]];
        const unsigned y = at[4] == K_RSLOT ? rval[at[5]][tid] : s_consts[at[5]];
        const unsigned v =
            at[1] ? compare<int>(at[0], static_cast<int>(x),
                                 static_cast<int>(y))
                  : compare<float>(at[0], u2f(x), u2f(y));
        amask[a][tid] = v ? kFull : 0u;
      }
      for (int k = 0; k < s_nra; ++k) {  // a left slot a row
        const int4 f = s_rat[k];
        const int c = (f.x >> 8) & 0xff;
        const unsigned y = f.z == K_RSLOT ? rval[f.w][tid] : s_consts[f.w];
        amask[f.x & 0xff][tid] =
            f.x >> 16 ? rows_mask_as<int>(c, lval[f.y], y, rows)
                      : rows_mask_as<float>(c, lval[f.y], y, rows);
      }
      // the and/or/not tree on the masks, one bitwise operation a node
      int sp = 0;
      for (int k = 0; k < p.tree_len; ++k) {
        const int w = s_tree[k];
        switch (w & 0xff) {
          case T_ATOM: stk[sp++][tid] = amask[w >> 8][tid]; break;
          case T_TRUE: stk[sp++][tid] = kFull; break;
          case T_FALSE: stk[sp++][tid] = 0u; break;
          case T_NOT: stk[sp - 1][tid] = ~stk[sp - 1][tid]; break;
          case T_AND:
            --sp;
            stk[sp - 1][tid] &= stk[sp][tid];
            break;
          default:                       // T_OR
            --sp;
            stk[sp - 1][tid] |= stk[sp][tid];
        }
      }
      // lane r of the warp gets row r's word of its 32 columns
      const unsigned wd = warp_transpose(cv ? stk[0][tid] : 0u, lid);
      if (lid < rows && wcol < tw) {
        words[lid * tw + wcol] = wd;
        cnt += __popc(wd);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (lid == 0) s_wcnt[wid] = cnt;
    __syncthreads();
    if (wid == 0) {                      // the tile's offset: warp 0
      int agg = 0;
      for (int w = 0; w < kFWarps; ++w) agg += s_wcnt[w];
      const unsigned long long excl =
          radix::warp_lookback<unsigned long long>(
              p.status, t, static_cast<unsigned long long>(agg));
      if (lid == 0) {
        s_excl = static_cast<int>(excl);
        if (t == p.ntiles - 1) *p.count = static_cast<int>(excl) + agg;
      }
    }
    __syncthreads();
    const int excl = s_excl;
    if (excl < p.cap) {                  // the same for the whole CTA
      const int nw = rows * tw;
      const int per = (nw + kFB - 1) / kFB;
      const int k0 = min(tid * per, nw), k1 = min(k0 + per, nw);
      int c = 0;
      for (int k = k0; k < k1; ++k) c += __popc(words[k]);
      s_scan[tid] = c;
      radix::cta_exclusive_scan<kFB>(s_scan, kFB);
      int pos = excl + s_scan[tid];
      for (int k = k0; k < k1 && pos < p.cap; ++k) {
        unsigned w = words[k];
        if (w == 0u) continue;
        const int r = k / tw, wc = k - r * tw;
        const int base = (r0 + r) * p.nr2 + c0 + 32 * wc;
        while (w != 0u && pos < p.cap) {
          p.idx[pos++] = base + __ffs(static_cast<int>(w)) - 1;
          w &= w - 1u;
        }
      }
    }
  }
  // no tile left: the count is known once the last tile's prefix is
  __shared__ int s_total;
  if (tid == 0)
    s_total = static_cast<int>(radix::wait_prefix<unsigned long long>(
        p.status + (p.ntiles - 1)));
  __syncthreads();
  const int stride = gridDim.x * kFB;
  for (int k = min(s_total, p.cap) + blockIdx.x * kFB + tid; k < p.cap;
       k += stride)
    p.idx[k] = -1;
}

struct FusedGeometry {
  int tr, cw, ncolt, ntiles, smem;
  int nel, ner;                          // eval tiles a side
};

FusedGeometry fused_geometry(int nl, int nr) {
  FusedGeometry g{0, 0, 0, 0, 0, 0, 0};
  if (nl <= 0 || nr <= 0) return g;
  const int wpr = (nr + 31) / 32;
  if (wpr <= kMaxWords) {
    g.tr = min(kMaxTR, kMaxWords / wpr);
    g.cw = nr;
    g.ncolt = 1;
  } else {
    g.tr = 1;
    g.cw = kMaxWords * 32;
    g.ncolt = (nr + g.cw - 1) / g.cw;
  }
  g.ntiles = (nl + g.tr - 1) / g.tr * g.ncolt;
  g.smem = static_cast<int>(sizeof(unsigned)) * g.tr *
           ((min(g.cw, nr) + 31) / 32);
  g.nel = (nl + kEval - 1) / kEval;
  g.ner = (nr + kEval - 1) / kEval;
  return g;
}

// the scratch's byte offsets: look-back words, the tile counter and the
// eval flags (zeroed before a launch), then the slots (written by the
// eval tiles before any probe tile reads them)
struct FusedScratch {
  size_t counter, done, lslots, rslots, bytes;
};

FusedScratch fused_scratch(const FusedGeometry& g, int nls, int nrs, int nl,
                           int nr) {
  FusedScratch s;
  s.counter = sizeof(unsigned long long) * g.ntiles;
  s.done = s.counter + sizeof(int);
  s.lslots = (s.done + sizeof(int) * (g.nel + g.ner) + 15) / 16 * 16;
  s.rslots = s.lslots + sizeof(unsigned) * static_cast<size_t>(nls) * nl;
  s.bytes = s.rslots + sizeof(unsigned) * static_cast<size_t>(nrs) * nr;
  return s;
}

int tiles_of(int nl2, int nr2) {
  const long long total = static_cast<long long>(nl2) * nr2;
  return static_cast<int>((total + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

// bytes of device scratch a compaction of an [nl2, nr2] mask needs (at
// most: the tiles cover the valid cells only)
long long probe_scratch_bytes(int nl2, int nr2) {
  return static_cast<long long>(sizeof(int)) * tiles_of(nl2, nr2);
}

// mask [nl2 * nr2] bytes, idx [cap] i32, count [1] i32.  0 or a CUDA
// error code.
int probe_compact(const void* mask, int nl, int nr, int nl2, int nr2,
                  int cap, int* idx, int* count, void* scratch,
                  long long scratch_bytes, void* stream) {
  const long long total = static_cast<long long>(nl2) * nr2;
  if (nl2 < 0 || nr2 < 0 || total > 0x7fffffffLL || cap < 0 || nl < 0 ||
      nr < 0 || nl > nl2 || nr > nr2)
    return cudaErrorInvalidValue;
  const int chunked = nr2 % kVec == 0;
  const int width = chunked ? (nr + kVec - 1) / kVec * kVec : nr2;
  const long long live = nl == 0 || nr == 0
                             ? 0
                             : static_cast<long long>(nl) * width;
  const int ntiles = static_cast<int>((live + kTile - 1) / kTile);
  if (scratch_bytes < static_cast<long long>(sizeof(int)) * ntiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles == 0) {
    cudaMemsetAsync(count, 0, sizeof(int), st);
    if (cap > 0) cudaMemsetAsync(idx, 0xff, sizeof(int) * cap, st);
    return static_cast<int>(cudaGetLastError());
  }
  Probe p;
  p.mask = static_cast<const unsigned char*>(mask);
  p.nl = nl;
  p.nr = nr;
  p.nr2 = nr2;
  p.cap = cap;
  p.width = width;
  p.chunked = chunked;
  p.live = static_cast<int>(live);
  p.ntiles = ntiles;
  p.vec = (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
  p.idx = idx;
  p.count = count;
  p.tile = static_cast<int*>(scratch);
  probe_count<<<ntiles, kB, 0, st>>>(p);
  probe_scan<<<1, kScanThreads, 0, st>>>(p);
  probe_scatter<<<ntiles, kB, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bytes of device scratch a fused probe needs (blk: the host block)
long long probe_fused_scratch_bytes(const int* blk) {
  return static_cast<long long>(
      fused_scratch(fused_geometry(blk[9], blk[10]), blk[5], blk[6], blk[9],
                    blk[10]).bytes);
}

// blk: ops/join_probe.py kernel_block (left_len, right_len, code_len,
// n_consts, n_atoms, n_lslots, n_rslots, n_llanes, n_rlanes, nl, nr, nl2,
// nr2, cap, tree_len; code; constants; atoms; tree), lanes: 16 left then
// 16 right
// device pointers, idx [cap] i32, count [1] i32.  0 or a CUDA error code.
int probe_fused(const int* blk, const void* const* lanes, int* idx,
                int* count, void* scratch, long long scratch_bytes,
                void* stream) {
  const int left_len = blk[0], right_len = blk[1], code_len = blk[2];
  const int nconsts = blk[3], natoms = blk[4], nls = blk[5], nrs = blk[6];
  const int nll = blk[7], nrl = blk[8];
  const int nl = blk[9], nr = blk[10], nl2 = blk[11], nr2 = blk[12];
  const int cap = blk[13], tree_len = blk[14];
  if (tree_len < 1 || tree_len > kMaxTree || left_len < 0 || right_len < 0 || left_len + right_len > code_len ||
      code_len > kMaxCode || nconsts < 0 || nconsts > kMaxConsts ||
      natoms < 0 || natoms > kMaxAtoms || nls < 0 || nls > kMaxSlots ||
      nrs < 0 || nrs > kMaxSlots || nll < 0 || nll > kMaxLanes ||
      nrl < 0 || nrl > kMaxLanes || nl < 0 || nr < 0 || nl > nl2 ||
      nr > nr2 || cap < 0 ||
      static_cast<long long>(nl2) * nr2 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FusedGeometry g = fused_geometry(nl, nr);
  if (g.ntiles == 0) {
    cudaMemsetAsync(count, 0, sizeof(int), st);
    if (cap > 0) cudaMemsetAsync(idx, 0xff, sizeof(int) * cap, st);
    return static_cast<int>(cudaGetLastError());
  }
  const FusedScratch sc = fused_scratch(g, nls, nrs, nl, nr);
  if (scratch_bytes < static_cast<long long>(sc.bytes))
    return cudaErrorInvalidValue;
  Fused p;
  memcpy(p.code, blk + kCodeAt, sizeof(p.code));
  memcpy(p.consts, blk + kConstsAt, sizeof(p.consts));
  memcpy(p.atoms, blk + kAtomsAt, sizeof(p.atoms));
  memcpy(p.tree, blk + kTreeAt, sizeof(p.tree));
  p.tree_len = blk[14];
  for (int k = 0; k < 2 * kMaxLanes; ++k)
    p.lanes[k] = static_cast<const unsigned*>(lanes[k]);
  p.left_len = left_len;
  p.right_len = right_len;
  p.natoms = natoms;
  p.nls = nls;
  p.nrs = nrs;
  p.nl = nl;
  p.nr = nr;
  p.nr2 = nr2;
  p.cap = cap;
  p.tr = g.tr;
  p.cw = g.cw;
  p.ncolt = g.ncolt;
  p.ntiles = g.ntiles;
  p.idx = idx;
  p.count = count;
  p.nel = g.nel;
  p.ner = g.ner;
  char* base = static_cast<char*>(scratch);
  p.status = reinterpret_cast<unsigned long long*>(base);
  p.counter = reinterpret_cast<int*>(base + sc.counter);
  p.done = reinterpret_cast<int*>(base + sc.done);
  p.lslots = reinterpret_cast<unsigned*>(base + sc.lslots);
  p.rslots = reinterpret_cast<unsigned*>(base + sc.rslots);
  cudaError_t e = cudaFuncSetAttribute(
      probe_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_fused_kernel, kFB, g.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = max(1, min(g.nel + g.ner + g.ntiles, sms * max(per_sm, 1)));
  cudaMemsetAsync(scratch, 0, sc.lslots, st);  // look-back, counter, flags
  probe_fused_kernel<<<grid, kFB, g.smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
