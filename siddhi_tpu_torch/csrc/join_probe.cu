// Join probe compaction (K11) for NVIDIA Hopper (sm_90a).
//
// Replaces the compaction of siddhi_tpu/core/join.py:367 probe (an XLA
// program: the on-condition's [nl2, nr2] mask AND the valid rows and
// columns, then jnp.nonzero(size=cap, fill_value=-1) and an int32 sum).
// Contract: siddhi_tpu_torch/ops/join_probe.py probe_compact_plain, bit
// for bit: idx[cap] holds the first cap flat row-major indices f = i * nr2
// + j of the cells with mask[f] != 0, i < nl and j < nr, in order, -1
// past the count; count is the exact number of such cells.  The kernel
// moves bits only.
//
// An order-preserving compaction in three launches on one stream, over the
// valid cells only.  The cells are walked in a row-major "virtual" space
// of nl rows of `width` cells: when nr2 is a multiple of kVec, width is nr
// rounded up to kVec, so a thread's kVec cells lie in one row (one 16-byte
// load when the mask is aligned) and the columns j >= width of a row are
// never read; otherwise width is nr2 and the virtual space is the flat
// mask itself.  Rows at or past nl are never read.
//   1. count: a CTA a tile of kTile virtual cells, a thread kVec adjacent
//      cells a sub-tile, the valid bounds applied per cell; the tile's
//      count to scratch;
//   2. scan: one CTA turns the tile counts into exclusive offsets and
//      writes the total to count;
//   3. scatter: a tile whose offset is below cap re-reads its cells; per
//      sub-tile an exclusive scan of the threads' counts in order places
//      each set cell's flat index; the CTAs also fill idx[min(count, cap)
//      .. cap) with -1.
// What bounds it on this card: bytes.  The valid cells (nl rows of nr,
// each row rounded up to kVec) are read once to count and again only for
// the tiles that hold the first cap indices; 4 B an index written.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

}  // extern "C"
