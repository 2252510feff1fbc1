// The cross-tenant gang step for NVIDIA Hopper (sm_90a): every pending
// tenant of a bucket stepped, and its matches compacted, in one step
// launch per template instance present and one compaction launch.
//
// Replaces siddhi_tpu/plan/xtenant.py:95 _build_gang (each pending
// tenant's own build_block_step and egress pack, unrolled into one XLA
// executable).  Contract (siddhi_tpu_torch/ops/nfa.py,
// nfa_gang_step_egress_plain): for each tenant, in list order, the
// result nfa_step_egress gives it alone: its new carry (its input carry
// only read) and its [cap + 2, W] egress buffer (slab, tail, status),
// here at its offset in one bucket buffer.  Tenants share K (so one slot
// geometry) and W = 4 + R*C; their programs, attribute counts, T, caps
// and scratch segments differ.
//
// What bounds it on this card: what the tenants' steps and compactions
// move, summed: each tenant's block read once, its carry read once and
// written once, its slab written once (nfa_step.cu's notes; ~35 MB for
// 32 tenants of 1,024 lanes at T ~ 30, ~0.011 ms at 3.35 TB/s).  The
// tenants' descriptors add n * ~400 bytes.
//
// The design.
//  - The host packs one descriptor row a tenant (ops/nfa.GANG_FIELDS);
//    nfa_gang_step turns them into the tenants' StepArgs and PackArgs
//    and their CTA prefix (ceil(P / L) CTAs a tenant) and copies that
//    table to the card in ONE copy.
//  - Tenants are grouped by template instance (slots a thread, and
//    whether count or absent words ride the carry, or the program is a
//    widened one); one launch a group present.  A CTA bisects the prefix for its tenant, copies that
//    tenant's StepArgs into shared memory and runs nfa_step.cu's step
//    body on its lanes; a tenant's scratch rows, lane counts and fills
//    are its own.
//  - One compaction launch: each CTA bisects the same prefix and runs
//    the compaction body for one step CTA of its tenant, into that
//    tenant's rows of the bucket buffer.  A tenant whose segment or cap
//    overflowed is re-run alone by the caller (nfa_step / nfa_compact
//    from its own scratch), so co-tenants' results stand.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#include <cuda_runtime.h>

#include "nfa_step.cuh"

namespace {


// Tenant i of a gang owns CTAs [cta0[i], cta0[i + 1]) of its launch; the
// CTA's tenant is the last i in [lo, hi) with cta0[i] <= b (a bisection
// over the prefix), its CTA within the tenant b - cta0[i].
__device__ __forceinline__ int gang_tenant(const int* cta0, int lo, int hi,
                                           int b) {
  while (hi - lo > 1) {
    const int m = (lo + hi) >> 1;
    if (cta0[m] <= b)
      lo = m;
    else
      hi = m;
  }
  return lo;
}

// The CTA's tenant's arguments from the device table into shared memory
// (a word a thread); returns the CTA's index within its tenant.
template <class Args>
__device__ __forceinline__ int gang_load(const Args* tab, const int* cta0,
                                         int lo, int hi, Args* mine) {
  __shared__ int s_i, s_c;
  if (threadIdx.x == 0) {
    const int b = cta0[lo] + static_cast<int>(blockIdx.x);
    const int i = gang_tenant(cta0, lo, hi, b);
    s_i = i;
    s_c = b - cta0[i];
  }
  __syncthreads();
  const int* src = reinterpret_cast<const int*>(tab + s_i);
  int* dst = reinterpret_cast<int*>(mine);
  for (int w = threadIdx.x; w < static_cast<int>(sizeof(Args) / 4);
       w += kThreads)
    dst[w] = src[w];
  __syncthreads();
  return s_c;
}

// One launch steps tenants [lo, hi) of the table, all of one template
// instance: each CTA runs the step body on its tenant's block, carry and
// program, as nfa_step_kernel does for one block.
template <int SPT, bool EXT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    nfa_gang_step_kernel(const StepArgs* tab, const int* cta0, int lo,
                         int hi) {
  __shared__ StepArgs a;
  const int c = gang_load(tab, cta0, lo, hi, &a);
  step_body<SPT, false, EXT, WIDE>(a, c);
}

// One launch compacts every tenant of the table: each CTA is the
// compaction of one step CTA of its tenant, into that tenant's place in
// the bucket buffer.
__global__ void __launch_bounds__(kThreads)
    nfa_gang_compact_kernel(const PackArgs* tab, const int* cta0, int n) {
  __shared__ PackArgs a;
  const int c = gang_load(tab, cta0, 0, n, &a);
  compact_body(a, c);
}

// The gang's device table for n tenants: StepArgs x n, PackArgs x n, the
// CTA prefix (n + 1 ints), in bytes.
struct GangLayout {
  size_t pack, cta0, end;
};

GangLayout gang_layout(int n) {
  GangLayout g;
  g.pack = sizeof(StepArgs) * static_cast<size_t>(n);
  g.cta0 = g.pack + sizeof(PackArgs) * static_cast<size_t>(n);
  g.end = (g.cta0 + 4ull * (n + 1) + 15) & ~static_cast<size_t>(15);
  return g;
}

// the gang kernel's static shared memory beside the step body's (its
// tenant's StepArgs and the tenant search)
constexpr size_t kGangStatic = sizeof(StepArgs) + 64;

template <int SPT, bool EXT, bool WIDE>
int launch_gang(const StepArgs* tab, const int* cta0, int lo, int hi,
                long long grid, size_t smem, cudaStream_t s) {
  if (grid <= 0) return 0;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  void (*const kern)(const StepArgs*, const int*, int, int) =
      nfa_gang_step_kernel<SPT, EXT, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(tab, cta0, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXT>
int launch_gang_as(int spt, const StepArgs* tab, const int* cta0, int lo,
                   int hi, long long grid, size_t smem, cudaStream_t s) {
  if (spt == 1)
    return launch_gang<1, EXT, false>(tab, cta0, lo, hi, grid, smem, s);
  if (spt == 2)
    return launch_gang<2, EXT, false>(tab, cta0, lo, hi, grid, smem, s);
  if (spt == 4)
    return launch_gang<4, EXT, false>(tab, cta0, lo, hi, grid, smem, s);
  return launch_gang<0, EXT, false>(tab, cta0, lo, hi, grid, smem, s);
}

// the widened instance in the gang: one slot a thread, or the wide ring
// (a tenant of 33 to 128 slots runs it too: two instances fewer to build)
int launch_gang_wide(int spt, const StepArgs* tab, const int* cta0, int lo,
                     int hi, long long grid, size_t smem, cudaStream_t s) {
  if (spt == 1)
    return launch_gang<1, true, true>(tab, cta0, lo, hi, grid, smem, s);
  return launch_gang<0, true, true>(tab, cta0, lo, hi, grid, smem, s);
}

}  // namespace


namespace {
// int64 words a tenant in nfa_gang_step's host descriptor
// (ops/nfa.GANG_FIELDS): attrs, ts, stream, gates, prog, prog_len, carry
// in (11), carry out (11), rows, lane_count, fill, dl_min, P, T, K, G,
// seg, A, RC, slab, cap, W, widened carry in (3: lmask, seq_froze,
// telem), widened carry out (3), flags, tel_w
constexpr int kGangFields = 50;

template <class T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}
}  // namespace

// Bytes of the device table nfa_gang_step fills for n tenants.
extern "C" long long nfa_gang_table_bytes(int n) {
  return n > 0 ? static_cast<long long>(gang_layout(n).end) : 0;
}

// Step n tenants' blocks on `stream` (siddhi_tpu/plan/xtenant.py:76
// _build_gang: each pending tenant's own block step and egress pack in
// one executable).  desc is a host [n, kGangFields] int64 descriptor, one
// row a tenant as nfa_step's arguments plus its place in the bucket
// buffer (slab: a [cap + 2, W] run of rows).  The tenants' StepArgs and
// PackArgs and their CTA prefix go to `table` (table_bytes >=
// nfa_gang_table_bytes(n), on the card) in ONE copy; then one launch per
// template instance present (slots a thread x simple, count-or-absent
// or widened),
// the tenants sorted by instance, list order kept within one.  Writes
// the step launches made to out[0] and the tenants' CTAs in all (the
// compaction's grid) to out[1] (host ints).  nfa_gang_compact then
// compacts every tenant from the same table.  Returns cudaGetLastError() after
// the last launch (0 = cudaSuccess), or cudaErrorInvalidValue for a
// descriptor the kernel does not take.
extern "C" int nfa_gang_step(const long long* desc, int n, void* table,
                             long long table_bytes, int* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out) out[0] = out[1] = 0;
  if (n <= 0) return 0;
  const GangLayout lay = gang_layout(n);
  if (!desc || !table || !out ||
      table_bytes < static_cast<long long>(lay.end))
    return static_cast<int>(cudaErrorInvalidValue);
  std::vector<StepArgs> args(n);
  std::vector<PackArgs> packs(n);
  std::vector<int> key(n);
  std::vector<size_t> smem(n);
  const size_t limit = kSmemLimit - kGangStatic;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + static_cast<long long>(i) * kGangFields;
    const CarryPtrs in{ptr<const int>(d[6]),   ptr<const int>(d[7]),
                       ptr<const int>(d[8]),   ptr<const int>(d[9]),
                       ptr<const int>(d[10]),  ptr<const float>(d[11]),
                       ptr<const int>(d[12]),  ptr<const int>(d[13]),
                       ptr<const int>(d[14]),  ptr<const int>(d[15]),
                       ptr<const int>(d[16])};
    const CarryOut out{ptr<int>(d[17]), ptr<int>(d[18]), ptr<int>(d[19]),
                       ptr<int>(d[20]), ptr<int>(d[21]), ptr<float>(d[22]),
                       ptr<int>(d[23]), ptr<int>(d[24]), ptr<int>(d[25]),
                       ptr<int>(d[26]), ptr<int>(d[27])};
    int* dl_min = ptr<int>(d[31]);
    const long long P = d[32], T = d[33], K = d[34], G = d[35], seg = d[36];
    const long long A = d[37], RC = d[38], cap = d[40], W = d[41];
    const long long prog_len = d[5];
    const int* const win[3] = {ptr<const int>(d[42]), ptr<const int>(d[43]),
                               ptr<const int>(d[44])};
    int* const wout[3] = {ptr<int>(d[45]), ptr<int>(d[46]), ptr<int>(d[47])};
    const long long flags = d[48], tel_w = d[49];
    if (P <= 0 || P > INT_MAX || T > INT_MAX || K > INT_MAX ||
        prog_len > INT_MAX || seg > INT_MAX || A > INT_MAX ||
        RC > INT_MAX || cap < 0 || cap > INT_MAX || W != 4 + RC ||
        bad_geometry(static_cast<int>(K), static_cast<int>(T),
                     static_cast<int>(G), static_cast<int>(A),
                     static_cast<int>(RC), static_cast<int>(prog_len)) ||
        seg < 0 || missing_leaves(in, out) ||
        ((in.dl != nullptr) != (dl_min != nullptr)) || !d[39] ||
        tel_w > INT_MAX || flags < 0 || flags > INT_MAX ||
        bad_wide(win[0], win[1], win[2], wout[0], wout[1], wout[2],
                 static_cast<int>(flags), static_cast<int>(tel_w)))
      return static_cast<int>(cudaErrorInvalidValue);
    StepArgs& a = args[i];
    a = StepArgs{};
    a.attrs = ptr<const float>(d[0]);
    a.ts = ptr<const int>(d[1]);
    a.strm = ptr<const int>(d[2]);
    a.gates = ptr<const int>(d[3]);
    a.prog = ptr<const int>(d[4]);
    set_carry(a, in, out);
    a.rows = ptr<int>(d[28]);
    a.lane_count = ptr<int>(d[29]);
    a.fill = ptr<int>(d[30]);
    a.dl_min = dl_min;
    a.prog_len = static_cast<int>(prog_len);
    a.P = static_cast<int>(P);
    a.T = static_cast<int>(T);
    a.K = static_cast<int>(K);
    a.G = static_cast<int>(G);
    a.seg = static_cast<int>(seg);
    a.A = static_cast<int>(A);
    a.RC = static_cast<int>(RC);
    a.CN = 1;
    a.n_params = 0;
    set_wide(a, win, wout, static_cast<int>(flags),
             static_cast<int>(tel_w));
    const StepPlan p = plan_step(a, false, limit, a.wide ? 1 : 4);
    if (p.smem > limit) return static_cast<int>(cudaErrorInvalidValue);
    // 0: simple units, 1: count or absent words, 2: widened
    key[i] = p.spt * 3 + (a.wide ? 2 : ((in.cc || in.dl) ? 1 : 0));
    smem[i] = p.smem;
    const int n_cta = (a.P + a.L - 1) / a.L;
    packs[i] = PackArgs{a.rows, a.lane_count, a.fill, out.dropped, dl_min,
                        ptr<int>(d[39]), a.P, a.L, a.seg, n_cta,
                        static_cast<int>(cap), static_cast<int>(W)};
  }
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int x, int y) { return key[x] < key[y]; });
  std::vector<unsigned char> host(lay.end, 0);
  StepArgs* h_args = reinterpret_cast<StepArgs*>(host.data());
  PackArgs* h_packs = reinterpret_cast<PackArgs*>(host.data() + lay.pack);
  int* h_cta0 = reinterpret_cast<int*>(host.data() + lay.cta0);
  long long total = 0;
  for (int j = 0; j < n; ++j) {
    const int i = order[j];
    std::memcpy(&h_args[j], &args[i], sizeof(StepArgs));
    std::memcpy(&h_packs[j], &packs[i], sizeof(PackArgs));
    h_cta0[j] = static_cast<int>(total);
    total += packs[i].n_cta;
    if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  h_cta0[n] = static_cast<int>(total);
  out[1] = static_cast<int>(total);
  // pageable source: staged before the call returns, so `host` may go
  cudaError_t e = cudaMemcpyAsync(table, host.data(), lay.end,
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const StepArgs* d_args = static_cast<const StepArgs*>(table);
  const int* d_cta0 = reinterpret_cast<const int*>(
      static_cast<const unsigned char*>(table) + lay.cta0);
  for (int lo = 0; lo < n;) {
    int hi = lo;
    size_t sm = 0;
    while (hi < n && key[order[hi]] == key[order[lo]]) {
      sm = std::max(sm, smem[order[hi]]);
      ++hi;
    }
    const int k = key[order[lo]], spt = k / 3, mode = k % 3;
    const long long grid = h_cta0[hi] - h_cta0[lo];
    const int rc =
        mode == 2 ? launch_gang_wide(spt, d_args, d_cta0, lo, hi, grid, sm, s)
        : mode == 1 ? launch_gang_as<true>(spt, d_args, d_cta0, lo, hi, grid,
                                           sm, s)
                    : launch_gang_as<false>(spt, d_args, d_cta0, lo, hi, grid,
                                            sm, s);
    if (rc != 0) return rc;
    ++out[0];
    lo = hi;
  }
  return 0;
}

// Compact every tenant of the table nfa_gang_step wrote (n tenants,
// total_cta their CTAs in all, as nfa_gang_step reported; on the card,
// stream-ordered after it) in one launch: each tenant's slab, tail and
// status rows at its place in the bucket buffer.  Returns
// cudaGetLastError() after the launch.
extern "C" int nfa_gang_compact(const void* table, int n, int total_cta,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || total_cta <= 0) return 0;
  if (!table) return static_cast<int>(cudaErrorInvalidValue);
  const GangLayout lay = gang_layout(n);
  const unsigned char* t = static_cast<const unsigned char*>(table);
  nfa_gang_compact_kernel<<<total_cta, kThreads, 0, s>>>(
      reinterpret_cast<const PackArgs*>(t + lay.pack),
      reinterpret_cast<const int*>(t + lay.cta0), n);
  return static_cast<int>(cudaGetLastError());
}
