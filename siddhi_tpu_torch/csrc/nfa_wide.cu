// The NFA block step's widened template instance for NVIDIA Hopper
// (sm_90a): the programs of ops/nfa.kernel_wide — logical units,
// SEQUENCE, an `every` group, mid-chain and trailing `every`, leading
// min-0 counts and absent units, telemetry, `capture <op> constant`
// compares — with the step body of csrc/nfa_step.cuh (Wide::event).
//
// Replaces siddhi_tpu/ops/nfa.py:579 _one_partition_step for those specs,
// as csrc/nfa_step.cu's nfa_step does for the rest; the contract, the
// scratch rows it writes and the compaction that follows (nfa_step.cu's
// nfa_compact) are nfa_step's.  A source of its own so that its four slot
// instances (1, 2 and 4 slots a thread, the wide ring) build in parallel
// with nfa_step.cu's.
//
// The pattern bank's widened instance (nfa_bank_step_wide) replaces
// siddhi_tpu/ops/nfa.py:1167 build_bank_step and :1266
// build_super_bank_step (the step vmapped over the patterns) for the same
// programs: nfa_step.cu's group instance of the bank step (a group of G
// threads a lane, a CTA a (lane tile, pattern), the pattern's constants
// in shared memory) with this file's unit loop.  Its contract is
// ops/nfa.bank_lanes_plain's: per (pattern, lane) the carry, the match
// count and the last match (ts, lowest matched slot).  What bounds it is
// the bank step's (nfa_step.cu: the carry read and written once, the
// block read once); it is one group of threads per (pattern, lane) on the
// widened loop, so it is bound by instructions, not bytes (chip_smoke.py
// phase 11 times it against bank_step_bound).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "nfa_step.cuh"

namespace {

// The kernel keeps nfa_step.cu's name, so a device trace counts both
// instances as the step.
template <int SPT>
__global__ void __launch_bounds__(kThreads) nfa_step_kernel(StepArgs a) {
  step_body<SPT, false, true, true>(a, static_cast<int>(blockIdx.x));
}

// The bank's widened instance keeps nfa_step.cu's group instance's name,
// so a device trace counts both as the bank step.
template <int SPT>
__global__ void __launch_bounds__(kThreads)
    nfa_bank_step_kernel(StepArgs a) {
  step_body<SPT, true, true, true>(a, static_cast<int>(blockIdx.x));
}

template <int SPT, bool BANK>
int launch_wide(const StepArgs& a, size_t smem, long long grid,
                cudaStream_t s) {
  if (grid <= 0) return 0;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  void (*const kern)(StepArgs) =
      BANK ? nfa_bank_step_kernel<SPT> : nfa_step_kernel<SPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The slot instance and shared memory for a (plan_step: the program, the
// pattern's constants under BANK, the tiles, the slots' captures and the
// CTA's telemetry rows), then the launch over ceil(P / L) lane tiles
// (times CN patterns for the bank).
template <bool BANK>
int run_wide(StepArgs& a, cudaStream_t s) {
  const StepPlan p = plan_step(a, BANK, kSmemLimit);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid =
      static_cast<long long>((a.P + a.L - 1) / a.L) * (BANK ? a.CN : 1);
  if (p.spt == 1) return launch_wide<1, BANK>(a, p.smem, grid, s);
  if (p.spt == 2) return launch_wide<2, BANK>(a, p.smem, grid, s);
  if (p.spt == 4) return launch_wide<4, BANK>(a, p.smem, grid, s);
  return launch_wide<0, BANK>(a, p.smem, grid, s);
}

}  // namespace

// Launch one block step of a widened program (flags & kFlagWide) on
// `stream`: nfa_step's arguments, the same scratch, the same compaction
// after it.  Returns cudaGetLastError() after the launch (0 =
// cudaSuccess), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int nfa_step_wide(const float* attrs, const int* ts,
                             const int* strm, const int* gates,
                             const int* prog, int prog_len, CARRY_PARAMS,
                             int* rows, int* lane_count, int* fill,
                             int* dl_min, const int* lm_in, const int* sf_in,
                             const int* tel_in, int* lm, int* sf, int* tel,
                             int P, int T, int K, int G, int seg, int A,
                             int RC, int flags, int tel_w, void* stream) {
  if (P <= 0) return 0;
  StepArgs a{};
  const int* const win[3] = {lm_in, sf_in, tel_in};
  int* const wout[3] = {lm, sf, tel};
  if (!(flags & kFlagWide) ||
      !make_step_args(a, attrs, ts, strm, gates, prog, prog_len, CARRY_IN,
                      CARRY_OUT, rows, lane_count, fill, dl_min, win, wout,
                      P, T, K, G, seg, A, RC, flags, tel_w))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_wide<false>(a, static_cast<cudaStream_t>(stream));
}

// Launch the pattern bank's step for a widened program (flags &
// kFlagWide; kFlagPadWithin as for nfa_bank_step) over CN patterns on
// `stream`: csrc/nfa_step.cu nfa_bank_step's arguments, then the widened
// leaves in and out (lmask [CN, P, K], seq_froze [CN, P], telem [CN, P,
// tel_w]; null where the spec's carry has none; in and out may be the
// same tensors), flags (ops/nfa.kernel_flags) and tel_w (3S + 1 with
// telemetry, else 0).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int nfa_bank_step_wide(
    const float* attrs, const int* ts, const int* strm, const int* gates,
    const int* prog, int prog_len, const float* params, int n_params,
    CARRY_PARAMS, int* count, int* lmt, int* lmk, int CN, int P, int T,
    int K, int G, int A, int RC, const int* lm_in, const int* sf_in,
    const int* tel_in, int* lm, int* sf, int* tel, int flags, int tel_w,
    void* stream) {
  if (P <= 0 || CN <= 0) return 0;
  StepArgs a{};
  const int* const win[3] = {lm_in, sf_in, tel_in};
  int* const wout[3] = {lm, sf, tel};
  if (!(flags & kFlagWide) ||
      !make_bank_args(a, attrs, ts, strm, gates, prog, prog_len, params,
                      n_params, CARRY_IN, CARRY_OUT, count, lmt, lmk, win,
                      wout, CN, P, T, K, G, A, RC, flags, tel_w))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_wide<true>(a, static_cast<cudaStream_t>(stream));
}
