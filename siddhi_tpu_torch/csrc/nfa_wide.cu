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

template <int SPT>
int launch_wide(const StepArgs& a, size_t smem, long long grid,
                cudaStream_t s) {
  if (grid <= 0) return 0;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfa_step_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nfa_step_kernel<SPT><<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
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
  const StepPlan p = plan_step(a, false, kSmemLimit);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (a.P + a.L - 1) / a.L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.spt == 1) return launch_wide<1>(a, p.smem, grid, s);
  if (p.spt == 2) return launch_wide<2>(a, p.smem, grid, s);
  if (p.spt == 4) return launch_wide<4>(a, p.smem, grid, s);
  return launch_wide<0>(a, p.smem, grid, s);
}
