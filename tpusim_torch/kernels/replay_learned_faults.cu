// The fault forms of the learned instantiations of `replay`
// (replay_learned.cu): the kFaults, kLearned instantiations of replay_body
// and its lanes form, which replay_faults.cu dispatches to for a
// configuration with a learned column (the in-scan fault lane and the chaos
// sweep of a learned family); replay_blocked_learned_faults.cu holds
// replay_blocked's. Compiled apart, in parallel with the others; the clocked
// variant builds none of them (its launchers refuse). Only the staged forms
// are built.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_FAULTS_TU
#include "replay_lanes.cu"

#ifndef TPUSIM_PHASE_CLOCKS
namespace {

__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_lanes_learned_faults_kernel(const ReplayArgs* __restrict__ lanes) {
  __shared__ __align__(16) ReplayArgs lane_args;
  load_lane(lanes, &lane_args);
  replay_body<true, false, true, true, false, false, true>(lane_args);
}

// a learned fault form's operands: a staged shape, the learned fields and
// the fault fields
bool learned_fault_operands(const ReplayArgs* a) {
  return a->scratch == nullptr && staged_shape(a) && a->ln_n >= 0 &&
         a->ln_n <= kMaxFamily && a->fam_n >= 0 && a->fam_n <= kMaxFamily &&
         !randomized(a) && fault_operands(a);
}

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

int replay_learned_faults(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)a;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (!learned_fault_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_replay(
      replay_kernel<true, false, true, true, false, false, true>, a, true,
      false, static_cast<cudaStream_t>(stream));
#endif
}

int replay_lanes_learned_faults(const ReplayArgs* lanes, int b,
                                void* lanes_dev, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)lanes;
  (void)b;
  (void)lanes_dev;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  for (int l = 0; l < b; ++l)
    if (!learned_fault_operands(lanes + l))
      return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(replay_lanes_learned_faults_kernel, lanes, b,
                      static_cast<ReplayArgs*>(lanes_dev), true, false,
                      static_cast<cudaStream_t>(stream));
#endif
}

}  // extern "C"
