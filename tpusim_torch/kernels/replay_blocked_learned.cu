// The learned columns on the blocked replay: the kLearned instantiations of
// replay_blocked_body (its plain, chunk and lanes forms), as
// replay_learned.cu's of replay_body (see there), compiled apart and in
// parallel. The clocked variant builds none of them here: its
// `replay_blocked_learned` launches the clocked form of
// replay_learned_clocked.cu, and its lanes launcher refuses. Only the
// staged forms are built.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_FAULTS_TU
#include "replay_lanes.cu"

#ifndef TPUSIM_PHASE_CLOCKS
namespace {

__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_blocked_lanes_learned_kernel(const ReplayArgs* __restrict__ lanes) {
  __shared__ __align__(16) ReplayArgs lane_args;
  load_lane(lanes, &lane_args);
  replay_blocked_body<true, true, true, false, false, false, true>(lane_args);
}

bool blocked_learned_operands(const ReplayArgs* a) {
  return a->scratch == nullptr && staged_shape(a) && a->ln_n >= 0 &&
         a->ln_n <= kMaxFamily && a->fam_n >= 0 && a->fam_n <= kMaxFamily &&
         !randomized(a) && a->n % kBlock == 0;
}

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

// the learned record forms (replay_learned_records.cu)
int replay_blocked_learned_record(const ReplayArgs* a, void* stream);

#ifdef TPUSIM_PHASE_CLOCKS
// the clocked form (replay_learned_clocked.cu)
int replay_blocked_learned_clocked(const ReplayArgs* a, void* stream);
#endif

int replay_blocked_learned(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  return replay_blocked_learned_clocked(a, stream);
#else
  if (!blocked_learned_operands(a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->ctr != nullptr) return replay_blocked_learned_record(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->key_out != nullptr)
    return launch_replay(
        replay_blocked_kernel<true, true, true, false, true, false, true>, a,
        true, true, s);
  return launch_replay(
      replay_blocked_kernel<true, true, true, false, false, false, true>, a,
      true, true, s);
#endif
}

int replay_blocked_lanes_learned(const ReplayArgs* lanes, int b,
                                 void* lanes_dev, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)lanes;
  (void)b;
  (void)lanes_dev;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  for (int l = 0; l < b; ++l)
    if (!blocked_learned_operands(lanes + l))
      return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(replay_blocked_lanes_learned_kernel, lanes, b,
                      static_cast<ReplayArgs*>(lanes_dev), true, true,
                      static_cast<cudaStream_t>(stream));
#endif
}

}  // extern "C"
