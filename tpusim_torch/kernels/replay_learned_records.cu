// The record forms of the learned instantiations (replay_learned.cu,
// replay_blocked_learned.cu): the kRecord, kLearned instantiations of
// replay_body and replay_blocked_body, whose score columns are the learned
// family's (ReplayArgs::fam_n, fam_src; records.py): a decision carries
// each family policy's raw and normalised score at the winner, a node
// feature's computed there (node_features), and a sample each one's
// extrema over the feasible nodes. Compiled apart and in parallel; the
// clocked variant builds none of them.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_LANES_TU
#include "replay.cu"

extern "C" {

int replay_learned_record(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)a;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (!record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->key_out != nullptr)
    return launch_replay(
        replay_kernel<true, false, true, false, true, true, true>, a, true,
        false, s);
  return launch_replay(
      replay_kernel<true, false, true, false, false, true, true>, a, true,
      false, s);
#endif
}

int replay_blocked_learned_record(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)a;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (!record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->key_out != nullptr)
    return launch_replay(
        replay_blocked_kernel<true, true, true, false, true, true, true>, a,
        true, true, s);
  return launch_replay(
      replay_blocked_kernel<true, true, true, false, false, true, true>, a,
      true, true, s);
#endif
}

}  // extern "C"
