// The clocked forms of the learned replays: the kLearned instantiations of
// replay_body and replay_blocked_body (replay_learned.cu,
// replay_blocked_learned.cu) built with the phase clocks, for the clocked
// variant alone (-DTPUSIM_PHASE_CLOCKS, kernels.VARIANTS). In it,
// `replay_learned` and `replay_blocked_learned` launch these where the
// launch asks for neither records nor the key out; the main build compiles
// nothing here. A source of its own, so that the clocked variant's build
// stays parallel. Besides the other phases, the clocks' kClkNode slot
// holds the node column's value: the cycles warp 1 spends on it a refresh
// (learned_node_stage), beside the commit it overlaps.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_LANES_TU
#include "replay.cu"

#ifdef TPUSIM_PHASE_CLOCKS
namespace {

// the learned operands a clocked launch takes: a staged shape, at most
// kMaxFamily features, no draws, no records, no key out
bool clocked_learned_operands(const ReplayArgs* a) {
  return a->scratch == nullptr && staged_shape(a) && a->ln_n >= 0 &&
         a->ln_n <= kMaxFamily && a->fam_n >= 0 && a->fam_n <= kMaxFamily &&
         !randomized(a) && a->ctr == nullptr && a->key_out == nullptr &&
         a->n_pol >= 1 && a->n_pol <= kMaxPolicies;
}

}  // namespace

extern "C" {

int replay_learned_clocked(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (!clocked_learned_operands(a))
    return static_cast<int>(cudaErrorNotSupported);
  return launch_replay(
      replay_kernel<true, false, true, false, false, false, true>, a, true,
      false, static_cast<cudaStream_t>(stream));
}

int replay_blocked_learned_clocked(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (!clocked_learned_operands(a) || a->n % kBlock != 0)
    return static_cast<int>(cudaErrorNotSupported);
  return launch_replay(
      replay_blocked_kernel<true, true, true, false, false, false, true>, a,
      true, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
#endif  // TPUSIM_PHASE_CLOCKS
