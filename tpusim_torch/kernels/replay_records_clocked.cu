// The clocked forms of the record forms (replay_records.cu,
// replay_blocked_records.cu): the kRecord instantiations of replay_body and
// replay_blocked_body for the paper's shape (fgd_only, staged, no key out;
// the blocked form's counting-only one too) built with the phase clocks,
// for the clocked variant alone (-DTPUSIM_PHASE_CLOCKS, kernels.VARIANTS),
// where `replay_record` and
// `replay_blocked_record` launch these; the main build compiles nothing
// here. A source of its own, so that the clocked variant's build stays
// parallel. Besides the other phases, the clocks' kClkSample, kClkDecide
// and kClkCount slots hold the series samples', the decision rows' and
// the counting's cycles.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_LANES_TU
#include "replay.cu"

#ifdef TPUSIM_PHASE_CLOCKS
extern "C" {

int replay_record_clocked(const ReplayArgs* a, void* stream) {
  if (!record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a->scratch != nullptr || a->key_out != nullptr || !fgd_only(a))
    return static_cast<int>(cudaErrorNotSupported);
  return launch_replay(
      replay_kernel<false, false, true, false, false, true>, a, false, false,
      static_cast<cudaStream_t>(stream));
}

int replay_blocked_record_clocked(const ReplayArgs* a, void* stream) {
  if (!blocked_record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a->scratch != nullptr || a->key_out != nullptr || !fgd_only(a))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->rec_dec == nullptr && a->rec_every == 0)  // counting only
    return launch_replay(
        replay_blocked_kernel<false, true, true, false, false, true, false,
                              true>,
        a, false, true, s);
  return launch_replay(
      replay_blocked_kernel<false, true, true, false, false, true>, a, false,
      true, s);
}

}  // extern "C"
#endif  // TPUSIM_PHASE_CLOCKS
