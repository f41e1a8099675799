// The clocked form of the teacher-forced replay (replay_forced.cu): its
// kernel built with the phase clocks, for the clocked variant alone
// (-DTPUSIM_PHASE_CLOCKS, kernels.VARIANTS), where `replay_forced`
// launches it; the main build compiles nothing here. A source of its own,
// so that the clocked variant's build stays parallel. Its slots: refresh,
// select, the feature rows at the recorded top-3 (kClkRows) and at the
// argmax (kClkArow), the selector's device pick at the recorded node
// (kClkPick), commit, and warp 1's node stage (kClkNode).
//
// Interface: plain C, bound with ctypes; the launcher returns the CUDA
// error code of the launch and never synchronises.

#define TPUSIM_FORCED_CLOCKED_TU
#include "replay_forced.cu"

#ifdef TPUSIM_PHASE_CLOCKS
extern "C" {

int replay_forced_clocked(const ReplayArgs* a, void* stream) {
  return launch_forced(a, stream);
}

}  // extern "C"
#endif  // TPUSIM_PHASE_CLOCKS
