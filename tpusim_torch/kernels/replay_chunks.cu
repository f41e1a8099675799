// The chunk forms of `replay` and `replay_blocked`: the kKeyOut
// instantiations of replay_body and replay_blocked_body, which also write
// the event key chain's key after their last event into ReplayArgs.key_out
// (write_key_out), the next chunk's root. They replace no TPU kernel of
// their own: they are rows 1b and 2 (pallas_engine.py:863-1103, :1346)
// started from a carried state, placements and key, as tpusim's table
// engine resumes its scan from a carry (table_engine.py:516-545). `replay`
// and `replay_blocked` (replay.cu) hand a launch with key_out set to the
// launchers here. The forms that write nothing are instantiated apart, in
// replay.cu, so that the code a launch without key_out runs is the same
// as before the key was written out; this file is compiled in parallel
// with the others.
//
// Interface: plain C, bound with ctypes through replay.cu's entries; the
// launchers return the CUDA error code of the launch and never
// synchronise.

#define TPUSIM_LANES_TU
#include "replay.cu"

extern "C" {

// replay's chunk form; the checks are replay's
int replay_chunk(const ReplayArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = a->scratch == nullptr;
  if (randomized(a)) {
    if (staged)
      return launch_replay(replay_kernel<true, true, true, false, true>, a,
                           true, false, s);
    return launch_replay(replay_kernel<true, true, false, false, true>, a,
                         true, false, s);
  }
  if (!staged)
    return launch_replay(replay_kernel<true, false, false, false, true>, a,
                         true, false, s);
  if (fgd_only(a))
    return launch_replay(replay_kernel<false, false, true, false, true>, a,
                         false, false, s);
  return launch_replay(replay_kernel<true, false, true, false, true>, a, true,
                       false, s);
}

// replay_blocked's chunk form; the checks are replay_blocked's
int replay_blocked_chunk(const ReplayArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->scratch != nullptr)
    return launch_replay(replay_blocked_kernel<true, false, true, false, true>,
                         a, true, true, s);
  if (fgd_only(a))
    return launch_replay(replay_blocked_kernel<false, true, true, false, true>,
                         a, false, true, s);
  if (has_column(a, kSimon))
    return launch_replay(replay_blocked_kernel<true, true, true, false, true>,
                         a, true, true, s);
  return launch_replay(replay_blocked_kernel<true, true, false, false, true>,
                       a, true, true, s);
}

}  // extern "C"
