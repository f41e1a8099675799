// The fault forms of `replay` and `replay_lanes`: the in-scan fault lane of
// tpusim (tpusim/sim/fault_lane.py, the table engine's fault body,
// tpusim/sim/table_engine.py:1189-1221) on the replay kernels, as the
// kFaults instantiations of replay_body. tpusim runs this lane on its table
// engine, not on a Pallas kernel, so these are the port's own forms of
// rows 1b and 1b' (pallas_engine.py:863-1103).
//
// The event stream is the merged stream of fault_lane.compile_fault_plan:
// creates, deletes and skips as in `replay`, node failures, recoveries and
// evictions (fault_step, by warp 0 where it commits), and retry slots,
// popped by warp 0 at the end of the step before (pop_ahead) into a create
// of the popped pod or a skip. An inert slot costs the pop's scan of the
// queue (one warp, f_cap_r entries) and the step's barrier. The kernels
// are compiled in a file of their own, in parallel with the others, so the
// no-fault instantiations are built as they were.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_FAULTS_TU
#include "replay_lanes.cu"

extern "C" {

// the learned fault forms (replay_learned_faults.cu)
int replay_learned_faults(const ReplayArgs* a, void* stream);
int replay_lanes_learned_faults(const ReplayArgs* lanes, int b,
                                void* lanes_dev, void* stream);

// replay's fault form: one block over the merged stream of one lane
int replay_faults(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies || !fault_operands(a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (learned(a)) return replay_learned_faults(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = a->scratch == nullptr;
  if (randomized(a)) {
    if (staged)
      return launch_replay(replay_kernel<true, true, true, true>, a, true,
                           false, s);
    return launch_replay(replay_kernel<true, true, false, true>, a, true,
                         false, s);
  }
  if (!staged)
    return launch_replay(replay_kernel<true, false, false, true>, a, true,
                         false, s);
  if (fgd_only(a))
    return launch_replay(replay_kernel<false, false, true, true>, a, false,
                         false, s);
  return launch_replay(replay_kernel<true, false, true, true>, a, true, false,
                       s);
}

// replay_lanes' fault form: b lanes, each its own merged stream, queue and
// bookkeeping; refuses lanes of different instantiations
int replay_lanes_faults(const ReplayArgs* lanes, int b, void* lanes_dev,
                        void* stream) {
  if (!check_lanes(lanes, b)) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < b; ++l)
    if (!fault_operands(lanes + l))
      return static_cast<int>(cudaErrorInvalidValue);
  if (learned(lanes))
    return replay_lanes_learned_faults(lanes, b, lanes_dev, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ReplayArgs* dev = static_cast<ReplayArgs*>(lanes_dev);
  const ReplayArgs* a = lanes;
  const bool staged = a->scratch == nullptr;
  if (randomized(a)) {
    if (staged)
      return launch_lanes(replay_lanes_kernel<true, true, true, true>, lanes,
                          b, dev, true, false, s);
    return launch_lanes(replay_lanes_kernel<true, true, false, true>, lanes, b,
                        dev, true, false, s);
  }
  if (!staged)
    return launch_lanes(replay_lanes_kernel<true, false, false, true>, lanes, b,
                        dev, true, false, s);
  if (fgd_only(a))
    return launch_lanes(replay_lanes_kernel<false, false, true, true>, lanes, b,
                        dev, false, false, s);
  return launch_lanes(replay_lanes_kernel<true, false, true, true>, lanes, b,
                      dev, true, false, s);
}

}  // extern "C"
