// The fault forms of `replay_blocked` and `replay_blocked_lanes`: the
// in-scan fault lane (replay_faults.cu says what it runs) as the kFaults
// instantiations of replay_blocked_body, the port's own forms of rows 2
// and 2' (pallas_engine.py _make_hbm_kernel :1346; tpusim runs the lane on
// its blocked table engine, table_engine.py:963-993). A fault step touches
// one node, so the block summaries take their one update a step. Compiled
// in a file of its own, in parallel with the others.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_FAULTS_TU
#include "replay_lanes.cu"

extern "C" {

// the learned fault forms (replay_blocked_learned_faults.cu)
int replay_blocked_learned_faults(const ReplayArgs* a, void* stream);
int replay_blocked_lanes_learned_faults(const ReplayArgs* lanes, int b,
                                        void* lanes_dev, void* stream);

// replay_blocked's fault form; the randomized configurations run the flat
// one only
int replay_blocked_faults(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies || a->n % kBlock != 0 ||
      randomized(a) || !fault_operands(a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (learned(a)) return replay_blocked_learned_faults(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->scratch != nullptr)
    return launch_replay(replay_blocked_kernel<true, false, true, true>, a,
                         true, true, s);
  if (fgd_only(a))
    return launch_replay(replay_blocked_kernel<false, true, true, true>, a,
                         false, true, s);
  if (has_column(a, kSimon))
    return launch_replay(replay_blocked_kernel<true, true, true, true>, a,
                         true, true, s);
  return launch_replay(replay_blocked_kernel<true, true, false, true>, a,
                       true, true, s);
}

// replay_blocked_lanes' fault form: b lanes, one block each
int replay_blocked_lanes_faults(const ReplayArgs* lanes, int b,
                                void* lanes_dev, void* stream) {
  if (!check_lanes(lanes, b) || randomized(lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < b; ++l)
    if (lanes[l].n % kBlock != 0 || !fault_operands(lanes + l))
      return static_cast<int>(cudaErrorInvalidValue);
  if (learned(lanes))
    return replay_blocked_lanes_learned_faults(lanes, b, lanes_dev, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ReplayArgs* dev = static_cast<ReplayArgs*>(lanes_dev);
  const ReplayArgs* a = lanes;
  if (a->scratch != nullptr)
    return launch_lanes(replay_blocked_lanes_kernel<true, false, true, true>,
                        lanes, b, dev, true, true, s);
  if (fgd_only(a))
    return launch_lanes(replay_blocked_lanes_kernel<false, true, true, true>,
                        lanes, b, dev, false, true, s);
  if (has_column(a, kSimon))
    return launch_lanes(replay_blocked_lanes_kernel<true, true, true, true>,
                        lanes, b, dev, true, true, s);
  return launch_lanes(replay_blocked_lanes_kernel<true, true, false, true>,
                      lanes, b, dev, true, true, s);
}

}  // extern "C"
