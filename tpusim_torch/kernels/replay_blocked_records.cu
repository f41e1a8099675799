// The record forms of `replay_blocked`: the kRecord instantiations of
// replay_blocked_body (replay_records.cu says what they record and what
// bounds them; their decision row also carries the winner's 128-node
// block). They are row 2 (tpusim/sim/pallas_engine.py:1346) with the
// records of tpusim's blocked table engine (table_engine.py:880-991). A
// decision's top-3 lies in the type's three best blocks, which the
// select's pass over the block summaries keeps, and three warps rescan
// those 3 x 128 nodes beside the commit; its feasible count is the type's,
// which the refresh keeps (record_blocked_event). The paper's shape
// counting only (the heartbeat's form) runs the kCountOnly instantiation,
// without the decision and sample code. Each instantiation comes with and
// without kKeyOut; this file is compiled in parallel with the others.
// The clocked build compiles nothing here: its launcher hands the paper's
// shape to replay_records_clocked.cu and refuses the others.
//
// Interface: plain C, bound with ctypes through replay.cu's entries.

#define TPUSIM_LANES_TU
#include "replay.cu"

#ifndef TPUSIM_PHASE_CLOCKS
namespace {

template <bool kGeneral, bool kStaged, bool kAllColumns>
int launch_blocked_record(const ReplayArgs* a, cudaStream_t s) {
  if (a->key_out != nullptr)
    return launch_replay(
        replay_blocked_kernel<kGeneral, kStaged, kAllColumns, false, true,
                              true>,
        a, kGeneral, true, s);
  return launch_replay(
      replay_blocked_kernel<kGeneral, kStaged, kAllColumns, false, false,
                            true>,
      a, kGeneral, true, s);
}

// The paper's shape counting only (no decision rows, no series: the
// heartbeat's form at scale), the kCountOnly instantiation, which carries
// none of the decision and sample code
int launch_blocked_counting(const ReplayArgs* a, cudaStream_t s) {
  if (a->key_out != nullptr)
    return launch_replay(
        replay_blocked_kernel<false, true, true, false, true, true, false,
                              true>,
        a, false, true, s);
  return launch_replay(
      replay_blocked_kernel<false, true, true, false, false, true, false,
                            true>,
      a, false, true, s);
}

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

#ifdef TPUSIM_PHASE_CLOCKS
int replay_blocked_record_clocked(const ReplayArgs* a, void* stream);
#endif

// replay_blocked's record form; the other checks are replay_blocked's
int replay_blocked_record(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  return replay_blocked_record_clocked(a, stream);
#else
  if (!blocked_record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->scratch != nullptr) return launch_blocked_record<true, false, true>(a, s);
  if (fgd_only(a) && a->rec_dec == nullptr && a->rec_every == 0)
    return launch_blocked_counting(a, s);
  if (fgd_only(a)) return launch_blocked_record<false, true, true>(a, s);
  if (has_column(a, kSimon)) return launch_blocked_record<true, true, true>(a, s);
  return launch_blocked_record<true, true, false>(a, s);
#endif
}

}  // extern "C"
