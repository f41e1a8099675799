// The record forms of `replay_blocked`: the kRecord instantiations of
// replay_blocked_body (replay_records.cu says what they record and what
// bounds them; their decision row also carries the winner's 128-node
// block). They are row 2 (tpusim/sim/pallas_engine.py:1346) with the
// records of tpusim's blocked table engine (table_engine.py:880-991). A
// decision is O(N) where the blocked select is O(N/128): that is the cost
// of recording one, and only the record form pays it. Each instantiation
// comes with and without kKeyOut; this file is compiled in parallel with
// the others, and the clocked build's launcher refuses the record forms.
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

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

// replay_blocked's record form; the other checks are replay_blocked's
int replay_blocked_record(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)stream;
  (void)a;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (!record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->scratch != nullptr) return launch_blocked_record<true, false, true>(a, s);
  if (fgd_only(a)) return launch_blocked_record<false, true, true>(a, s);
  if (has_column(a, kSimon)) return launch_blocked_record<true, true, true>(a, s);
  return launch_blocked_record<true, true, false>(a, s);
#endif
}

}  // extern "C"
