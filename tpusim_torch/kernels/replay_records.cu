// The record forms of `replay`: the kRecord instantiations of replay_body,
// which also write the obs records of ReplayArgs
// (tpusim_torch/sim/records.py): the counters, read at the launch's start
// and written back at its end, one decision row an event, one row a series
// sample, and heartbeat ticks into a host-mapped ring. They replace no TPU
// kernel of their own: they are row 1b (tpusim/sim/pallas_engine.py:
// 863-1103) with the records tpusim takes on its table engine's scan
// (table_engine.py:642-661, :1095-1219), which its Pallas kernels do not
// take. `replay` (replay.cu) hands a launch with ReplayArgs::ctr set to the
// launcher here; each instantiation comes with and without kKeyOut (the
// chunk form's key out, replay_chunks.cu). replay_blocked's record forms
// are in replay_blocked_records.cu, compiled in parallel with this file:
// the two are the longest compiles of the library. The forms that record
// nothing are instantiated apart, in replay.cu and replay_chunks.cu, and
// every record branch of the shared bodies is `if constexpr`, so that
// their code is what it was.
//
// A decision takes no pass of its own: the select's pass keeps each
// thread's top-3 and feasible count, each warp merges its lanes', and the
// record warp (kRecWarp) merges the warps' and writes the row beside warp
// 0's commit, with the counters and heartbeat ticks (record_event). What
// bounds them: the plain forms' serial event chain, plus per sample two
// passes over N with each node's frag amounts over the T typical pods
// (O(N T)); the heartbeat is one mapped store and a system fence a tick.
//
// The clocked build (TPUSIM_PHASE_CLOCKS), which only chip_smoke.py's
// phase clocks load, compiles nothing here: its launcher hands the paper's
// shape to replay_records_clocked.cu's clocked instantiation and refuses
// the others.
//
// Interface: plain C, bound with ctypes through replay.cu's entries; the
// launchers return the CUDA error code of the launch and never
// synchronise.

#define TPUSIM_LANES_TU
#include "replay.cu"

#ifndef TPUSIM_PHASE_CLOCKS
namespace {

template <bool kGeneral, bool kRandomized, bool kStaged>
int launch_flat_record(const ReplayArgs* a, cudaStream_t s) {
  if (a->key_out != nullptr)
    return launch_replay(
        replay_kernel<kGeneral, kRandomized, kStaged, false, true, true>, a,
        kGeneral, false, s);
  return launch_replay(
      replay_kernel<kGeneral, kRandomized, kStaged, false, false, true>, a,
      kGeneral, false, s);
}

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

#ifdef TPUSIM_PHASE_CLOCKS
int replay_record_clocked(const ReplayArgs* a, void* stream);
#endif

// replay's record form; the other checks are replay's
int replay_record(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  return replay_record_clocked(a, stream);
#else
  if (!record_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = a->scratch == nullptr;
  if (randomized(a)) {
    if (staged) return launch_flat_record<true, true, true>(a, s);
    return launch_flat_record<true, true, false>(a, s);
  }
  if (!staged) return launch_flat_record<true, false, false>(a, s);
  if (fgd_only(a)) return launch_flat_record<false, false, true>(a, s);
  return launch_flat_record<true, false, true>(a, s);
#endif
}

// A host buffer of `bytes` mapped into the device's address space
// (cudaHostAlloc with cudaHostAllocMapped): its host pointer into *host and
// the device's pointer into *dev. The heartbeat's ring.
int mapped_alloc(size_t bytes, void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, bytes, cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(dev, *host, 0);
  if (err != cudaSuccess) cudaFreeHost(*host);
  return static_cast<int>(err);
}

int mapped_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

}  // extern "C"
