// The learned columns on the flat replay: the kLearned instantiations of
// init_tables (as its global form, init_pairs: a thread per (type, node)),
// replay_body (its plain, chunk and lanes forms) for the configurations
// with a learned column (tpusim_torch/learn/policy.py; the host folds a
// learned family into at most three columns, sim/fused_engine.py `fold`):
// fit_dev_pct's (kFitDev) and the node column (kLearnedNode), the weighted
// sum of the family's node-only features (node_features), the same for
// every type. frag_delta is FGD's column. tpusim has no Pallas column for
// a learned feature: its table engine replays them (tpusim/learn/policy.py,
// tpusim/sim/table_engine.py make_table_builders), one [K, N] row a
// feature; here the node-only ones are one row, so the select reads at most
// three, and a sweep over a population of weights is one lanes launch whose
// lanes rebuild the node column's rows for their own weights at the start
// (learned_rows).
//
// The instantiations are compiled here, apart from replay.cu and in
// parallel with it, so the others are the code they were: every branch on
// kLearned is `if constexpr`. The clocked variant builds none of them here:
// its `replay_learned` launches the clocked form of
// replay_learned_clocked.cu, and its other launchers refuse. Only the
// staged forms (kernels.MAX_TYPES and
// MAX_TYPICAL) are built; a learned configuration past them is refused.
//
// Interface: plain C, bound with ctypes; the launchers return the CUDA
// error code of the launch and never synchronise.

#define TPUSIM_FAULTS_TU
#include "replay_lanes.cu"

#ifndef TPUSIM_PHASE_CLOCKS
namespace {

// init_tables of a learned configuration: a thread per (type, node),
// nodes fastest, through the column functions of policy_pair<kLearned>
__global__ void __launch_bounds__(kInitThreads)
    init_learned_kernel(ReplayArgs a) {
  const long long w =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= static_cast<long long>(a.k) * a.n) return;
  const int k = static_cast<int>(w / a.n);
  const int node = static_cast<int>(w % a.n);
  const NodeView v = load_node(a, node);
  int sel_dev = -1;
  for (int pi = 0; pi < table_rows(a); ++pi) {
    int score = 0;
    int dev = -1;
    policy_pair<true, true>(a, v, pi, k, node, &score, &dev);
    a.score[(static_cast<size_t>(pi) * a.k + k) * a.n + node] = score;
    if (pi == a.sel) sel_dev = dev;
  }
  const size_t at = static_cast<size_t>(k) * a.n + node;
  a.sdev[at] = sel_dev;
  a.feas[at] = feas_pair(a, v, k);
}

__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_lanes_learned_kernel(const ReplayArgs* __restrict__ lanes) {
  __shared__ __align__(16) ReplayArgs lane_args;
  load_lane(lanes, &lane_args);
  replay_body<true, false, true, false, false, false, true>(lane_args);
}

// the learned operands: a staged shape and at most kMaxFamily features
bool learned_operands(const ReplayArgs* a) {
  return a->scratch == nullptr && staged_shape(a) && a->ln_n >= 0 &&
         a->ln_n <= kMaxFamily && a->fam_n >= 0 && a->fam_n <= kMaxFamily &&
         !randomized(a);
}

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

// the learned record forms (replay_learned_records.cu)
int replay_learned_record(const ReplayArgs* a, void* stream);

int init_tables_learned(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)a;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (!staged_shape(a) || a->ln_n < 0 || a->ln_n > kMaxFamily || a->t < 0 ||
      a->ks < 0 || a->ks > a->k)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(a->k) * a->n;
  init_learned_kernel<<<static_cast<unsigned>((pairs + kInitThreads - 1) /
                                              kInitThreads),
                        kInitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
#endif
}

#ifdef TPUSIM_PHASE_CLOCKS
// the clocked forms (replay_learned_clocked.cu)
int replay_learned_clocked(const ReplayArgs* a, void* stream);
#endif

int replay_learned(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  return replay_learned_clocked(a, stream);
#else
  if (!learned_operands(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a->ctr != nullptr) return replay_learned_record(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->key_out != nullptr)
    return launch_replay(
        replay_kernel<true, false, true, false, true, false, true>, a, true,
        false, s);
  return launch_replay(
      replay_kernel<true, false, true, false, false, false, true>, a, true,
      false, s);
#endif
}

int replay_lanes_learned(const ReplayArgs* lanes, int b, void* lanes_dev,
                         void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)lanes;
  (void)b;
  (void)lanes_dev;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  for (int l = 0; l < b; ++l)
    if (!learned_operands(lanes + l))
      return static_cast<int>(cudaErrorInvalidValue);
  return launch_lanes(replay_lanes_learned_kernel, lanes, b,
                      static_cast<ReplayArgs*>(lanes_dev), true, false,
                      static_cast<cudaStream_t>(stream));
#endif
}

}  // extern "C"
