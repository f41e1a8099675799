// Fused trace replay for NVIDIA Hopper (sm_90a).
//
// Replaces the fused whole-replay Pallas kernel of the JAX package
// (tpusim/sim/pallas_engine.py: _make_kernel :780, launched at :1260 by
// make_pallas_replay :1122) for every configuration it covers, and the
// configurations tpusim runs on its table engine instead (Simon, which has
// no Pallas column, and the randomized ones, for Pallas has no jax.random;
// tpusim/sim/table_engine.py make_flat_body :1019): any list of up to six
// of the policies FGDScore, BestFitScore, GpuPackingScore,
// GpuClusteringScore, PWRScore, DotProductScore, Simon and RandomScore with
// integer weights, and gpu_sel best, worst, random or an enabled
// self-select policy. Its column functions are _fgd_column :360,
// _bestfit_column :451, _packing_column :464, _clustering_column :494,
// _pwr_column :521, _make_dotprod_column :578 and _feas_column :739, and
// tpusim/policies/simon.py simon_score.
//
// Three kernels share the __device__ column functions (one per policy,
// `*_pair`, scoring one pod type on one node):
//   init_tables_kernel  fills the [rows*K, N] score, [K, N] share-device
//                       and [K, N] Filter tables of the initial state (the
//                       Pallas kernel's event-0 table build, :903-910, and
//                       pass 1 of the HBM kernel, :1669-1701): a block per
//                       tile of 32 nodes (and slice of the types), FGD's
//                       node-only terms once per node, then a warp per
//                       (tile, batch of types) with a lane per node (see its
//                       section).
//   replay_kernel       one persistent block walks every event in order:
//                       refresh the column of the node the previous event
//                       changed, then on a create the min/max of each
//                       normalised policy's row over the feasible nodes,
//                       the i32 weighted sum and selectHost (threads over
//                       N, then block reductions), and one warp runs
//                       Reserve and Bind, or the unbind of a delete
//                       (:955-1103).
//   replay_blocked_kernel
//                       the same event loop for clusters whose tables
//                       outgrow L2; it replaces the HBM-residency Pallas
//                       kernel (_make_hbm_kernel :1346, launched at :2160 by
//                       _make_hbm_replay :2017). It keeps 128-node block
//                       summaries ([K, N/128]): per event it refreshes the
//                       dirty column, updates that block's summaries from
//                       the node's old and new values (update_summaries;
//                       a warp rescans the block only for the types where
//                       those cannot decide), checks the event type's
//                       normalisation extrema for drift (rebuilding its
//                       summary row over N only when one moved), and
//                       selects over N/128 summaries instead of N nodes.
//                       The Pallas kernel's double-buffered DMA has no
//                       counterpart: tables and summaries stay in global
//                       memory, and its waits/starts counters stay 0.
// The replays' bodies are __device__ functions (replay_body,
// replay_blocked_body): the kernels above pass them their parameter, and
// replay_lanes.cu's lanes kernels run them over a grid of B lanes, one
// block a lane (seed batches and config sweeps), compiled apart from this
// file with its host entries left out (TPUSIM_LANES_TU). Their kFaults
// instantiations, the fault forms (replay_faults.cu and
// replay_blocked_faults.cu, each compiled apart), replay the in-scan fault
// lane's merged stream: node failures, recoveries and evictions, and the
// retry slots that pop the retry queue (the fault forms' section).
// All three kernels are templates on the configuration's shape: <false> is
// specialised to the paper's FGD configuration (one FGDScore policy, gpu_sel
// FGDScore or best) and skips the descriptor, the normalisation pass and the
// policy loop; <true> reads the policy descriptor. `replay` has a third
// instantiation for the randomized configurations (RandomScore, gpu_sel
// random), which only it runs (tpusim runs them flat too: `bsz = 0 if
// has_random`, table_engine.py:1259): JAX's event key chain advanced by one
// thread per event (threefry2x32, as jax.random's partitionable form), the
// uniform draw over the feasible nodes spread over the block like the
// select, and the Reserve's device draw. RandomScore has no table rows: the
// host puts it last, so the other policies' rows keep their indices.
//
// Staged and global forms. The replay kernels stage the pod types and the
// typical pods in shared memory, which holds at most kMaxTypes types and
// kMaxTypical typical pods; init_tables' tiles hold as many. Past either,
// the host launches the global form: the replays lay the same arrays out in
// a scratch buffer in device memory (ReplayArgs::scratch) and read the type
// fields where the caller keeps them, and init_tables runs init_pairs, a
// thread per (type, node) through the refresh's column functions. The
// arrays are small and stay in L2. The staged instantiations are the ones
// every shape within the limits runs, as before.
//
// What bounds the replay kernels on this card: the replay is a serial chain
// of events, so its time is latency, not bytes or operations, and the design
// is about one SM (init_tables, bound by operations, says its own). The
// column refresh is spread over the whole block: FGD's node-only work (per
// typical pod its fit count and sum over the node's devices, and the node's
// current frag) is done once per event by one warp, then one
// thread per (share type, device) and one per whole type sums its
// hypothetical frag over the typical pods, which sit in shared memory with
// the type fields (staged once per launch); a share type's best device is
// picked with shuffles over its 8 lanes. Every other policy is one thread
// per type. A refresh follows only an event that changed a node. Each
// event's pod fields are staged 32 events at a time by one warp. An event
// of `replay` reads one row per policy (N int32 each, plus the Filter row);
// the tables stay in global memory, resident in L2 while they fit (50 MB).
// `replay_blocked` reads the dirty block's K summaries, 128 x K entries per
// rescan, and N/128 summaries for the select, so its event stays
// O(K + N/128) plus its rescans when the tables sit in device memory.
//
// Exactness: every column performs the float32 operations of the JAX
// package's compiled CPU code in its order, with explicit round-to-nearest
// intrinsics and --fmad=false: XLA's divisions by a constant become
// multiplications by a float32 reciprocal (or, where it folds two of them,
// by their product), and where the compiled code contracts a multiply into
// an add the kernel calls __fmaf_rn. tanh is XLA's rational approximation.
// Float-to-int conversions truncate toward zero and saturate, as XLA's.
// Integer arithmetic that XLA wraps modulo 2^32 runs on uint32 here. The
// plain PyTorch versions (tpusim_torch/policies/, sim/fused_engine.py,
// sim/hbm_engine.py) perform the same operations.
//
// Interface: plain C, bound with ctypes. The launchers return the CUDA error
// code of the launch (0 = success); they never synchronise.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kDevs = 8;       // MAX_GPUS_PER_NODE
constexpr int kAffClasses = 9; // share + 1..8 whole-GPU pods
constexpr int kMilli = 1000;
constexpr int kMaxNodeScore = 100;
constexpr int kMaxSpecGpu = 8000;
constexpr int kCreate = 0;
constexpr int kDelete = 1;
constexpr int kSkip = 2;
// the fault forms' step kinds (tpusim_torch/sim/engine.py)
constexpr int kNodeFail = 3;
constexpr int kNodeRecover = 4;
constexpr int kEvict = 5;
constexpr int kRetry = 6;
// the fault forms' disruption counters (fault_lane.py D_*)
constexpr int kDEvicted = 0;
constexpr int kDRetriesEnq = 1;
constexpr int kDRescheduled = 2;
constexpr int kDFailures = 3;
constexpr int kDRecoveries = 4;
constexpr int kDFnGpuEvents = 5;
constexpr int kDDead = 6;
constexpr int kInitThreads = 128;  // init_tables: 4 warps
constexpr int kTile = 32;  // init_tables: the nodes of a tile, one a lane
constexpr int kBatch = 8;  // init_tables: the most types FGD sums at once
constexpr int kReplayThreads = 512;
constexpr int kMaxPolicies = 6;
constexpr int kBlock = 128;  // nodes per block summary of replay_blocked
// the most pod types and typical pods the staged forms hold in shared
// memory (tpusim_torch.kernels MAX_TYPES, MAX_TYPICAL); larger shapes run
// the global forms
constexpr int kMaxTypes = 2048;
constexpr int kMaxTypical = 1024;
constexpr int kEvBatch = 32;  // events staged at a time, one a lane
constexpr int kRound = 8;  // typical-pod terms an FGD item computes at once

// column ids (tpusim_torch.policies.COLUMN_IDS)
constexpr int kFgd = 0;
constexpr int kBestFit = 1;
constexpr int kPacking = 2;
constexpr int kClustering = 3;
constexpr int kPwr = 4;
constexpr int kDotProd = 5;
constexpr int kSimon = 6;
constexpr int kRandomScore = 7;  // a draw per event: no table rows
// the learned columns (learn/policy.py; the kLearned instantiations of
// replay_learned.cu, replay_learned_records.cu and replay_forced.cu):
// fit_dev_pct's, and the node column, the weighted sum of a family's
// node-only features (ReplayArgs::ln_*), the same for every type
constexpr int kFitDev = 8;
constexpr int kLearnedNode = 9;
// the most node-only features the node column folds, and the most
// policies a learned family names (records and the forced form)
constexpr int kMaxFamily = 32;
// node_features' ids (learn/policy.py NODE_FEATURES)
constexpr int kNodeFeatures = 18;
constexpr int kUtilBuckets = 10;  // obs/series.py UTIL_BUCKETS
constexpr int kQ2 = 1;  // frag classes (constants.py)
constexpr int kQ3 = 2;
// normalize modes (NORMALIZE_IDS)
constexpr int kNormNone = 0;
constexpr int kNormMinMax = 1;
// gpu_sel modes
constexpr int kSelBest = 0;
constexpr int kSelWorst = 1;
constexpr int kSelSelf = 2;
constexpr int kSelRandom = 3;
// DotProduct dim_ext and norm (DIM_EXT_METHODS, NORM_METHODS order)
constexpr int kMerge = 0;
constexpr int kDivide = 2;
constexpr int kExtend = 3;
constexpr int kNormNode = 0;
constexpr int kNormPod = 1;
constexpr int kNormMax = 2;

// float32 constants of the compiled JAX code: float32(1/c) x 0.5, and the
// products r x r that XLA folds DotProduct's norm=max divisions into
constexpr float kRcpuHalf = 0x1.0624dep-18f;    // 1/128000 / 2
constexpr float kRgpuHalf = 0x1.0624dep-14f;    // 1/8000 / 2
constexpr float kRmilliHalf = 0x1.0624dep-11f;  // 1/1000 / 2
constexpr float kRRcpu = 0x1.0c6f7cp-34f;       // (1/128000)^2
constexpr float kRRgpu = 0x1.0c6f7cp-26f;       // (1/8000)^2
constexpr float kRten = 0x1.99999ap-4f;         // 1/10
constexpr int kPwrNeg = -2147483647;            // PWR's "no fitting device"

// The clocked build (-DTPUSIM_PHASE_CLOCKS, a library of its own that only
// chip_smoke.py loads) has thread 0 add clock64() deltas per phase of the
// event loop into ReplayArgs::clocks; the main build reads no clock.
#ifdef TPUSIM_PHASE_CLOCKS
constexpr bool kClocked = true;
#else
constexpr bool kClocked = false;
#endif
// clocks[] slots: cycles per phase, each from the end of the previous
// phase to the exit of the phase's closing barrier; kClkWait is the part of
// all of them thread 0 spent inside barriers; cycles of the whole event loop
// and of the summaries' init; counts of refreshes and rescans; inside the
// refresh, from its start to the last warp's end of its items (kClkWork),
// of their set-up and of their FGD sums; and the refresh's lanes in all
enum ClockSlot {
  kClkRefresh, kClkBlock, kClkDrift, kClkExtrema, kClkSelect, kClkCommit,
  kClkWait, kClkLoop, kClkInit, kClkRefreshes, kClkRescans, kClkWork,
  kClkSetup, kClkSum, kClkItems, kNumClocks = 16,
};

}  // namespace

extern "C" {

// Every device pointer, size and configuration value the two kernels read.
// Tables are row-major: score [rows*k, n] (policy-major, then type; rows =
// table_rows: every policy but a RandomScore, which comes last), sdev and
// feas [k, n]; gpu_left is [n, 8]; aff_cnt is [n, 9]. Types hold the ks
// share-GPU types first.
struct ReplayArgs {
  int32_t* cpu_left;
  int32_t* mem_left;
  int32_t* gpu_left;
  int32_t* aff_cnt;
  const int32_t* cpu_cap;
  const int32_t* cpu_type;
  const int32_t* gpu_cnt;
  const int32_t* gpu_type;
  const int32_t* rank;
  const int32_t* t_cpu;
  const int32_t* t_mem;
  const int32_t* t_milli;
  const int32_t* t_num;
  const int32_t* t_mask;
  const int32_t* tp_cpu;
  const int32_t* tp_milli;
  const int32_t* tp_num;
  const int32_t* tp_mask;
  const float* tp_freq;
  const float* gpu_idle_w;
  const float* gpu_full_w;
  const float* cpu_idle_w;
  const float* cpu_full_w;
  const float* cpu_ncores;
  int32_t* score;
  int32_t* sdev;
  int32_t* feas;
  const int32_t* p_cpu;
  const int32_t* p_mem;
  const int32_t* p_milli;
  const int32_t* p_num;
  const int32_t* p_pinned;
  const int32_t* p_type;
  const int32_t* ev_kind;
  const int32_t* ev_pod;
  int32_t* placed;
  int32_t* maskb;
  int32_t* failed;
  int32_t* ev_node;
  int32_t* ev_devb;
  // replay_blocked's block summaries (bt/br/bn [k, n/128], brmin/brmax
  // [nn, k, n/128], slo/shi [nn, k]) and its counters (waits, starts,
  // rebuilds); null for the other kernels
  int32_t* bt;
  int32_t* br;
  int32_t* bn;
  int32_t* brmin;
  int32_t* brmax;
  int32_t* slo;
  int32_t* shi;
  int32_t* stats;
  // the clocked build's phase clocks (int64 [16], ClockSlot); null and
  // unread in the main build
  long long* clocks;
  // init_tables' type order (fused_engine.type_order): the types by FGD's
  // key, share or whole, milli and GPU count, ties by index; null for the
  // others
  const int32_t* t_order;
  // the nodes' memory capacity (Simon's base)
  const int32_t* mem_cap;
  // the replays' global form: where the arrays the staged form keeps in
  // shared memory live (replay_scratch_bytes bytes); null for the staged
  // form
  void* scratch;
  // where replay and replay_blocked write the event key chain's key after
  // their last event (two words; the chain from `key`, one step an event,
  // whatever its kind): a chunked replay's next root. Set, the launch runs
  // the chunk forms (replay_chunks.cu); null, the forms that write nothing
  uint32_t* key_out;
  int32_t n;
  int32_t k;
  int32_t ks;
  int32_t t;
  int32_t p;
  int32_t e;
  // the policy descriptor: per policy its column id, normalize mode and
  // weight; the selector policy's index (-1 = none), the gpu_sel mode and
  // DotProduct's dim_ext and norm
  int32_t n_pol;
  int32_t pol_column[kMaxPolicies];
  int32_t pol_norm[kMaxPolicies];
  int32_t pol_weight[kMaxPolicies];
  int32_t sel;
  int32_t gpu_sel;
  int32_t dim_ext;
  int32_t norm;
  // the root key of JAX's event key chain (jax.random.PRNGKey(seed) with
  // x64 off: 0, seed mod 2^32); read by the randomized replay only
  uint32_t key[2];
  // The fault forms' operands (replay_faults.cu, replay_blocked_faults.cu;
  // null and unread in the others; tpusim_torch/sim/fault_lane.py). Per
  // merged step [e]: its trace position, its argument (node, explicit
  // pod, or flush round) and its draw-table row; the victim draw table
  // [f_rows, f_cols]. The retry queue [f_cap_r] and the bookkeeping, read
  // and written in place: the next sequence number [1], per pod the
  // attempts, the eviction position and the dead flag, per node the
  // failure position, the disruption counters [7]. The steps' outputs
  // [e] (written where not their defaults), and per applied recover the
  // cluster's cpu_left [n] and gpu_left [n, 8] right before it and its
  // node (f_nrec slots at most).
  const int32_t* f_pos;
  const int32_t* f_arg;
  const int32_t* f_aux;
  const int32_t* f_draws;
  int32_t* q_ready;
  int32_t* q_seq;
  int32_t* q_pod;
  int32_t* q_att;
  int32_t* q_era;
  int32_t* f_seq;
  int32_t* f_attempts;
  int32_t* f_evicted_at;
  int32_t* f_dead;
  int32_t* f_down_at;
  int32_t* f_dctr;
  int32_t* y_rpod;
  int32_t* y_lat;
  int32_t* y_vpod;
  int32_t* y_vnode;
  int32_t* y_nvict;
  int32_t* y_rec;
  int32_t* snap_cpu;
  int32_t* snap_gpu;
  int32_t* snap_node;
  // the draw table's shape, the queue's capacity, the backoff's base and
  // cap, max_retries, the snapshot slots
  int32_t f_rows;
  int32_t f_cols;
  int32_t f_cap_r;
  int32_t f_base;
  int32_t f_cap;
  int32_t f_maxr;
  int32_t f_nrec;
  // The record forms' streams (replay_records.cu, replay_blocked_records.cu;
  // null and unread in the others; tpusim_torch/sim/records.py): the
  // counters [6] (obs/counters.py order), read at the launch's start and
  // written back at its end; a decision row an event [e, 13 + 2 n_pol]
  // (null: none); a row a real sample [s, 20 + 2 n_pol] (null: none); the
  // heartbeat's host-mapped ring [1 + hb_slots] (null: none), word 0 the
  // ticks written, slot 1 + j % hb_slots tick j's processed count. The
  // series and heartbeat strides, the ring's slots, and the cluster's
  // nodes before the blocked replay's padding.
  int32_t* ctr;
  int32_t* rec_dec;
  int32_t* rec_ser;
  int32_t* hb_ring;
  int32_t rec_every;
  int32_t hb_every;
  int32_t hb_slots;
  int32_t rec_nodes;
  // The learned columns (read by the kLearned instantiations only): the
  // node column's ln_n features (node_features ids) and their weights; a
  // learned family's fam_n policies, each a table row (>= 0) or node
  // feature -1 - id, in the configuration's order: the record forms' score
  // columns and the forced form's feature rows.
  int32_t ln_n;
  int32_t ln_feat[kMaxFamily];
  int32_t ln_theta[kMaxFamily];
  int32_t fam_n;
  int32_t fam_src[kMaxFamily];
  // The forced form (replay_forced.cu; null and unread in the others): per
  // event the node the log recorded [e] and its top-3 [e, 3]; out per event
  // the family's argmax (-1 none) [e], the feasible count [e], the feature
  // rows of the recorded top-3 [e, 3, fam_n] (-1 where absent) and of the
  // argmax [e, fam_n]. fr_sel: the column of the gpuSelMethod's selector
  // whose device pick Reserve takes at the recorded node (-1: none).
  const int32_t* fr_node;
  const int32_t* fr_topk;
  int32_t* fr_pick;
  int32_t* fr_feasible;
  int32_t* fr_feats;
  int32_t* fr_pick_feats;
  int32_t fr_sel;
};

}  // extern "C"

namespace {

// the policies with score-table rows: all but a RandomScore, which the
// host puts last
__device__ __forceinline__ int table_rows(const ReplayArgs& a) {
  return a.n_pol - (a.pol_column[a.n_pol - 1] == kRandomScore ? 1 : 0);
}

struct NodeView {
  int cpu;
  int mem;
  int cap;
  int gcnt;
  int gtyp;
  int ctyp;
  int bit;  // GPU-model bit, 0 for CPU-only nodes
  int g[kDevs];
  int aff[kAffClasses];
};

__device__ __forceinline__ NodeView load_node(const ReplayArgs& a, int n) {
  NodeView v;
  v.cpu = a.cpu_left[n];
  v.mem = a.mem_left[n];
  v.cap = a.cpu_cap[n];
  v.gcnt = a.gpu_cnt[n];
  v.gtyp = a.gpu_type[n];
  v.ctyp = a.cpu_type[n];
  v.bit = v.gtyp >= 0 ? (1 << v.gtyp) : 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) v.g[d] = a.gpu_left[n * kDevs + d];
#pragma unroll
  for (int c = 0; c < kAffClasses; ++c) v.aff[c] = a.aff_cnt[n * kAffClasses + c];
  return v;
}

__device__ __forceinline__ int gpu_sum(const NodeView& v) {
  int s = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) s += v.g[d];
  return s;
}

__device__ __forceinline__ int idle_count(const NodeView& v) {
  int c = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) c += v.g[d] == kMilli ? 1 : 0;
  return c;
}

// float -> int32 truncating toward zero, saturating, NaN -> 0 (XLA convert)
__device__ __forceinline__ int to_i32(float x) { return __float2int_rz(x); }

// floor division for a divisor >= 1 (XLA's int32 `//`)
__device__ __forceinline__ int floor_div(int num, int den) {
  const int q = num / den;
  return (num % den != 0 && num < 0) ? q - 1 : q;
}

// Sub's device choice (resource.go:454-480): fitting devices, least free
// first, ties by index, until wn are taken. Returns whether wn were found.
__device__ __forceinline__ bool packed_take(const NodeView& v, int wm, int wn,
                                            bool take[kDevs]) {
  int pos[kDevs];
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    int c = 0;
#pragma unroll
    for (int e = 0; e < kDevs; ++e)
      c += (v.g[e] < v.g[d] || (v.g[e] == v.g[d] && e < d)) ? 1 : 0;
    pos[d] = c;
  }
  int taken = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    const bool fit = wm > 0 && v.g[d] >= wm;
    int ahead = 0;
#pragma unroll
    for (int e = 0; e < kDevs; ++e)
      ahead += (wm > 0 && v.g[e] >= wm && pos[e] < pos[d]) ? 1 : 0;
    take[d] = fit && ahead < wn;
    taken += take[d] ? 1 : 0;
  }
  return taken >= wn;
}

// trunc(sigmoid((cur - new) / 1000) * 100), fgd_score.go:124
__device__ __forceinline__ int sigmoid_score(float cur, float nw) {
  const float x = __fmul_rn(__fsub_rn(cur, nw), 0.001f);
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
  return static_cast<int>(floorf(__fmul_rn(s, 100.0f)));
}

// FGD raw score and FGD's share-device pick of type k on one node
// (_fgd_column :360 for one row; policies/fgd.py).
__device__ void fgd_pair(const ReplayArgs& a, const NodeView& v, int k,
                         int* score, int* sdev) {
  const int gsum = gpu_sum(v);
  const float total = static_cast<float>(gsum);
  float cur = 0.0f;

  if (k < a.ks) {
    // share branch: the best per-device hypothetical (fgd_score.go:111-134)
    const int p = a.t_milli[k];
    const int cpu_h = v.cpu - a.t_cpu[k];
    const float total_h = static_cast<float>(gsum - p);
    float nw[kDevs];
#pragma unroll
    for (int d = 0; d < kDevs; ++d) nw[d] = 0.0f;
    for (int t = 0; t < a.t; ++t) {
      const int m = a.tp_milli[t];
      const int num = a.tp_num[t];
      const int c = a.tp_cpu[t];
      const int mask = a.tp_mask[t];
      const float fr = a.tp_freq[t];
      const bool gpu_pod = m > 0;
      const bool acc = mask == 0 || (mask & v.bit) != 0;
      int fitcnt = 0;
      int fitsum = 0;
#pragma unroll
      for (int d = 0; d < kDevs; ++d) {
        if (gpu_pod && v.g[d] >= m) {
          ++fitcnt;
          fitsum += v.g[d];
        }
      }
      const bool q3 = gpu_pod && acc && fitcnt >= num && v.cpu >= c;
      cur = __fadd_rn(cur, __fmul_rn(fr, q3 ? static_cast<float>(gsum - fitsum)
                                            : total));
      const bool cpu_ok = cpu_h >= c;
#pragma unroll
      for (int d = 0; d < kDevs; ++d) {
        const bool fit = gpu_pod && v.g[d] >= m;
        const bool fitp = gpu_pod && v.g[d] - p >= m;
        const int cnt_h = fitcnt - (fit ? 1 : 0) + (fitp ? 1 : 0);
        const int sum_h = fitsum - (fit ? v.g[d] : 0) + (fitp ? v.g[d] - p : 0);
        const bool q = gpu_pod && acc && cnt_h >= num && cpu_ok;
        const float term = q ? static_cast<float>(gsum - p - sum_h) : total_h;
        nw[d] = __fadd_rn(nw[d], __fmul_rn(fr, term));
      }
    }
    int best = -1;
    int best_dev = -1;
#pragma unroll
    for (int d = 0; d < kDevs; ++d) {
      if (v.g[d] >= p) {
        const int s = sigmoid_score(cur, nw[d]);
        if (s > best) {  // first device on ties
          best = s;
          best_dev = d;
        }
      }
    }
    *score = best >= 0 ? best : 0;
    *sdev = best >= 0 ? best_dev : -1;
    return;
  }

  // whole-GPU / CPU-only branch: the Sub hypothetical (fgd_score.go:137-148)
  const int wm = a.t_milli[k];
  const int wn = a.t_num[k];
  const int cpu_w = v.cpu - a.t_cpu[k];
  bool take[kDevs];
  packed_take(v, wm, wn, take);
  int g2[kDevs];
  int g2sum = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    g2[d] = (wn > 0 && take[d]) ? v.g[d] - wm : v.g[d];
    g2sum += g2[d];
  }
  const float total2 = static_cast<float>(g2sum);
  float nw = 0.0f;
  for (int t = 0; t < a.t; ++t) {
    const int m = a.tp_milli[t];
    const int num = a.tp_num[t];
    const int c = a.tp_cpu[t];
    const int mask = a.tp_mask[t];
    const float fr = a.tp_freq[t];
    const bool gpu_pod = m > 0;
    const bool acc = mask == 0 || (mask & v.bit) != 0;
    int fitcnt = 0;
    int fitsum = 0;
    int fitcnt2 = 0;
    int fitsum2 = 0;
#pragma unroll
    for (int d = 0; d < kDevs; ++d) {
      if (gpu_pod && v.g[d] >= m) {
        ++fitcnt;
        fitsum += v.g[d];
      }
      if (gpu_pod && g2[d] >= m) {
        ++fitcnt2;
        fitsum2 += g2[d];
      }
    }
    const bool q3 = gpu_pod && acc && fitcnt >= num && v.cpu >= c;
    cur = __fadd_rn(cur, __fmul_rn(fr, q3 ? static_cast<float>(gsum - fitsum)
                                          : total));
    const bool q = gpu_pod && acc && fitcnt2 >= num && cpu_w >= c;
    nw = __fadd_rn(nw, __fmul_rn(fr, q ? static_cast<float>(g2sum - fitsum2)
                                       : total2));
  }
  *score = sigmoid_score(cur, nw);
  *sdev = -1;
}

// BestFit (_bestfit_column :451; policies/bestfit.py): the CPU term's
// multiply is fused into the sum, as in the compiled JAX code
__device__ __forceinline__ int bestfit_pair(const ReplayArgs& a,
                                            const NodeView& v, int k) {
  const float free_cpu = static_cast<float>(v.cpu);
  const float free_gpu = static_cast<float>(gpu_sum(v));
  const float req_cpu = static_cast<float>(a.t_cpu[k]);
  const float req_gpu = static_cast<float>(a.t_milli[k] * a.t_num[k]);
  const float s = __fmaf_rn(__fsub_rn(free_cpu, req_cpu), kRcpuHalf,
                            __fmul_rn(__fsub_rn(free_gpu, req_gpu), kRgpuHalf));
  return to_i32(floorf(__fmul_rn(__fsub_rn(1.0f, s), 100.0f)));
}

// GpuPacking's tiers once Sub has taken the devices `take`
__device__ __forceinline__ int packing_tiers(const NodeView& v,
                                             const bool take[kDevs]) {
  constexpr int t3 = kMaxNodeScore / 3;
  constexpr int t2 = kMaxNodeScore / 2;
  int free_used = 0;
  int ratio = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    if (take[d]) {
      free_used += v.g[d] == kMilli ? 1 : 0;
      ratio += v.g[d] * 100 / kMilli;
    }
  }
  return free_used > 0 ? max(t2 - free_used, t3)
                       : max(kMaxNodeScore - ratio / 10, t2);
}

// GpuPacking (_packing_column :464; policies/packing.py), in integers
__device__ __forceinline__ int packing_pair(const ReplayArgs& a,
                                            const NodeView& v, int k) {
  const int milli = a.t_milli[k];
  const int num = a.t_num[k];
  if (milli * num <= 0) return 0;
  constexpr int t3 = kMaxNodeScore / 3;
  const int fully_free = idle_count(v);
  if (fully_free == v.gcnt) return max(t3 - fully_free, fully_free);
  bool take[kDevs];
  if (!packed_take(v, milli, num, take)) return 0;
  return packing_tiers(v, take);
}

__device__ __forceinline__ int affinity_class(int milli, int num) {
  if (num == 0) return -1;
  return (num == 1 && milli < kMilli) ? 0 : num;
}

// GpuClustering (_clustering_column :494; policies/clustering.py)
__device__ __forceinline__ int clustering_pair(const ReplayArgs& a,
                                               const NodeView& v, int k) {
  constexpr int q = kMaxNodeScore / 4;
  const int cls = affinity_class(a.t_milli[k], a.t_num[k]);
  if (cls < 0) return 0;
  int n_classes = 0;
#pragma unroll
  for (int c = 0; c < kAffClasses; ++c) n_classes += v.aff[c] > 0 ? 1 : 0;
  const bool has_cls = cls < kAffClasses && v.aff[cls] > 0;
  const int pack = floor_div(q * (kMaxSpecGpu - gpu_sum(v)), kMaxSpecGpu);
  const int base = has_cls ? (n_classes == 1 ? 3 * q : 2 * q)
                           : (n_classes == 0 ? q : 0);
  return base + pack;
}

// CPU watts of a node with `cpu_left` free (ops/energy.py cpu_power_watts)
__device__ __forceinline__ float cpu_watts(const ReplayArgs& a,
                                           const NodeView& v, int cpu_left) {
  const float ncores = a.cpu_ncores[v.ctyp];
  const float real = ceilf(__fmul_rn(static_cast<float>(v.cap), kRmilliHalf));
  const float idle = floorf(__fmul_rn(static_cast<float>(cpu_left), kRmilliHalf));
  const float num_cpus = ceilf(__fdiv_rn(real, ncores));
  const float active = ceilf(__fdiv_rn(__fsub_rn(real, idle), ncores));
  return __fadd_rn(__fmul_rn(a.cpu_idle_w[v.ctyp], __fsub_rn(num_cpus, active)),
                   __fmul_rn(a.cpu_full_w[v.ctyp], active));
}

// PWR's node-only figures: the node's watts now (old), its GPUs' watts
// (gpu_old) and one GPU's busy-over-idle delta
struct PwrNode {
  float old;
  float gpu_old;
  float busy;
};

__device__ __forceinline__ PwrNode pwr_node(const ReplayArgs& a,
                                            const NodeView& v) {
  const float gidle = v.gtyp >= 0 ? a.gpu_idle_w[v.gtyp] : 0.0f;
  const float gfull = v.gtyp >= 0 ? a.gpu_full_w[v.gtyp] : 0.0f;
  const float busy = v.gtyp >= 0 ? __fsub_rn(gfull, gidle) : 0.0f;
  const float n_idle = static_cast<float>(idle_count(v));
  const float gpu_old = __fadd_rn(
      __fmul_rn(gidle, n_idle),
      __fmul_rn(gfull, __fsub_rn(static_cast<float>(v.gcnt), n_idle)));
  return {__fadd_rn(cpu_watts(a, v, v.cpu), gpu_old), gpu_old, busy};
}

// PWR of a share pod of `milli`: device d flips iff it was fully idle and
// the pod takes milli; `base` is the node's watts after the pod's CPU
__device__ __forceinline__ void pwr_share(const NodeView& v, const PwrNode& w,
                                          float base, int milli, int* score,
                                          int* sdev) {
  int best = kPwrNeg;
  int best_dev = -1;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    if (v.g[d] >= milli) {
      const bool flip = v.g[d] == kMilli && milli > 0;
      const int s = to_i32(__fsub_rn(w.old, __fadd_rn(base, flip ? w.busy : 0.0f)));
      if (best_dev < 0 || s > best) {  // first device on ties
        best = s;
        best_dev = d;
      }
    }
  }
  *score = best;
  *sdev = best_dev;
}

// PWR of whole GPUs / CPU only: Sub's taken devices flip iff they were idle
__device__ __forceinline__ int pwr_whole(const NodeView& v, const PwrNode& w,
                                         float base, int num,
                                         const bool take[kDevs]) {
  int flips = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d)
    flips += (num > 0 && take[d] && v.g[d] == kMilli) ? 1 : 0;
  return to_i32(__fsub_rn(
      w.old, __fadd_rn(base, __fmul_rn(static_cast<float>(flips), w.busy))));
}

// PWR (_pwr_column :521; policies/pwr.py). Every watt figure is an
// integer held exactly in float32, so only the floor/ceil inputs round.
// The branch follows the type: one GPU under 1000 milli is a share pod.
__device__ void pwr_pair(const ReplayArgs& a, const NodeView& v, int k,
                         int* score, int* sdev) {
  const PwrNode w = pwr_node(a, v);
  const float base = __fadd_rn(cpu_watts(a, v, v.cpu - a.t_cpu[k]), w.gpu_old);
  const int milli = a.t_milli[k];
  const int num = a.t_num[k];
  if (num == 1 && milli < kMilli) {
    pwr_share(v, w, base, milli, score, sdev);
    return;
  }
  bool take[kDevs];
  packed_take(v, milli, num, take);
  *score = pwr_whole(v, w, base, num, take);
  *sdev = -1;
}

// XLA's float32 tanh: clamp, x * P(x^2) / Q(x^2) with each Horner step one
// fused multiply-add, and x itself where |x| < 0.0004
__device__ __forceinline__ float xla_tanh(float x) {
  const float xc = fminf(fmaxf(x, -7.99881172180175781f), 7.99881172180175781f);
  const float x2 = __fmul_rn(xc, xc);
  float p = -2.76076847742355e-16f;
  p = __fmaf_rn(x2, p, 2.00018790482477e-13f);
  p = __fmaf_rn(x2, p, -8.60467152213735e-11f);
  p = __fmaf_rn(x2, p, 5.12229709037114e-08f);
  p = __fmaf_rn(x2, p, 1.48572235717979e-05f);
  p = __fmaf_rn(x2, p, 6.37261928875436e-04f);
  p = __fmaf_rn(x2, p, 4.89352455891786e-03f);
  float q = 1.19825839466702e-06f;
  q = __fmaf_rn(x2, q, 1.18534705686654e-04f);
  q = __fmaf_rn(x2, q, 2.26843463243900e-03f);
  q = __fmaf_rn(x2, q, 4.89352518554385e-03f);
  const float r = __fdiv_rn(__fmul_rn(xc, p), q);
  return fabsf(x) < 0.0004f ? x : r;
}

// NormalizeVector: v / n, 0 where n <= 0
__device__ __forceinline__ float safe_div(float v, float n) {
  return n > 0.0f ? __fdiv_rn(v, n) : 0.0f;
}

// slot_cpu x tcpu + slot_gpu x treq, normalised, with the roundings of the
// compiled JAX table build (policies/dotprod.py _dot)
__device__ __forceinline__ float dot_terms(const ReplayArgs& a,
                                           const NodeView& v, float slot_cpu,
                                           float slot_gpu, float tcpu,
                                           float treq) {
  if (a.norm == kNormMax) {
    if (a.dim_ext == kMerge)
      return __fmaf_rn(__fdiv_rn(slot_gpu, 8000.0f), __fdiv_rn(treq, 8000.0f),
                       __fmul_rn(__fdiv_rn(slot_cpu, 128000.0f),
                                 __fdiv_rn(tcpu, 128000.0f)));
    const float kc = __fmul_rn(tcpu, kRRcpu);
    const float kg = __fmul_rn(treq, kRRgpu);
    if (a.dim_ext == kDivide)
      return __fmaf_rn(slot_cpu, kc, __fmul_rn(slot_gpu, kg));
    return __fmaf_rn(slot_gpu, kg, __fmul_rn(slot_cpu, kc));
  }
  const float div_cpu = a.norm == kNormNode ? static_cast<float>(v.cap) : tcpu;
  const float div_gpu =
      a.norm == kNormNode ? static_cast<float>(v.gcnt * kMilli) : treq;
  const float ca = safe_div(slot_cpu, div_cpu);
  const float cb = safe_div(tcpu, div_cpu);
  const float ga = safe_div(slot_gpu, div_gpu);
  const float gb = safe_div(treq, div_gpu);
  if (a.dim_ext == kMerge || a.dim_ext == kExtend)
    return __fmaf_rn(ga, gb, __fmul_rn(ca, cb));
  return __fmaf_rn(ca, cb, __fmul_rn(ga, gb));
}

// DotProduct's node-only figures: free GPU milli, idle devices and, under
// extend, the device groups
struct DotNode {
  int gsum;
  int idle;
  float n_groups;
};

__device__ __forceinline__ DotNode dot_node(const ReplayArgs& a,
                                            const NodeView& v) {
  DotNode n{gpu_sum(v), idle_count(v), 0.0f};
  if (a.dim_ext == kExtend) {
#pragma unroll
    for (int d = 0; d < kDevs; ++d)
      n.n_groups += (d < v.gcnt && v.g[d] > 0 && v.g[d] < kMilli) ? 1.0f : 0.0f;
    n.n_groups += n.idle > 0 ? 1.0f : 0.0f;
  }
  return n;
}

// DotProduct (_make_dotprod_column :578; policies/dotprod.py): the best of
// up to 9 slots (8 devices + the idle pool; one under merge), first on
// ties, from the node's figures `dn`
__device__ __forceinline__ void dotprod_score(const ReplayArgs& a,
                                              const NodeView& v,
                                              const DotNode& dn, int k,
                                              int* score, int* sdev) {
  const int tcpu_i = a.t_cpu[k];
  const int treq_i = a.t_milli[k] * a.t_num[k];
  const float tcpu = static_cast<float>(tcpu_i);
  const float treq = static_cast<float>(treq_i);
  const float cpu_f = static_cast<float>(v.cpu);
  const int gsum = dn.gsum;
  const int idle_cnt = dn.idle;
  const float n_groups = dn.n_groups;
  const bool cpu_fits = v.cpu >= tcpu_i;
  const int slots = a.dim_ext == kMerge ? 1 : kDevs + 1;
  float best = -INFINITY;
  int best_slot = -1;
  for (int s = 0; s < slots; ++s) {
    float slot_gpu;
    bool active;
    if (a.dim_ext == kMerge) {
      slot_gpu = static_cast<float>(gsum);
      active = true;
    } else if (s < kDevs) {
      slot_gpu = static_cast<float>(v.g[s]);
      active = a.dim_ext == kExtend
                   ? (s < v.gcnt && v.g[s] > 0 && v.g[s] < kMilli &&
                      slot_gpu >= treq)
                   : (treq_i < kMilli && s < v.gcnt && v.g[s] < kMilli &&
                      v.g[s] >= treq_i);
    } else {
      slot_gpu = static_cast<float>(idle_cnt * kMilli);
      active = a.dim_ext == kExtend ? (idle_cnt > 0 && slot_gpu >= treq)
                                    : treq_i <= idle_cnt * kMilli;
    }
    if (!(cpu_fits && active)) continue;
    const float slot_cpu =
        a.dim_ext == kDivide
            ? safe_div(__fmul_rn(cpu_f, slot_gpu), static_cast<float>(gsum))
            : cpu_f;
    float dot = dot_terms(a, v, slot_cpu, slot_gpu, tcpu, treq);
    dot = a.dim_ext == kExtend
              ? __fdiv_rn(dot, fmaxf(__fadd_rn(1.0f, n_groups), 1.0f))
              : __fmul_rn(dot, 0.5f);
    if (a.norm == kNormPod) dot = xla_tanh(__fmul_rn(dot, kRten));
    const float val = __fsub_rn(1.0f, dot);
    if (best_slot < 0 || val > best) {
      best = val;
      best_slot = s;
    }
  }
  if (best_slot < 0) {
    *score = 0;
    *sdev = -1;
    return;
  }
  *score = to_i32(__fmul_rn(static_cast<float>(kMaxNodeScore), best));
  if (a.dim_ext == kMerge) {
    *sdev = -1;
  } else if (best_slot < kDevs) {
    *sdev = best_slot;
  } else {  // the pool: the first idle device
    int first = -1;
    for (int d = kDevs - 1; d >= 0; --d)
      if (v.g[d] == kMilli) first = d;
    *sdev = first;
  }
}

__device__ void dotprod_pair(const ReplayArgs& a, const NodeView& v, int k,
                             int* score, int* sdev) {
  dotprod_score(a, v, dot_node(a, v), k, score, sdev);
}

// Filter-phase feasibility of a pod type (cpu, mem, m milli on num GPUs,
// model mask) on one node (_feas_column :739; step.filter_nodes without the
// per-event pin mask)
__device__ __forceinline__ int feas_of(const NodeView& v, int cpu, int mem,
                                       int m, int num, int mask) {
  const bool fit = v.cpu >= cpu && v.mem >= mem;
  int units = 0;
  if (m > 0) {
#pragma unroll
    for (int d = 0; d < kDevs; ++d) units += v.g[d] / m;
  }
  const bool acc = mask == 0 || (mask & v.bit) != 0;
  const bool gpu_ok = v.gcnt > 0 && acc && units >= num;
  const bool needs_gpu = m * num > 0;
  return (fit && (!needs_gpu || gpu_ok)) ? 1 : 0;
}

__device__ __forceinline__ int feas_pair(const ReplayArgs& a,
                                         const NodeView& v, int k) {
  return feas_of(v, a.t_cpu[k], a.t_mem[k], a.t_milli[k], a.t_num[k],
                 a.t_mask[k]);
}

// Simon's share(req, total) (algo/greed.go:78-91)
__device__ __forceinline__ float simon_share(float req, float total) {
  return total == 0.0f ? (req != 0.0f ? 1.0f : 0.0f) : __fdiv_rn(req, total);
}

// Simon (tpusim/policies/simon.py; policies/simon.py): from the node's
// capacity (cpu cap, `mem_cap`, GPU count) alone, round half to even of
// 100 x the largest share over milli-CPU, MiB and milli-GPU, in that order
__device__ __forceinline__ int simon_pair(const ReplayArgs& a,
                                          const NodeView& v, int mem_cap,
                                          int k) {
  const float cpu = static_cast<float>(a.t_cpu[k]);
  const float mem = static_cast<float>(a.t_mem[k]);
  const float gpu = static_cast<float>(a.t_milli[k] * a.t_num[k]);
  float res = fmaxf(0.0f, simon_share(
      cpu, __fsub_rn(static_cast<float>(v.cap), cpu)));
  res = fmaxf(res, simon_share(
      mem, __fsub_rn(static_cast<float>(mem_cap), mem)));
  res = fmaxf(res, simon_share(
      gpu, __fsub_rn(static_cast<float>(v.gcnt * kMilli), gpu)));
  return to_i32(rintf(__fmul_rn(static_cast<float>(kMaxNodeScore), res)));
}

// ---------------------------------------------------------------------------
// The learned features (learn/policy.py; tpusim/learn/policy.py :78-188):
// i32 in [0, 100] each, read by the kLearned instantiations only
// ---------------------------------------------------------------------------

// floor(100 * num / max(den, 1)) clipped to [0, 100], in wrapping int32
__device__ __forceinline__ int pct_of(int num, int den) {
  const int v = floor_div(static_cast<int>(static_cast<uint32_t>(num) * 100u),
                          max(den, 1));
  return min(max(v, 0), kMaxNodeScore);
}

// clip(floor(x), 0, 100) of a float32, as int
__device__ __forceinline__ int floor_pct(float x) {
  return static_cast<int>(fminf(fmaxf(floorf(x), 0.0f), 100.0f));
}

// XLA's tree sum over the `count` typical pods (ops/frag.py tree_sum): up
// to 32 of them added in order from 0; past that, windows of 32 over the
// pods padded by (32 - count % 32) % 32 zeros, half of them (rounded down)
// in front, each window added in order from 0, then the window sums
// likewise (in windows of 32 past 32 of them). add(acc, t) adds typical
// pod t's terms to acc in their order.
template <typename Add>
__device__ __forceinline__ float tp_tree_sum(int count, Add add) {
  const int pad1 = (32 - count % 32) % 32;
  const int nw = count <= 32 ? 1 : (count + pad1) / 32;
  const int lo1 = count <= 32 ? 0 : pad1 / 2;
  const int pad2 = (32 - nw % 32) % 32;
  const int ng = nw <= 32 ? 1 : (nw + pad2) / 32;
  const int lo2 = nw <= 32 ? 0 : pad2 / 2;
  const int wpg = nw <= 32 ? nw : 32;
  const int per = count <= 32 ? count : 32;
  float out = 0.0f;
  for (int g = 0; g < ng; ++g) {
    float grp = 0.0f;
    for (int wg = 0; wg < wpg; ++wg) {
      const int w = g * wpg + wg - lo2;
      if (w < 0 || w >= nw) continue;
      float win = 0.0f;
      for (int j = 0; j < per; ++j) {
        const int t = w * 32 + j - lo1;
        if (t >= 0 && t < count) win = add(win, t);
      }
      grp = __fadd_rn(grp, win);
    }
    out = __fadd_rn(out, grp);
  }
  return out;
}

// The eighteen node-only features of one node into f[kNodeFeatures], in
// learn/policy.py NODE_FEATURES order. q3_sat_pct and frag_pct sum over
// every typical pod where the caller keeps them (the zero-frequency rows
// count in the tree's windows): the frequency of those of frag class Q3;
// the node's frag contributions (ops/frag.py node_frag_contrib) over
// (typical pod, class), minus those of class Q3.
__device__ void node_features(const ReplayArgs& a, const NodeView& v,
                              int mem_cap, int* f) {
  const int gsum = gpu_sum(v);
  const int cap = v.gcnt * kMilli;
  int gmax = v.g[0];
#pragma unroll
  for (int d = 1; d < kDevs; ++d) gmax = max(gmax, v.g[d]);
  f[0] = pct_of(gsum, cap);
  f[1] = pct_of(max(v.cpu, 0), v.cap);
  f[2] = pct_of(max(v.mem, 0), mem_cap);
  f[3] = pct_of(idle_count(v), v.gcnt);
  f[4] = pct_of(gmax, kMilli);
  const float total = static_cast<float>(gsum);
  // per typical pod: its class on the node (ops/frag.py frag_class) and
  // the free milli of the devices too small for it
  auto cls_of = [&](int t, int* small) {
    const int milli = a.tp_milli[t];
    const int mask = a.tp_mask[t];
    const bool cpu_ok = v.cpu >= a.tp_cpu[t];
    *small = 0;
    if (milli == 0) return cpu_ok ? 4 : 5;
    if (!(mask == 0 || (mask & v.bit) != 0)) return 6;
    int fit = 0;
    int sm = 0;
#pragma unroll
    for (int d = 0; d < kDevs; ++d) {
      fit += v.g[d] >= milli ? 1 : 0;
      sm += v.g[d] < milli ? v.g[d] : 0;
    }
    *small = sm;
    return fit >= a.tp_num[t] ? (cpu_ok ? kQ3 : 3) : (cpu_ok ? kQ2 : 0);
  };
  const float sat = tp_tree_sum(a.t, [&](float acc, int t) {
    int sm;
    return cls_of(t, &sm) == kQ3 ? __fadd_rn(acc, a.tp_freq[t]) : acc;
  });
  const float all = tp_tree_sum(a.t, [&](float acc, int t) {
    int sm;
    const float fr = a.tp_freq[t];
    if (cls_of(t, &sm) != kQ3) return __fadd_rn(acc, __fmul_rn(fr, total));
    const float s = static_cast<float>(sm);
    acc = __fadd_rn(acc, __fmul_rn(fr, s));  // class Q2, then Q3
    return __fadd_rn(acc, __fmul_rn(fr, __fsub_rn(total, s)));
  });
  const float q3 = tp_tree_sum(a.t, [&](float acc, int t) {
    int sm;
    if (cls_of(t, &sm) != kQ3) return acc;
    return __fadd_rn(acc, __fmul_rn(a.tp_freq[t],
                                    __fsub_rn(total, static_cast<float>(sm))));
  });
  f[5] = floor_pct(__fmul_rn(sat, 100.0f));
  f[6] = floor_pct(__fdiv_rn(__fmul_rn(__fsub_rn(all, q3), 100.0f),
                             fmaxf(total, 1.0f)));
  const bool down = v.mem < 0;
  f[7] = down ? kMaxNodeScore : 0;
  const int bucket =
      min(max(floor_div((cap - gsum) * kUtilBuckets, max(cap, 1)), 0),
          kUtilBuckets - 1);
  const bool live = !down && v.gcnt > 0;
#pragma unroll
  for (int b = 0; b < kUtilBuckets; ++b)
    f[8 + b] = live && bucket == b ? kMaxNodeScore : 0;
}

// the node column's value on one node: sum over its features of theta x
// feature, in wrapping int32 (`mem_cap` the node's memory capacity)
__device__ __forceinline__ int learned_node_value(const ReplayArgs& a,
                                                  const NodeView& v,
                                                  int mem_cap) {
  int f[kNodeFeatures];
  node_features(a, v, mem_cap, f);
  uint32_t sum = 0;
  for (int j = 0; j < a.ln_n; ++j)
    sum += static_cast<uint32_t>(a.ln_theta[j]) *
           static_cast<uint32_t>(f[a.ln_feat[j]]);
  return static_cast<int>(sum);
}

// fit_dev_pct of type k on one node: its devices with max(milli, 1) free
// over the fixed width of 8 (pad devices hold 0); 0 for a CPU-only type
__device__ __forceinline__ int fit_dev_pair(const ReplayArgs& a,
                                            const NodeView& v, int k) {
  if (a.t_milli[k] * a.t_num[k] <= 0) return 0;
  const int need = max(a.t_milli[k], 1);
  int fits = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) fits += v.g[d] >= need ? 1 : 0;
  return pct_of(fits, kDevs);
}

// raw score and device pick of table policy `pi` (not RandomScore, which
// has no column) for type k on one node, `node`. <false> leaves Simon out,
// for an instantiation whose configurations lack it (replay_blocked's staged
// general kernel, whose registers that column would spill). <kLearned>
// adds the learned columns.
template <bool kAllColumns = true, bool kLearned = false>
__device__ void policy_pair(const ReplayArgs& a, const NodeView& v, int pi,
                            int k, int node, int* score, int* sdev) {
  *sdev = -1;
  if (kAllColumns && a.pol_column[pi] == kSimon) {
    *score = simon_pair(a, v, a.mem_cap[node], k);
    return;
  }
  if constexpr (kLearned) {
    if (a.pol_column[pi] == kFitDev) {
      *score = fit_dev_pair(a, v, k);
      return;
    }
    if (a.pol_column[pi] == kLearnedNode) {
      *score = learned_node_value(a, v, a.mem_cap[node]);
      return;
    }
  }
  switch (a.pol_column[pi]) {
    case kFgd:
      fgd_pair(a, v, k, score, sdev);
      break;
    case kBestFit:
      *score = bestfit_pair(a, v, k);
      break;
    case kPacking:
      *score = packing_pair(a, v, k);
      break;
    case kClustering:
      *score = clustering_pair(a, v, k);
      break;
    case kPwr:
      pwr_pair(a, v, k, score, sdev);
      break;
    case kDotProd:
    default:
      dotprod_pair(a, v, k, score, sdev);
      break;
  }
}

// One Threefry-2x32 round group: four rounds of add, rotate, xor
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1,
                                                int r0, int r1, int r2,
                                                int r3) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

// The Threefry-2x32 hash (20 rounds) of counters (x0, x1) under `key`, as
// jax.random computes it (jax/_src/prng.py _threefry2x32_lowering;
// tpusim_torch/ops/prng.py threefry2x32)
__device__ __forceinline__ uint2 threefry2x32(uint2 key, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = key.x ^ key.y ^ 0x1BD11BDAu;
  x0 += key.x;
  x1 += key.y;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += key.y;
  x1 += k2 + 1u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += key.x + 2u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += key.x;
  x1 += key.y + 3u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += key.y;
  x1 += k2 + 4u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += key.x + 5u;
  return make_uint2(x0, x1);
}

// The 23 bits of jax.random.uniform(key, (n,))[i] (partitionable counters:
// hi 0, lo i): the float is mantissa x 2^-23 exactly, so comparing
// mantissas compares the uniforms
__device__ __forceinline__ uint32_t uniform_mantissa(uint2 key, uint32_t i) {
  const uint2 y = threefry2x32(key, 0u, i);
  return (y.x ^ y.y) >> 9;
}

// selectHost candidate: max total, then min tie-break rank, then min node id
struct Best {
  int total;
  int rank;
  int node;
};

__device__ __forceinline__ Best no_candidate() { return {INT_MIN, INT_MAX, INT_MAX}; }

__device__ __forceinline__ bool beats(const Best& x, const Best& y) {
  if (x.total != y.total) return x.total > y.total;
  if (x.rank != y.rank) return x.rank < y.rank;
  return x.node < y.node;
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o = {__shfl_down_sync(0xffffffffu, b.total, off),
                    __shfl_down_sync(0xffffffffu, b.rank, off),
                    __shfl_down_sync(0xffffffffu, b.node, off)};
    if (beats(o, b)) b = o;
  }
  return b;
}

// Thread 0's phase clocks in the clocked build; no-ops in the main build.
// `acc` is a kNumClocks array in shared memory.
struct PhaseClock {
  long long* acc;
  long long last;

  __device__ void start(long long* s) {
    if constexpr (kClocked) {
      acc = s;
      if (threadIdx.x == 0) {
        for (int c = 0; c < kNumClocks; ++c) acc[c] = 0;
        last = clock64();
      }
      __syncthreads();
    }
  }
  // charge the cycles since the last mark to `slot`
  __device__ void mark(int slot) {
    if constexpr (kClocked) {
      if (threadIdx.x == 0) {
        const long long now = clock64();
        acc[slot] += now - last;
        last = now;
      }
    }
  }
  // add n to a count slot (any thread)
  __device__ void count(int slot, int n) {
    if constexpr (kClocked)
      atomicAdd(reinterpret_cast<unsigned long long*>(acc + slot),
                static_cast<unsigned long long>(n));
  }
  // the refresh's work: from `start` (this thread's clock before it) to
  // the last warp's end, noted in `end` by each warp's lane 0; call
  // finish_work after the refresh's barrier
  __device__ void end_work(long long* end) {
    if constexpr (kClocked)
      if ((threadIdx.x & 31) == 0)
        atomicMax(reinterpret_cast<unsigned long long*>(end),
                  static_cast<unsigned long long>(clock64()));
  }
  __device__ void finish_work(long long* end, long long start) {
    if constexpr (kClocked) {
      if (threadIdx.x == 0) {
        acc[kClkWork] += end[0] - start;
        if (end[1] != 0) {  // an FGD item noted them
          acc[kClkSetup] += end[1] - start;
          acc[kClkSum] += end[2] - start;
        }
        end[0] = end[1] = end[2] = 0;
      }
    }
  }
  // a block barrier; thread 0's wait inside it is charged to kClkWait
  __device__ void sync() {
    if constexpr (kClocked) {
      const long long t = clock64();
      __syncthreads();
      if (threadIdx.x == 0) acc[kClkWait] += clock64() - t;
    } else {
      __syncthreads();
    }
  }
  // the loop's total cycles since `t0`, then every slot out to `out`
  __device__ void finish(long long* out, long long t0) {
    if constexpr (kClocked) {
      if (threadIdx.x == 0 && out != nullptr) {
        acc[kClkLoop] = clock64() - t0;
        for (int c = 0; c < kNumClocks; ++c) out[c] = acc[c];
      }
    }
  }
};

// the clocked build's checkpoint: this warp's clock, if later than `mark`
__device__ __forceinline__ void note(long long* mark) {
  if constexpr (kClocked)
    if ((threadIdx.x & 31) == 0)
      atomicMax(reinterpret_cast<unsigned long long*>(mark),
                static_cast<unsigned long long>(clock64()));
}

__device__ __forceinline__ long long clock_now() {
  if constexpr (kClocked) return clock64();
  return 0;
}

// minmax/pwr NormalizeScore of one feasible raw score against the row's
// feasible extrema, in XLA's wrapping int32 (policies/base.py)
__device__ __forceinline__ int normalize(int raw, int lo, int hi, int mode) {
  const int rng = static_cast<int>(static_cast<uint32_t>(hi) -
                                   static_cast<uint32_t>(lo));
  if (rng == 0) return mode == kNormMinMax ? 0 : kMaxNodeScore;
  const int num = static_cast<int>(
      (static_cast<uint32_t>(raw) - static_cast<uint32_t>(lo)) *
      static_cast<uint32_t>(kMaxNodeScore));
  return floor_div(num, max(rng, 1));
}

// ---------------------------------------------------------------------------
// What the replay kernels keep in shared memory
// ---------------------------------------------------------------------------

// one event's fields, staged kEvBatch events at a time
struct EventFields {
  int kind;
  int pod;
  int type;
  int pin;
  int cpu;
  int mem;
  int milli;
  int num;
};

// The dynamic shared memory of the replay kernels (carve() lays it out).
// Staged once per launch: the typical pods (tq's m and c, ts's freq,
// tp_num, tp_mask) and the type fields t_*. Rewritten per event, for the
// dirty node: tq's num (kNever where typical pod t cannot be Q3 on the
// node: no GPU request, or a model mask it fails) and fit count, ts's fit
// sum, and term[t] = freq x t's current frag term. replay_blocked only:
// the dirty column's old and new raw scores ([n_pol, K]) and Filter bits
// ([K]), and the types whose block summary must be rescanned.
struct Smem {
  int4* tq;  // m, num, c, fitcnt
  int2* ts;  // fitsum, freq (bits)
  float* term;
  int* tp_num;
  int* tp_mask;
  int* t_cpu;
  int* t_mem;
  int* t_milli;
  int* t_num;
  int* t_mask;
  int* old_raw;
  int* new_raw;
  int* old_feas;
  int* new_feas;
  int* rescan;
};

constexpr int kNever = 1 << 30;  // a fit count no node reaches

struct Carver {
  unsigned char* base;
  size_t off;
  template <typename T>
  __host__ __device__ T* take(long long count) {
    T* p = base != nullptr ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (static_cast<size_t>(count) * sizeof(T) + 15) / 16 * 16;
    return p;
  }
};

// Lays the arrays out from `base` (nullptr: sizes only); returns the bytes.
__host__ __device__ inline size_t carve(unsigned char* base, int k, int t,
                                        int n_pol, bool blocked, Smem* m) {
  Carver c{base, 0};
  Smem s;
  s.tq = c.take<int4>(t);
  s.ts = c.take<int2>(t);
  s.term = c.take<float>(t);
  s.tp_num = c.take<int>(t);
  s.tp_mask = c.take<int>(t);
  s.t_cpu = c.take<int>(k);
  s.t_mem = c.take<int>(k);
  s.t_milli = c.take<int>(k);
  s.t_num = c.take<int>(k);
  s.t_mask = c.take<int>(k);
  const int kb = blocked ? k : 0;
  s.old_raw = c.take<int>(static_cast<long long>(n_pol) * kb);
  s.new_raw = c.take<int>(static_cast<long long>(n_pol) * kb);
  s.old_feas = c.take<int>(kb);
  s.new_feas = c.take<int>(kb);
  s.rescan = c.take<int>(kb);
  if (m != nullptr) *m = s;
  return c.off;
}

// Stages the type fields (<true>; the global form reads them where the
// caller keeps them, point_types), and the typical pods whose frequency is
// not 0, in order (their count to *t_count): a pod of frequency 0 adds a
// zero to each frag sum, which leaves the sum (>= 0) as it is.
template <bool kStaged = true>
__device__ void stage(const ReplayArgs& a, const Smem& m, int* t_count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int kept = 0;
    for (int base = 0; base < a.t; base += 32) {
      const int t = base + lane;
      const bool keep = t < a.t && a.tp_freq[t] != 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int at = kept + __popc(mask & ((1u << lane) - 1));
        m.tq[at] = make_int4(a.tp_milli[t], kNever, a.tp_cpu[t], 0);
        m.ts[at] = make_int2(0, __float_as_int(a.tp_freq[t]));
        m.tp_num[at] = a.tp_num[t];
        m.tp_mask[at] = a.tp_mask[t];
      }
      kept += __popc(mask);
    }
    if (lane == 0) *t_count = kept;
  }
  if (!kStaged) return;
  for (int k = threadIdx.x; k < a.k; k += blockDim.x) {
    m.t_cpu[k] = a.t_cpu[k];
    m.t_mem[k] = a.t_mem[k];
    m.t_milli[k] = a.t_milli[k];
    m.t_num[k] = a.t_num[k];
    m.t_mask[k] = a.t_mask[k];
  }
}

// The replays' arrays: in shared memory (<true>), or in the scratch buffer
// with the type fields read where the caller keeps them (the global form)
template <bool kStaged>
__device__ __forceinline__ Smem replay_smem(const ReplayArgs& a,
                                            unsigned char* smem, int n_pol,
                                            bool blocked) {
  Smem m;
  carve(kStaged ? smem : static_cast<unsigned char*>(a.scratch), a.k, a.t,
        n_pol, blocked, &m);
  if (!kStaged) {
    m.t_cpu = const_cast<int*>(a.t_cpu);
    m.t_mem = const_cast<int*>(a.t_mem);
    m.t_milli = const_cast<int*>(a.t_milli);
    m.t_num = const_cast<int*>(a.t_num);
    m.t_mask = const_cast<int*>(a.t_mask);
  }
  return m;
}

// events first .. first + 31 into `out`, one lane each (one warp)
__device__ void load_events(const ReplayArgs& a, int first, EventFields* out,
                            int lane) {
  const int i = first + lane;
  if (i >= a.e) return;
  EventFields f;
  f.kind = a.ev_kind[i];
  f.pod = a.ev_pod[i];
  f.type = a.p_type[f.pod];
  f.pin = a.p_pinned[f.pod];
  f.cpu = a.p_cpu[f.pod];
  f.mem = a.p_mem[f.pod];
  f.milli = a.p_milli[f.pod];
  f.num = a.p_num[f.pod];
  out[lane] = f;
}

// Lanes of FGD's share items: one per (share type, distinct device value)
// (`group` values, see EventState), in whole warps.
__device__ __forceinline__ int share_lanes(int group, int ks) {
  return (group * ks + 31) / 32 * 32;
}

// The column-refresh work items, one lane each, per policy a segment
// starting at a whole warp: FGD's share items (share_lanes) then one per
// whole type, every other policy's one per type. seg[pi] is policy pi's
// first item and seg[n_pol] their end. <true> (the randomized replay) gives
// RandomScore, which has no table rows, no items, unless it is policy 0
// (alone), whose items write the Filter bits.
template <bool kDraws = false>
__device__ void layout_items(const ReplayArgs& a, int n_pol, int group,
                             int* seg) {
  int off = 0;
  for (int pi = 0; pi < n_pol; ++pi) {
    seg[pi] = off;
    const int len = kDraws && pi > 0 && a.pol_column[pi] == kRandomScore
                        ? 0
                        : a.pol_column[pi] == kFgd
                        ? share_lanes(group, a.ks) + (a.k - a.ks)
                        : a.k;
    off += (len + 31) / 32 * 32;
  }
  seg[n_pol] = off;
}

// ---------------------------------------------------------------------------
// The column refresh, spread over the block
// ---------------------------------------------------------------------------

// What the replay kernels keep per event in static shared memory: the
// event batches, the node the previous event changed (by event parity, so
// that event i reads its slot while event i's commit writes the next), that
// node's state, FGD's node-only results (node_terms), and the refresh's
// item layout.
struct EventState {
  EventFields ev[2][kEvBatch];
  int dirty[2];
  NodeView node;
  float cur;   // the node's current frag
  int gsum;    // its free GPU milli
  // the distinct free milli of its devices that some share type fits, in
  // device order, each with the first device that has it
  int uval[kDevs];
  int ufirst[kDevs];
  int nv;
  // its devices least free first, ties by index: Sub's order (packed_take)
  int order[kDevs];
  int group;   // lanes per share type: nv rounded up to a power of 2
  int min_p;   // the least milli a share type requests
  int t_count;  // the staged typical pods
  int seg[kMaxPolicies + 1];
  // the randomized replay's key chain: the chain's key after the events
  // drawn so far, and each event's k_rand and k_sel, by event parity
  uint2 key;
  uint2 krand[2];
  uint2 ksel[2];
};

// One step of the event key chain (table_engine.py:1048-1049): key, sub =
// split(key); k_rand, k_sel = split(sub), split being the partitionable
// form (threefry2x32 of counters (0, 0) and (0, 1)). Stores the step's
// k_rand and k_sel in slot `slot` and the next key (next_key) in es.key.
// One thread.
__device__ __forceinline__ uint2 next_key(uint2 key) {
  return threefry2x32(key, 0u, 0u);
}

__device__ __forceinline__ void advance_keys(EventState& es, uint2 key,
                                             int slot) {
  const uint2 sub = threefry2x32(key, 0u, 1u);
  es.key = next_key(key);
  es.krand[slot] = threefry2x32(sub, 0u, 0u);
  es.ksel[slot] = threefry2x32(sub, 0u, 1u);
}

// FGD's node-only work on the dirty node es.node, by one warp: per typical
// pod its fit count and sum over the node's devices and whether it can be
// Q3 there (into tq/ts), the node's current frag `cur`, summed in index
// order as fgd_pair sums it, and its distinct device values (a share
// type's hypothetical frag depends on the device only through its free
// milli, so devices with equal values score equal, and the first of them
// is fgd_pair's pick on a tie), its devices in Sub's order, then the item
// layout for them (layout_items<kDraws>). The type-dependent rest is
// share_term and whole_term.
template <bool kDraws = false>
__device__ void node_terms(const ReplayArgs& a, const Smem& m, EventState& es,
                           int n_pol, int lane) {
  const NodeView& v = es.node;
  const int gsum = gpu_sum(v);
  const float total = static_cast<float>(gsum);
  for (int t = lane; t < es.t_count; t += 32) {
    int4 q = m.tq[t];
    const bool gpu_pod = q.x > 0;
    const int mask = m.tp_mask[t];
    const bool acc = mask == 0 || (mask & v.bit) != 0;
    int fitcnt = 0;
    int fitsum = 0;
#pragma unroll
    for (int d = 0; d < kDevs; ++d) {
      if (gpu_pod && v.g[d] >= q.x) {
        ++fitcnt;
        fitsum += v.g[d];
      }
    }
    const int num = m.tp_num[t];
    const bool qa = gpu_pod && acc;
    q.y = qa ? num : kNever;
    q.w = fitcnt;
    m.tq[t] = q;
    const int2 sf = m.ts[t];
    m.ts[t] = make_int2(fitsum, sf.y);
    const bool q3 = qa && fitcnt >= num && v.cpu >= q.z;
    m.term[t] = __fmul_rn(__int_as_float(sf.y),
                          q3 ? static_cast<float>(gsum - fitsum) : total);
  }
  // lane d < 8 keeps device d where it is the first with its value and
  // some share type fits it
  constexpr unsigned kLanes = (1u << kDevs) - 1;
  if (lane < kDevs) {
    const int gd = v.g[lane];
    int rank = 0;
#pragma unroll
    for (int e = 0; e < kDevs; ++e)
      rank += (v.g[e] < gd || (v.g[e] == gd && e < lane)) ? 1 : 0;
    es.order[rank] = lane;
    const unsigned same = __match_any_sync(kLanes, gd);
    const bool keep = (__ffs(same) - 1 == lane) && gd >= es.min_p;
    const unsigned kept = __ballot_sync(kLanes, keep);
    const int nv = __popc(kept);
    if (keep) {
      const int at = __popc(kept & ((1u << lane) - 1));
      es.uval[at] = gd;
      es.ufirst[at] = lane;
    }
    if (lane == 1) {
      int group = 1;
      while (group < nv) group <<= 1;
      es.nv = nv;
      es.group = group;
      layout_items<kDraws>(a, n_pol, group, es.seg);
    }
  }
  __syncwarp();
  if (lane == 0) {
    float c = 0.0f;
#pragma unroll 8
    for (int t = 0; t < es.t_count; ++t) c = __fadd_rn(c, m.term[t]);
    es.cur = c;
    es.gsum = gsum;
  }
}

// An FGD item's hypothetical frag, sum_t freq_t x term_t, added in index
// order as fgd_pair adds it. `term(t)` is freq_t x term_t. The terms are
// computed kRound at a time in straight-line code (each at a valid index)
// before any is added, so that the compiler overlaps them; those past
// t_count are not added.
template <typename Term>
__device__ __forceinline__ float frag_sum(int t_count, Term term) {
  float acc = 0.0f;
  for (int base = 0; base < t_count; base += kRound) {
    float v[kRound];
#pragma unroll
    for (int j = 0; j < kRound; ++j) v[j] = term(min(base + j, t_count - 1));
#pragma unroll
    for (int j = 0; j < kRound; ++j)
      if (base + j < t_count) acc = __fadd_rn(acc, v[j]);
  }
  return acc;
}

// fgd_pair's term of typical pod t for a share type of p milli placed on a
// device with gd free, on the node of the staged terms (gsum its free GPU
// milli, cpu_h its cpu left after the pod)
__device__ __forceinline__ float share_term(const Smem& m, int t, int gd,
                                            int p, int gsum, int cpu_h) {
  const int4 q = m.tq[t];
  const int2 sf = m.ts[t];
  const int gdp = gd - p;
  const bool fit = gd >= q.x;
  const bool fitp = gdp >= q.x;
  const int cnt = q.w - (fit ? 1 : 0) + (fitp ? 1 : 0);
  const int sum = sf.x - (fit ? gd : 0) + (fitp ? gdp : 0);
  const bool q3 = cnt >= q.y && cpu_h >= q.z;
  return __fmul_rn(__int_as_float(sf.y),
                   static_cast<float>(q3 ? gsum - p - sum : gsum - p));
}

// a node's free GPU milli per device
struct Devs {
  int g[kDevs];
};

// fgd_pair's term of typical pod t for a whole-GPU or CPU-only type whose
// Sub takes ntk devices that all had v free, leaving them at v2 (g2sum in
// all on the node) and the node's cpu at cpu_w: the node's fit count and sum
// of t (staged) change only on the taken devices
__device__ __forceinline__ float whole_term_same(const Smem& m, int t, int ntk,
                                                 int v, int v2, int g2sum,
                                                 int cpu_w) {
  const int4 q = m.tq[t];
  const int2 sf = m.ts[t];
  const int cnt = q.w + ntk * ((v2 >= q.x ? 1 : 0) - (v >= q.x ? 1 : 0));
  const int sum = sf.x + ntk * ((v2 >= q.x ? v2 : 0) - (v >= q.x ? v : 0));
  const bool q3 = cnt >= q.y && cpu_w >= q.z;
  return __fmul_rn(__int_as_float(sf.y),
                   static_cast<float>(q3 ? g2sum - sum : g2sum));
}

// the same where the taken devices had different free milli: Sub leaves
// the node's devices at g2
__device__ __forceinline__ float whole_term(const Smem& m, int t, Devs g2,
                                            int g2sum, int cpu_w) {
  const int4 q = m.tq[t];
  const int2 sf = m.ts[t];
  int cnt = 0;
  int sum = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    if (g2.g[d] >= q.x) {
      ++cnt;
      sum += g2.g[d];
    }
  }
  const bool q3 = cnt >= q.y && cpu_w >= q.z;
  return __fmul_rn(__int_as_float(sf.y),
                   static_cast<float>(q3 ? g2sum - sum : g2sum));
}

// Refresh `node`'s column of every table with the whole block: each thread
// takes work items (layout_items) in rounds of blockDim. FGD's share items
// each sum one distinct device value's hypothetical frag (frag_sum), and
// the best of a type's group of lanes is picked with shuffles (the first
// device on ties); a whole type's item sums its Sub's. Every other policy's
// item scores one type. The type's first item of each policy writes the raw
// score, the selector's device pick, and for policy 0 the Filter bit; with
// kBlocked it also records the old and new values for update_summaries.
// With kDraws (the randomized replay) a RandomScore item writes the Filter
// bit and the device pick only: it has no table row. es holds the dirty
// node and node_terms' results; `marks` are the clocked build's
// checkpoints. kLearned adds the learned columns (policy_pair).
template <bool kGeneral, bool kBlocked, bool kAllColumns = true,
          bool kDraws = false, bool kLearned = false>
__device__ void refresh_column(const ReplayArgs& a, const Smem& m,
                               const EventState& es, int node,
                               long long* marks) {
  const int k_count = a.k;
  const int ks = a.ks;
  const int n_pol = kGeneral ? a.n_pol : 1;
  const int* seg = es.seg;
  const int items = seg[n_pol];
  const NodeView& sv = es.node;
  const int group = es.group;
  const int lg = __ffs(group) - 1;
  for (int base = 0; base < items; base += blockDim.x) {
    const int w = base + threadIdx.x;
    int pi = 0;
    if (kGeneral)
      while (pi + 1 < n_pol && w >= seg[pi + 1]) ++pi;
    const int j = w - seg[pi];
    const bool fgd = !kGeneral || a.pol_column[pi] == kFgd;  // warp-uniform
    const bool draw = kDraws && a.pol_column[pi] == kRandomScore;
    const int share_end = share_lanes(group, ks);
    const bool share = fgd && j < share_end;  // warp-uniform
    const int u = j & (group - 1);
    const int k = !fgd ? j : (share ? j >> lg : ks + j - share_end);
    const bool active = share ? j < group * ks : k < k_count;
    const bool primary = active && (!share || u == 0);
    const size_t col = (static_cast<size_t>(pi) * k_count + k) * a.n + node;
    const size_t at = static_cast<size_t>(k) * a.n + node;
    int old_raw = 0;
    int old_feas = 0;
    if (kBlocked && primary) {  // loaded first, used last
      old_raw = a.score[col];
      if (pi == 0) old_feas = a.feas[at];
    }
    int score = 0;
    int dev = -1;
    if (fgd) {
      const int kk = active ? k : 0;
      const int p = m.t_milli[kk];
      const int cpu_h = sv.cpu - m.t_cpu[kk];
      int key = 0;
      if (share) {  // a lane per distinct device value
        const bool real = active && u < es.nv;
        const int gd = real ? es.uval[u] : 0;
        const int gsum = es.gsum;
        note(marks + 1);
        const float nw = frag_sum(es.t_count, [=](int t) {
          return share_term(m, t, gd, p, gsum, cpu_h);
        });
        note(marks + 2);
        if (real) {
          const int s = gd >= p ? sigmoid_score(es.cur, nw) : -1;
          key = ((s + 1) << 3) | (kDevs - 1 - es.ufirst[u]);
        }
      } else {  // the node's devices after Sub's pick (packed_take)
        const int wn = active ? m.t_num[kk] : 0;
        unsigned taken = 0;
        int ntk = 0;
        int lo = INT_MAX;
        int hi = INT_MIN;
#pragma unroll
        for (int r = 0; r < kDevs; ++r) {
          const int d = es.order[r];
          const int gd = sv.g[d];
          const bool take = p > 0 && gd >= p && ntk < wn;
          taken |= take ? 1u << d : 0u;
          ntk += take ? 1 : 0;
          lo = take ? min(lo, gd) : lo;
          hi = take ? max(hi, gd) : hi;
        }
        Devs g2;
        int g2sum = 0;
#pragma unroll
        for (int d = 0; d < kDevs; ++d) {
          g2.g[d] = sv.g[d] - ((taken >> d) & 1 ? p : 0);
          g2sum += g2.g[d];
        }
        // whole GPUs are taken only where idle, so the taken devices mostly
        // had one value; the warp takes the shorter term where all its
        // lanes can (a branch the whole warp follows)
        const int vt = ntk == 0 ? 0 : lo;
        note(marks + 1);
        float nw;
        if (__all_sync(0xffffffffu, ntk == 0 || lo == hi)) {
          nw = frag_sum(es.t_count, [=](int t) {
            return whole_term_same(m, t, ntk, vt, vt - p, g2sum, cpu_h);
          });
        } else {
          nw = frag_sum(es.t_count, [=](int t) {
            return whole_term(m, t, g2, g2sum, cpu_h);
          });
        }
        note(marks + 2);
        score = sigmoid_score(es.cur, nw);
      }
      // max over the type's lanes: the best score, then the lowest device
      // (a type without a fitting device keeps key < 8)
      for (int off = 1; off < group; off <<= 1)
        key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
      if (share) {
        const int best = (key >> 3) - 1;
        score = best >= 0 ? best : 0;
        dev = best >= 0 ? kDevs - 1 - (key & (kDevs - 1)) : -1;
      }
    } else if (active && !draw) {
      const NodeView v = sv;
      policy_pair<kAllColumns, kLearned>(a, v, pi, k, node, &score, &dev);
    }
    if (!primary) continue;
    if (!draw) a.score[col] = score;
    if (pi == a.sel) {
      a.sdev[at] = dev;
    } else if (pi == 0 && a.sel < 0) {
      a.sdev[at] = -1;
    }
    if (pi == 0) {
      const int f = feas_of(sv, m.t_cpu[k], m.t_mem[k], m.t_milli[k],
                            m.t_num[k], m.t_mask[k]);
      a.feas[at] = f;
      if (kBlocked) {
        m.old_feas[k] = old_feas;
        m.new_feas[k] = f;
      }
    }
    if (kBlocked) {
      m.old_raw[pi * k_count + k] = old_raw;
      m.new_raw[pi * k_count + k] = score;
    }
  }
}

// Reserve + Bind of create event i on `node` (-1 = no feasible node);
// step.choose_devices / select_and_bind, pallas_engine.py:982-1064. The
// node's new state also goes to `sn`, and *dirty to the node it changed
// (-1 if none). <kRandomized> adds gpu_sel random, drawing from `ksel`;
// in the fault forms a `retry` (a popped retry slot's create) ORs its
// rejection into the pod's ever-failed flag instead of overwriting it.
template <bool kRandomized, bool kFaults = false>
__device__ void commit_create(const ReplayArgs& a, int i,
                              const EventFields& ev, int node, int gpu_sel,
                              int* dirty, NodeView* sn, uint2 ksel,
                              bool retry = false) {
  const bool ok = node >= 0;
  const int pm = ev.milli;
  const int pn = ev.num;
  int bits = 0;
  NodeView v;
  if (ok) v = load_node(a, node);
  if (ok && pm * pn > 0) {
    if (pn == 1 && pm < kMilli) {
      // share-GPU pod: tightest fit (or loosest for worst), first index;
      // a self-select policy's own pick wins where it has one
      int dev = -1;
      int key = 0;
      if (kRandomized && gpu_sel == kSelRandom) {
        // the fitting device of the largest uniform(k_sel, (8,)), the first
        // on ties (resource.allocate_share_random)
        uint32_t best = 0;
        for (int d = 0; d < kDevs; ++d) {
          if (v.g[d] < pm) continue;
          const uint32_t u = uniform_mantissa(ksel, d) + 1u;
          if (u > best) {
            best = u;
            dev = d;
          }
        }
      } else {
        for (int d = 0; d < kDevs; ++d) {
          if (v.g[d] < pm) continue;
          const bool better =
              gpu_sel == kSelWorst ? v.g[d] > key : v.g[d] < key;
          if (dev < 0 || better) {
            key = v.g[d];
            dev = d;
          }
        }
      }
      if (gpu_sel == kSelSelf) {
        const int s = a.sdev[static_cast<size_t>(ev.type) * a.n + node];
        if (s >= 0) dev = s;
      }
      bits = dev >= 0 ? (1 << dev) : 0;
    } else {
      // two-pointer pack in device-index order (gpunodeinfo.go:182-201)
      int prev = 0;
      for (int d = 0; d < kDevs; ++d) {
        const int units = v.g[d] / pm;
        const int take = min(max(pn - prev, 0), units);
        if (take > 0) bits |= 1 << d;
        prev += units;
      }
    }
  }
  if (ok) {
    v.cpu -= ev.cpu;
    v.mem -= ev.mem;
    a.cpu_left[node] = v.cpu;
    a.mem_left[node] = v.mem;
    for (int d = 0; d < kDevs; ++d) {
      if ((bits >> d) & 1) {
        v.g[d] -= pm;
        a.gpu_left[node * kDevs + d] = v.g[d];
      }
    }
    const int cls = affinity_class(pm, pn);
#pragma unroll
    for (int c = 0; c < kAffClasses; ++c) {  // constant indices: registers
      if (c == cls) {
        v.aff[c] += 1;
        a.aff_cnt[node * kAffClasses + c] = v.aff[c];
      }
    }
    *sn = v;
  }
  a.placed[ev.pod] = ok ? node : -1;
  a.maskb[ev.pod] = bits;
  a.failed[ev.pod] = ok ? (kFaults && retry ? a.failed[ev.pod] : 0) : 1;
  a.ev_node[i] = ok ? node : -1;
  a.ev_devb[i] = bits;
  *dirty = ok ? node : -1;
}

// Delete event i: return the pod's resources to the devices it held
// (step.unschedule, pallas_engine.py:1068-1103); `sn` and *dirty as above
__device__ void commit_delete(const ReplayArgs& a, int i,
                              const EventFields& ev, int* dirty,
                              NodeView* sn) {
  const int node = a.placed[ev.pod];
  const int bits = a.maskb[ev.pod];
  if (node >= 0) {
    NodeView v = load_node(a, node);
    v.cpu += ev.cpu;
    v.mem += ev.mem;
    a.cpu_left[node] = v.cpu;
    a.mem_left[node] = v.mem;
    for (int d = 0; d < kDevs; ++d) {
      if ((bits >> d) & 1) {
        v.g[d] += ev.milli;
        a.gpu_left[node * kDevs + d] = v.g[d];
      }
    }
    const int cls = affinity_class(ev.milli, ev.num);
#pragma unroll
    for (int c = 0; c < kAffClasses; ++c) {  // constant indices: registers
      if (c == cls) {
        v.aff[c] -= 1;
        a.aff_cnt[node * kAffClasses + c] = v.aff[c];
      }
    }
    *sn = v;
  }
  a.placed[ev.pod] = -1;
  a.maskb[ev.pod] = 0;
  a.ev_node[i] = node;
  a.ev_devb[i] = bits;
  *dirty = node >= 0 ? node : -1;
}

// ---------------------------------------------------------------------------
// The fault forms: the in-scan fault lane's steps (fault_lane.py
// apply_fault_step, pop_retry, commit_retry; table_engine.py's fault body
// :963-993 and :1189-1221), run by warp 0 where it commits, lane 0 writing
// ---------------------------------------------------------------------------

// one merged step's fault fields, staged beside its EventFields
struct FaultFields {
  int pos;
  int arg;
  int aux;
};

// The fault forms' static shared memory: the staged fault fields, and per
// step parity the pod its retry slot popped (-1: none, or not a slot). A
// retry slot is popped at the end of the step before it (pop_ahead), which
// rewrites its staged event into the popped pod's create or a skip, so
// that the step then runs as any create.
struct FaultShared {
  FaultFields ff[2][kEvBatch];
  int popped[2];
};

// the fault fields of steps first .. first + 31, one lane each (one warp)
__device__ void load_fault_fields(const ReplayArgs& a, int first,
                                  FaultFields* out, int lane) {
  const int i = first + lane;
  if (i >= a.e) return;
  out[lane] = {a.f_pos[i], a.f_arg[i], a.f_aux[i]};
}

// min(base * 2^(att-1), cap) with the shift clamped below 2^30, in the
// float32 log2 of fault_lane.backoff_of
__device__ __forceinline__ int backoff_of(int att, int base, int cap) {
  int s = max(att - 1, 0);
  const int lb = static_cast<int>(floorf(log2f(static_cast<float>(max(base, 1)))));
  s = min(s, max(29 - lb, 0));
  return min(static_cast<int>(static_cast<uint32_t>(base) << s), cap);
}

// The lowest free queue slot, -1 when the queue is full (warp-uniform).
__device__ int free_slot(const ReplayArgs& a, int lane) {
  for (int base = 0; base < a.f_cap_r; base += 32) {
    const int q = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, q < a.f_cap_r && a.q_pod[q] < 0);
    if (m != 0) return base + __ffs(m) - 1;
  }
  return -1;
}

// Push pod v at attempt `att` into the queue (RetryQueue.push): ready at
// pos + backoff, the next sequence number, round `era`. An attempt past
// max_retries, or a full queue, pushes nothing. Lane 0 writes; returns
// whether it pushed (warp-uniform). Pushes in ascending pod order fill the
// free slots in index order, as _queue_push_mask's free_order does.
__device__ bool queue_push(const ReplayArgs& a, int lane, int v, int att,
                           int pos, int era) {
  const int slot = att > a.f_maxr ? -1 : free_slot(a, lane);
  if (lane == 0 && slot >= 0) {
    a.q_pod[slot] = v;
    a.q_att[slot] = att;
    a.q_ready[slot] = pos + backoff_of(att, a.f_base, a.f_cap);
    a.q_seq[slot] = a.f_seq[0];
    a.q_era[slot] = era;
    a.f_seq[0] += 1;
  }
  __syncwarp();
  return slot >= 0;
}

// Evict pod v at `pos` into the queue (_evict_into_queue for one pod):
// attempts + 1, the eviction position, push or dead (a pod dead at its
// eviction is ever-failed), the counters; the pod is unbound.
__device__ void evict_pod(const ReplayArgs& a, int lane, int v, int pos) {
  const int att = a.f_attempts[v] + 1;
  const bool pushed = queue_push(a, lane, v, att, pos, 0);
  if (lane == 0) {
    a.f_attempts[v] = att;
    a.f_evicted_at[v] = pos;
    a.f_dctr[kDEvicted] += 1;
    if (pushed) {
      a.f_dctr[kDRetriesEnq] += 1;
    } else {
      a.f_dead[v] = 1;
      a.failed[v] = 1;
      a.f_dctr[kDDead] += 1;
    }
    a.placed[v] = -1;
    a.maskb[v] = 0;
  }
  __syncwarp();
}

// EV_NODE_FAIL / EV_NODE_RECOVER / EV_EVICT at step i (apply_fault_step),
// by one warp: the decision from the committed bookkeeping, the snapshot
// before an applied recover, the node's reset (fail: the down marker,
// mem_left -1; recover: empty), a failure's pods requeued in ascending pod
// order, an eviction's resources returned and its pod requeued, the down
// clock and the counters, the step's outputs. The step touches one node
// (the reset one, or the victim's), which becomes *next and es.node: the
// next step refreshes its column as after any event.
__device__ void fault_step(const ReplayArgs& a, EventState& es, int i,
                           int kind, FaultFields f, int* next, int lane) {
  const int node = min(max(f.arg, 0), a.n - 1);
  const int down = a.f_down_at[node];
  const bool do_fail = kind == kNodeFail && down < 0;
  const bool do_rec = kind == kNodeRecover && down >= 0;
  int victim = -1;
  if (kind == kEvict) {
    if (f.arg >= 0) {
      const int v = min(f.arg, a.p - 1);
      if (a.placed[v] >= 0) victim = v;
    } else if (f.aux >= 0) {
      // the draw for the count of placed pods, then that placed pod in
      // index order (pick_eviction_victim's candidates[draw])
      int size = 0;
      for (int q = lane; q < a.p; q += 32) size += a.placed[q] >= 0 ? 1 : 0;
      size = __reduce_add_sync(0xffffffffu, size);
      const int row = min(f.aux, a.f_rows - 1);
      const int j = a.f_draws[static_cast<size_t>(row) * a.f_cols +
                              min(size, a.f_cols - 1)];
      int before = 0;
      for (int base = 0; j >= 0 && base < a.p; base += 32) {
        const int q = base + lane;
        const bool ok = q < a.p && a.placed[q] >= 0;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        const int rank = before + __popc(m & ((1u << lane) - 1));
        const unsigned hit = __ballot_sync(0xffffffffu, ok && rank == j);
        if (hit != 0) {
          victim = base + __ffs(hit) - 1;
          break;
        }
        before += __popc(m);
      }
    }
  }
  const int vnode = victim >= 0 ? a.placed[victim] : -1;
  const int pos = f.pos;
  int nvict = 0;
  if (do_rec) {
    // the cluster right before the recover: the host takes its frag before
    // and after (fault_lane.recover_frags)
    const int s = a.f_dctr[kDRecoveries];
    if (s < a.f_nrec) {
      int* cpu = a.snap_cpu + static_cast<size_t>(s) * a.n;
      int* gpu = a.snap_gpu + static_cast<size_t>(s) * a.n * kDevs;
      for (int q = lane; q < a.n; q += 32) cpu[q] = a.cpu_left[q];
      for (int q = lane; q < a.n * kDevs; q += 32) gpu[q] = a.gpu_left[q];
      if (lane == 0) a.snap_node[s] = node;
    }
    __syncwarp();  // every lane has read the state before the reset
  }
  if (do_fail) {
    // every pod on the node, in ascending pod order
    for (int base = 0; base < a.p; base += 32) {
      const int q = base + lane;
      unsigned m = __ballot_sync(0xffffffffu, q < a.p && a.placed[q] == node);
      nvict += __popc(m);
      while (m != 0) {
        evict_pod(a, lane, base + __ffs(m) - 1, pos);
        m &= m - 1;
      }
    }
  }
  if (lane == 0 && (do_fail || do_rec)) {
    a.cpu_left[node] = a.cpu_cap[node];
    a.mem_left[node] = do_fail ? -1 : a.mem_cap[node];
    const int cnt = a.gpu_cnt[node];
    for (int d = 0; d < kDevs; ++d) a.gpu_left[node * kDevs + d] = d < cnt ? kMilli : 0;
    for (int c = 0; c < kAffClasses; ++c) a.aff_cnt[node * kAffClasses + c] = 0;
    a.f_down_at[node] = do_fail ? pos : -1;
    if (do_fail) {
      a.f_dctr[kDFailures] += 1;
    } else {
      a.f_dctr[kDRecoveries] += 1;
      a.f_dctr[kDFnGpuEvents] += cnt * (pos - down);
    }
  }
  if (victim >= 0) {
    if (lane == 0) {  // deschedule.evict's return of the pod's resources
      const int milli = a.p_milli[victim];
      const int bits = a.maskb[victim];
      a.cpu_left[vnode] += a.p_cpu[victim];
      a.mem_left[vnode] += a.p_mem[victim];
      for (int d = 0; d < kDevs; ++d)
        if ((bits >> d) & 1) a.gpu_left[vnode * kDevs + d] += milli;
      const int cls = affinity_class(milli, a.p_num[victim]);
      if (cls >= 0) a.aff_cnt[vnode * kAffClasses + cls] -= 1;
    }
    __syncwarp();
    evict_pod(a, lane, victim, pos);
    nvict = 1;
  }
  if (lane == 0) {
    const int touched = do_fail || do_rec ? node : vnode;
    a.y_vpod[i] = victim;
    a.y_vnode[i] = vnode;
    a.y_nvict[i] = nvict;
    a.y_rec[i] = do_rec ? 1 : 0;
    a.ev_node[i] = touched;
    a.ev_devb[i] = 0;
    *next = touched;
    if (touched >= 0) es.node = load_node(a, touched);
  }
  __syncwarp();
}

// A popped retry's bookkeeping after its create at step i (commit_retry):
// on success the latency and the run of failed attempts reset; on failure
// an attempt is burnt and the pod is pushed again in round `era`, or goes
// dead.
__device__ void commit_retry(const ReplayArgs& a, int i, int v, bool ok,
                             int pos, int era, int lane) {
  if (ok) {
    if (lane == 0) {
      a.y_lat[i] = pos - a.f_evicted_at[v];
      a.f_attempts[v] = 0;
      a.f_evicted_at[v] = -1;
      a.f_dctr[kDRescheduled] += 1;
    }
  } else {
    const int att = a.f_attempts[v] + 1;
    const bool pushed = queue_push(a, lane, v, att, pos, era);
    if (lane == 0) {
      a.f_attempts[v] = att;
      if (pushed) {
        a.f_dctr[kDRetriesEnq] += 1;
      } else {
        a.f_dead[v] = 1;
        a.f_dctr[kDDead] += 1;
      }
    }
  }
  if (lane == 0) a.y_rpod[i] = v;
  __syncwarp();
}

// Where step j is a retry slot, pop it (pop_retry), by one warp: the
// earliest (ready, seq) entry that is due (ready <= pos; flush round r:
// pushed before the round, era < r). Its staged event becomes the popped
// pod's create, or a skip when nothing qualifies; fs.popped[j & 1] says
// which pod (-1 none).
__device__ void pop_ahead(const ReplayArgs& a, EventState& es,
                          FaultShared& fs, int j, int lane) {
  if (j >= a.e) return;
  EventFields& ev = es.ev[(j / kEvBatch) & 1][j % kEvBatch];
  if (ev.kind != kRetry) {
    if (lane == 0) fs.popped[j & 1] = -1;
    __syncwarp();
    return;
  }
  const FaultFields f = fs.ff[(j / kEvBatch) & 1][j % kEvBatch];
  int ready = INT_MAX;
  int seq = INT_MAX;
  int slot = -1;
  for (int q = lane; q < a.f_cap_r; q += 32) {
    if (a.q_pod[q] < 0) continue;
    const bool due = f.arg > 0 ? a.q_era[q] < f.arg : a.q_ready[q] <= f.pos;
    if (!due) continue;
    const int r = a.q_ready[q];
    const int sq = a.q_seq[q];
    if (slot < 0 || r < ready || (r == ready && sq < seq)) {
      ready = r;
      seq = sq;
      slot = q;
    }
  }
  const bool has = __any_sync(0xffffffffu, slot >= 0);
  int pod = -1;
  if (has) {
    const int rmin = __reduce_min_sync(0xffffffffu, slot >= 0 ? ready : INT_MAX);
    const int smin = __reduce_min_sync(
        0xffffffffu, slot >= 0 && ready == rmin ? seq : INT_MAX);
    const unsigned own = __ballot_sync(0xffffffffu, slot >= 0 && ready == rmin &&
                                                        seq == smin);
    slot = __shfl_sync(0xffffffffu, slot, __ffs(own) - 1);
    pod = a.q_pod[slot];
  }
  __syncwarp();
  if (lane == 0) {
    if (has) {
      a.q_pod[slot] = -1;
      a.q_ready[slot] = INT_MAX;
      a.q_seq[slot] = INT_MAX;
      ev.kind = kCreate;
      ev.pod = pod;
      ev.type = a.p_type[pod];
      ev.pin = a.p_pinned[pod];
      ev.cpu = a.p_cpu[pod];
      ev.mem = a.p_mem[pod];
      ev.milli = a.p_milli[pod];
      ev.num = a.p_num[pod];
    } else {
      ev.kind = kSkip;
    }
    fs.popped[j & 1] = pod;
  }
  __syncwarp();
}

// One warp ends event i: lane 0 commits it (create with `node`, delete, or
// skip), then, where it changed a node and a policy is FGD, the warp
// computes that node's terms for the next event's refresh. In the fault
// forms (`fs`) a fault step runs fault_step instead, a popped retry's
// create is followed by commit_retry, and the next step's retry slot is
// popped.
template <bool kRandomized = false, bool kFaults = false>
__device__ void end_event(const ReplayArgs& a, const Smem& m, EventState& es,
                          int i, const EventFields& ev, int node, int gpu_sel,
                          bool fgd_terms, int n_pol, int lane,
                          FaultShared* fs = nullptr) {
  int* next = &es.dirty[(i + 1) & 1];
  bool fault = false;  // a failure, recovery or eviction step
  bool retry = false;  // a popped retry slot's create
  if constexpr (kFaults) {
    fault = ev.kind > kSkip;
    retry = fs->popped[i & 1] >= 0;
    if (fault)
      fault_step(a, es, i, ev.kind, fs->ff[(i / kEvBatch) & 1][i % kEvBatch],
                 next, lane);
  }
  if (!fault && lane == 0) {
    if (ev.kind == kCreate) {
      commit_create<kRandomized, kFaults>(
          a, i, ev, node, gpu_sel, next, &es.node,
          kRandomized ? es.ksel[i & 1] : uint2{}, retry);
    } else if (ev.kind == kDelete) {
      commit_delete(a, i, ev, next, &es.node);
    } else {  // EV_SKIP: nothing changes
      a.ev_node[i] = -1;
      a.ev_devb[i] = 0;
      *next = -1;
    }
  }
  __syncwarp();
  if constexpr (kFaults) {
    const int popped = fs->popped[i & 1];
    if (popped >= 0) {
      const FaultFields f = fs->ff[(i / kEvBatch) & 1][i % kEvBatch];
      commit_retry(a, i, popped, node >= 0, f.pos, f.arg, lane);
    }
    pop_ahead(a, es, *fs, i + 1, lane);
  }
  if (fgd_terms && *next >= 0) node_terms<kRandomized>(a, m, es, n_pol, lane);
}

// Set-up shared by both replay kernels: stage the launch's constants, the
// first event batch and the item layout (layout_items<kDraws>). Returns
// whether a policy is FGD.
template <bool kGeneral, bool kStaged = true, bool kDraws = false>
__device__ bool begin_replay(const ReplayArgs& a, const Smem& m,
                             EventState& es) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  stage<kStaged>(a, m, &es.t_count);
  if (warp == static_cast<int>(blockDim.x >> 5) - 1)
    load_events(a, 0, es.ev[0], lane);
  const int n_pol = kGeneral ? a.n_pol : 1;
  if (warp == 0) {
    int min_p = INT_MAX;
    for (int k = lane; k < a.ks; k += 32) min_p = min(min_p, a.t_milli[k]);
    min_p = __reduce_min_sync(0xffffffffu, min_p);
    if (lane == 0) {
      es.dirty[0] = -1;  // the tables already hold the initial state
      es.min_p = min_p;
      es.group = 1;  // node_terms lays FGD's items out per node
      layout_items<kDraws>(a, n_pol, 1, es.seg);
    }
  }
  bool fgd = false;
  for (int pi = 0; pi < n_pol; ++pi) fgd |= a.pol_column[pi] == kFgd;
  return fgd;
}

// the next batch of events, by the last warp, while event i (the first of
// its batch) runs
__device__ __forceinline__ void prefetch_events(const ReplayArgs& a,
                                                EventState& es, int i) {
  if (i % kEvBatch == 0 && i + kEvBatch < a.e &&
      (threadIdx.x >> 5) == (blockDim.x >> 5) - 1)
    load_events(a, i + kEvBatch, es.ev[(i / kEvBatch + 1) & 1],
                threadIdx.x & 31);
}

// The fault forms' staging beside begin_replay's and prefetch_events', by
// the last warp: the fault fields of the first batch (first = true), or
// those of the next batch while step i, the first of its batch, runs.
// <false>: nothing.
template <bool kFaults>
__device__ __forceinline__ void stage_faults(const ReplayArgs& a,
                                             FaultShared* fs, int i,
                                             bool first = false) {
  if constexpr (kFaults) {
    if ((first || (i % kEvBatch == 0 && i + kEvBatch < a.e)) &&
        (threadIdx.x >> 5) == (blockDim.x >> 5) - 1) {
      const int at = first ? 0 : i + kEvBatch;
      load_fault_fields(a, at, fs->ff[(at / kEvBatch) & 1], threadIdx.x & 31);
    }
  }
}

// the fault forms' static shared memory (a byte in the others)
template <bool kFaults>
using FaultSharedOf = typename std::conditional<kFaults, FaultShared, char>::type;

// The chain's key after the last event into a.key_out, by one thread once
// the event loop's last barrier has passed (the kKeyOut instantiations,
// replay_chunks.cu): the randomized replay's es.key, else the chain
// advanced a.e steps from the root here, after the loop, which does not
// advance it.
template <bool kRandomized>
__device__ __forceinline__ void write_key_out(const ReplayArgs& a,
                                              const EventState& es) {
  uint2 key = es.key;
  if (!kRandomized) {
    key = make_uint2(a.key[0], a.key[1]);
    for (int i = 0; i < a.e; ++i) key = next_key(key);
  }
  a.key_out[0] = key.x;
  a.key_out[1] = key.y;
}

template <bool kFaults>
__device__ __forceinline__ FaultShared* fault_shared(FaultSharedOf<kFaults>& f) {
  if constexpr (kFaults) return &f;
  return nullptr;
}


// ---------------------------------------------------------------------------
// The record forms: counters, decision rows, series samples and heartbeat
// ticks (tpusim's table engine records, table_engine.py:642-661, :880-991,
// :1095-1219; the row layouts of tpusim_torch/sim/records.py). Only the
// kRecord instantiations of the replay bodies call these
// (replay_records.cu, replay_blocked_records.cu); every branch on them is
// `if constexpr`, so the other instantiations are the code they were.
// ---------------------------------------------------------------------------

constexpr int kTopK = 3;         // obs/decisions.py DECISION_TOPK
constexpr int kDecFixed = 13;    // records.py DEC_FIXED
constexpr int kFragClasses = 7;
constexpr int kSerHist = 3;      // records.py SER_HIST
constexpr int kSerFrag = kSerHist + kUtilBuckets;
constexpr int kSerFixed = kSerFrag + kFragClasses;  // 20
constexpr int kNumCounters = 6;

struct RecordShared {
  int ctr[kNumCounters];
  int p0;     // processed events at the launch's start
  int rows;   // sample rows written
  int ticks;  // heartbeat ticks written
  int pick;   // the event's RandomScore draw (-1 none)
  int feasible;
  int lo[kMaxPolicies];
  int hi[kMaxPolicies];
  int acc[kSerFixed + 2 * kMaxFamily];
};

// the score columns of a record row: the configuration's policies, or a
// learned family's (ReplayArgs::fam_n)
template <bool kLearned>
__device__ __forceinline__ int record_pols(const ReplayArgs& a) {
  if constexpr (kLearned) return a.fam_n;
  return a.n_pol;
}

template <bool kRecord>
using RecordSharedOf = typename std::conditional<kRecord, RecordShared, char>::type;

template <bool kRecord>
__device__ __forceinline__ RecordShared* record_shared(RecordSharedOf<kRecord>& r) {
  if constexpr (kRecord) return &r;
  return nullptr;
}

// thread 0, before the launch's first barrier
__device__ void record_begin(const ReplayArgs& a, RecordShared& rs) {
  for (int c = 0; c < kNumCounters; ++c) rs.ctr[c] = a.ctr[c];
  rs.p0 = rs.ctr[0] + rs.ctr[3] + rs.ctr[4];
  rs.rows = 0;
  rs.ticks = 0;
  rs.pick = -1;
}

// Thread 0, after event i's last barrier: its counters (counter_delta),
// its decision row where it is no create (no_decision's sentinels), and a
// heartbeat tick where the processed count after it sits on the stride
// (the slot, a system fence, then the count of ticks, so that a reader
// that sees the count sees the slot).
template <bool kLearned = false>
__device__ void record_count(const ReplayArgs& a, RecordShared& rs, int i,
                             int kind) {
  const int n_pol = record_pols<kLearned>(a);
  if (kind == kCreate) {
    const bool ok = a.ev_node[i] >= 0;
    rs.ctr[0] += 1;
    rs.ctr[ok ? 1 : 2] += 1;
  } else {
    rs.ctr[kind == kDelete ? 3 : 4] += 1;
    if (a.rec_dec != nullptr) {
      int* row = a.rec_dec + static_cast<size_t>(i) * (kDecFixed + 2 * n_pol);
      row[0] = -1;
      row[1] = 0;
      row[2] = 0;
      row[3] = -1;
      for (int j = 0; j < kTopK; ++j) {
        row[4 + j] = -1;
        row[4 + kTopK + j] = 0;
        row[4 + 2 * kTopK + j] = -1;
      }
      for (int j = 0; j < 2 * n_pol; ++j) row[kDecFixed + j] = 0;
    }
  }
  if (a.hb_ring != nullptr && a.hb_every > 0) {
    const int done = rs.p0 + i + 1;
    if (done % a.hb_every == 0) {
      volatile int* ring = a.hb_ring;
      const int j = rs.ticks++;
      ring[1 + j % a.hb_slots] = done;
      __threadfence_system();
      ring[0] = j + 1;
      __threadfence_system();
    }
  }
}

// thread 0, after the event loop: the counters back (`rebuilds` the
// launch's summary-row rebuilds)
__device__ void record_end(const ReplayArgs& a, RecordShared& rs,
                           int rebuilds) {
  rs.ctr[5] += rebuilds;
  for (int c = 0; c < kNumCounters; ++c) a.ctr[c] = rs.ctr[c];
}

// sum / max / min of every thread's v into shared acc (one atomic a warp)
__device__ __forceinline__ void block_add(int* acc, int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(acc, v);
}
__device__ __forceinline__ void block_max(int* acc, int v) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMax(acc, v);
}
__device__ __forceinline__ void block_min(int* acc, int v) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMin(acc, v);
}

// The node's seven frag amounts (node_frag_contrib), each summed over the
// typical pods in ops/frag.py tree_sum's order (node_frag_rows): the pods
// one by one up to 32 of them; past that, windows of 32 over the pods
// padded by `lo` zero rows in front (zeros add nothing), each summed from
// 0, and the window sums added in turn, again in windows of 32 past 32 of
// them (the host refuses the series past 32 x 32 x 32 typical pods).
// Reads the typical pods where the caller keeps them (all of them: the
// tree's windows count the zero-frequency rows).
__device__ void node_frag_amounts(const ReplayArgs& a, const NodeView& v,
                                  float* out) {
  const int T = a.t;
  const int gsum = gpu_sum(v);
  const float total = static_cast<float>(gsum);
  const int pad1 = (32 - T % 32) % 32;
  const int nw = T <= 32 ? 1 : (T + pad1) / 32;
  const int lo1 = T <= 32 ? 0 : pad1 / 2;
  const int pad2 = (32 - nw % 32) % 32;
  const int ng = nw <= 32 ? 1 : (nw + pad2) / 32;
  const int lo2 = nw <= 32 ? 0 : pad2 / 2;
  const int wpg = nw <= 32 ? nw : 32;
  for (int c = 0; c < kFragClasses; ++c) out[c] = 0.0f;
  for (int g = 0; g < ng; ++g) {
    float grp[kFragClasses];
    for (int c = 0; c < kFragClasses; ++c) grp[c] = 0.0f;
    for (int wg = 0; wg < wpg; ++wg) {
      const int w = g * wpg + wg - lo2;
      if (w < 0 || w >= nw) continue;
      float win[kFragClasses];
      for (int c = 0; c < kFragClasses; ++c) win[c] = 0.0f;
      for (int j = 0; j < (T <= 32 ? T : 32); ++j) {
        const int t = w * 32 + j - lo1;
        if (t < 0 || t >= T) continue;
        const int milli = a.tp_milli[t];
        const int num = a.tp_num[t];
        const int mask = a.tp_mask[t];
        const float freq = a.tp_freq[t];
        const bool cpu_ok = v.cpu >= a.tp_cpu[t];
        int cls;
        int small = 0;
        if (milli == 0) {
          cls = cpu_ok ? 4 : 5;
        } else if (!(mask == 0 || (mask & v.bit) != 0)) {
          cls = 6;
        } else {
          int fit = 0;
#pragma unroll
          for (int d = 0; d < kDevs; ++d) {
            fit += v.g[d] >= milli ? 1 : 0;
            small += v.g[d] < milli ? v.g[d] : 0;
          }
          cls = fit >= num ? (cpu_ok ? kQ3 : 3) : (cpu_ok ? kQ2 : 0);
        }
        if (cls == kQ3) {
          const float s = static_cast<float>(small);
          win[kQ2] = __fadd_rn(win[kQ2], __fmul_rn(freq, s));
          win[kQ3] = __fadd_rn(win[kQ3], __fmul_rn(freq, __fsub_rn(total, s)));
        } else {
          win[cls] = __fadd_rn(win[cls], __fmul_rn(freq, total));
        }
      }
      for (int c = 0; c < kFragClasses; ++c) grp[c] = __fadd_rn(grp[c], win[c]);
    }
    for (int c = 0; c < kFragClasses; ++c) out[c] = __fadd_rn(out[c], grp[c]);
  }
}

// The series sample of event i (type `type`) into the next row of
// a.rec_ser (obs/series.py build_sample): over the cluster's a.rec_nodes
// nodes as committed, the utilisation histogram of the UP GPU nodes, the
// DOWN nodes, and each UP node's frag amounts rounded half to even before
// the integer sums; over the type's Filter row (no pin), the feasible count
// and each policy's normalised extrema (two passes: the raw extrema, then
// the normalised ones; RandomScore's slot 0). Every thread calls it; it
// ends with a barrier.
template <bool kLearned = false>
__device__ void record_sample(const ReplayArgs& a, RecordShared& rs, int i,
                              int type) {
  const int n_pol = a.n_pol;
  const int nf = record_pols<kLearned>(a);  // the row's score columns
  const int na = kSerFixed + 2 * nf;
  if (threadIdx.x == 0) {
    for (int j = 0; j < na; ++j) rs.acc[j] = 0;
    for (int pi = 0; pi < n_pol; ++pi) {
      rs.lo[pi] = INT_MAX;
      rs.hi[pi] = -INT_MAX;
    }
    for (int pi = 0; pi < nf; ++pi) {
      rs.acc[kSerFixed + pi] = -INT_MAX;
      rs.acc[kSerFixed + nf + pi] = INT_MAX;
    }
  }
  __syncthreads();
  int down = 0;
  int feas = 0;
  int fr[kFragClasses] = {0, 0, 0, 0, 0, 0, 0};
  int lo[kMaxPolicies];
  int hi[kMaxPolicies];
  for (int pi = 0; pi < kMaxPolicies; ++pi) {
    lo[pi] = INT_MAX;
    hi[pi] = -INT_MAX;
  }
  const size_t row = static_cast<size_t>(type) * a.n;
  for (int node = threadIdx.x; node < a.n; node += blockDim.x) {
    if (node < a.rec_nodes) {
      const NodeView v = load_node(a, node);
      if (v.mem < 0) {
        ++down;
      } else {
        if (v.gcnt > 0) {
          const int cap = v.gcnt * kMilli;
          const int b = floor_div((cap - gpu_sum(v)) * kUtilBuckets, max(cap, 1));
          atomicAdd(&rs.acc[kSerHist + min(max(b, 0), kUtilBuckets - 1)], 1);
        }
        float amt[kFragClasses];
        node_frag_amounts(a, v, amt);
        for (int c = 0; c < kFragClasses; ++c) fr[c] += __float2int_rn(amt[c]);
      }
    }
    if (a.feas[row + node] != 0) {
      ++feas;
      for (int pi = 0; pi < n_pol; ++pi) {
        if (a.pol_norm[pi] == kNormNone || a.pol_column[pi] == kRandomScore)
          continue;
        const int r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
        lo[pi] = min(lo[pi], r);
        hi[pi] = max(hi[pi], r);
      }
    }
  }
  block_add(&rs.acc[1], down);
  block_add(&rs.acc[2], feas);
  for (int c = 0; c < kFragClasses; ++c) block_add(&rs.acc[kSerFrag + c], fr[c]);
  for (int pi = 0; pi < n_pol; ++pi) {
    block_min(&rs.lo[pi], lo[pi]);
    block_max(&rs.hi[pi], hi[pi]);
  }
  __syncthreads();
  if constexpr (kLearned) {
    // each family policy's extrema: a table row's normalised scores, or a
    // node feature's values, over the feasible nodes
    int fhi[kMaxFamily];
    int flo[kMaxFamily];
    for (int j = 0; j < kMaxFamily; ++j) {
      fhi[j] = -INT_MAX;
      flo[j] = INT_MAX;
    }
    for (int node = threadIdx.x; node < a.n; node += blockDim.x) {
      if (a.feas[row + node] == 0) continue;
      int f[kNodeFeatures];
      node_features(a, load_node(a, node), a.mem_cap[node], f);
      for (int j = 0; j < nf; ++j) {
        const int pi = a.fam_src[j];
        int r;
        if (pi < 0) {
          r = f[-1 - pi];
        } else {
          if (a.pol_column[pi] == kRandomScore) continue;
          r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
          if (a.pol_norm[pi] != kNormNone)
            r = normalize(r, rs.lo[pi], rs.hi[pi], a.pol_norm[pi]);
        }
        fhi[j] = max(fhi[j], r);
        flo[j] = min(flo[j], r);
      }
    }
    for (int j = 0; j < nf; ++j) {
      block_max(&rs.acc[kSerFixed + j], fhi[j]);
      block_min(&rs.acc[kSerFixed + nf + j], flo[j]);
    }
  } else {
    for (int pi = 0; pi < n_pol; ++pi) {
      lo[pi] = INT_MAX;
      hi[pi] = -INT_MAX;
    }
    for (int node = threadIdx.x; node < a.n; node += blockDim.x) {
      if (a.feas[row + node] == 0) continue;
      for (int pi = 0; pi < n_pol; ++pi) {
        if (a.pol_column[pi] == kRandomScore) continue;
        int r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
        if (a.pol_norm[pi] != kNormNone)
          r = normalize(r, rs.lo[pi], rs.hi[pi], a.pol_norm[pi]);
        hi[pi] = max(hi[pi], r);
        lo[pi] = min(lo[pi], r);
      }
    }
    for (int pi = 0; pi < n_pol; ++pi) {
      block_max(&rs.acc[kSerFixed + pi], hi[pi]);
      block_min(&rs.acc[kSerFixed + n_pol + pi], lo[pi]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* out = a.rec_ser + static_cast<size_t>(rs.rows++) * na;
    const bool any = rs.acc[2] > 0;
    out[0] = rs.p0 + i;
    for (int j = 1; j < kSerFixed; ++j) out[j] = rs.acc[j];
    for (int j = 0; j < nf; ++j) {
      const int pi = kLearned ? a.fam_src[j] : j;
      const bool zero = !any || (pi >= 0 && a.pol_column[pi] == kRandomScore);
      out[kSerFixed + j] = zero ? 0 : rs.acc[kSerFixed + j];
      out[kSerFixed + nf + j] = zero ? 0 : rs.acc[kSerFixed + nf + j];
    }
  }
  __syncthreads();
}

// node `node`'s i32 weighted total for a type under the extrema lo/hi, and
// each policy's raw and normalised score into raw/nrm (null: not kept);
// RandomScore scores 100 on `pick`
__device__ __forceinline__ int record_total(const ReplayArgs& a, int type,
                                            int node, const int* lo,
                                            const int* hi, int pick, int* raw,
                                            int* nrm) {
  uint32_t sum = 0;
  for (int pi = 0; pi < a.n_pol; ++pi) {
    int r;
    int q;
    if (a.pol_column[pi] == kRandomScore) {
      r = node == pick ? kMaxNodeScore : 0;
      q = r;
    } else {
      r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
      q = a.pol_norm[pi] != kNormNone ? normalize(r, lo[pi], hi[pi], a.pol_norm[pi])
                                      : r;
    }
    if (raw != nullptr) {
      raw[pi] = r;
      nrm[pi] = q;
    }
    sum += static_cast<uint32_t>(a.pol_weight[pi]) * static_cast<uint32_t>(q);
  }
  return static_cast<int>(sum);
}

// The decision row of create event i (type `type`, pin `pin`) into
// a.rec_dec (step.build_decision): the type's rows normalised directly
// over the pin-masked feasible nodes, the feasible count, the top-K as
// kTopK rounds of selectHost's block reduction, each masking the winners
// before it out (packed_topk), and the committed winner `node`'s total,
// raw and normalised scores. `blocked`: the winner's 128-node block, else
// -1. `pick` is RandomScore's draw. Every thread calls it; it ends with a
// barrier.
template <bool kLearned = false>
__device__ void record_decision(const ReplayArgs& a, RecordShared& rs,
                                Best* warp_res, int i, int type, int pin,
                                int node, bool blocked) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_pol = a.n_pol;
  const int pick = rs.pick;
  if (tid == 0) {
    rs.feasible = 0;
    for (int pi = 0; pi < n_pol; ++pi) {
      rs.lo[pi] = INT_MAX;
      rs.hi[pi] = -INT_MAX;
    }
  }
  __syncthreads();
  const int* frow = a.feas + static_cast<size_t>(type) * a.n;
  int lo[kMaxPolicies];
  int hi[kMaxPolicies];
  for (int pi = 0; pi < kMaxPolicies; ++pi) {
    lo[pi] = INT_MAX;
    hi[pi] = -INT_MAX;
  }
  int cnt = 0;
  for (int j = tid; j < a.n; j += blockDim.x) {
    if (frow[j] == 0 || (pin >= 0 && j != pin)) continue;
    ++cnt;
    for (int pi = 0; pi < n_pol; ++pi) {
      if (a.pol_norm[pi] == kNormNone || a.pol_column[pi] == kRandomScore)
        continue;
      const int r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + j];
      lo[pi] = min(lo[pi], r);
      hi[pi] = max(hi[pi], r);
    }
  }
  block_add(&rs.feasible, cnt);
  for (int pi = 0; pi < n_pol; ++pi) {
    block_min(&rs.lo[pi], lo[pi]);
    block_max(&rs.hi[pi], hi[pi]);
  }
  __syncthreads();
  for (int pi = 0; pi < n_pol; ++pi) {
    lo[pi] = rs.lo[pi];
    hi[pi] = rs.hi[pi];
  }
  Best top[kTopK];
  for (int r = 0; r < kTopK; ++r) {
    Best b = no_candidate();
    for (int j = tid; j < a.n; j += blockDim.x) {
      if (frow[j] == 0 || (pin >= 0 && j != pin)) continue;
      bool taken = false;
      for (int q = 0; q < r; ++q) taken |= top[q].node == j;
      if (taken) continue;
      const Best c = {record_total(a, type, j, lo, hi, pick, nullptr, nullptr),
                      a.rank[j], j};
      if (beats(c, b)) b = c;
    }
    b = warp_best(b);
    if (lane == 0) warp_res[warp] = b;
    __syncthreads();
    b = warp_best(lane < nwarps ? warp_res[lane] : no_candidate());
    top[r] = {__shfl_sync(0xffffffffu, b.total, 0),
              __shfl_sync(0xffffffffu, b.rank, 0),
              __shfl_sync(0xffffffffu, b.node, 0)};
    __syncthreads();
  }
  if (tid == 0) {
    const int nf = record_pols<kLearned>(a);
    int* row = a.rec_dec + static_cast<size_t>(i) * (kDecFixed + 2 * nf);
    const bool ok = node >= 0;
    int raw[kMaxPolicies];
    int nrm[kMaxPolicies];
    const int total = ok ? record_total(a, type, node, lo, hi, pick, raw, nrm) : 0;
    row[0] = node;
    row[1] = total;
    row[2] = rs.feasible;
    row[3] = ok && blocked ? node / kBlock : -1;
    for (int r = 0; r < kTopK; ++r) {
      const bool valid = top[r].node != INT_MAX;
      row[4 + r] = valid ? top[r].node : -1;
      row[4 + kTopK + r] = valid ? top[r].total : 0;
      row[4 + 2 * kTopK + r] = valid ? top[r].rank : -1;
    }
    if constexpr (kLearned) {
      // a family policy's columns: its table row's, or its node feature
      // at the winner (normalised "none") as the select saw it, before
      // this event's commit took the pod's resources
      int f[kNodeFeatures];
      if (ok) {
        NodeView v = load_node(a, node);
        const int pod = a.ev_pod[i];
        const int bits = a.ev_devb[i];
        v.cpu += a.p_cpu[pod];
        v.mem += a.p_mem[pod];
#pragma unroll
        for (int d = 0; d < kDevs; ++d)
          v.g[d] += (bits >> d) & 1 ? a.p_milli[pod] : 0;
        node_features(a, v, a.mem_cap[node], f);
      }
      for (int j = 0; j < nf; ++j) {
        const int pi = a.fam_src[j];
        row[kDecFixed + j] = !ok ? 0 : pi < 0 ? f[-1 - pi] : raw[pi];
        row[kDecFixed + nf + j] = !ok ? 0 : pi < 0 ? f[-1 - pi] : nrm[pi];
      }
    } else {
      for (int pi = 0; pi < n_pol; ++pi) {
        row[kDecFixed + pi] = ok ? raw[pi] : 0;
        row[kDecFixed + n_pol + pi] = ok ? nrm[pi] : 0;
      }
    }
  }
  __syncthreads();
}

// The node column's rows (kLearnedNode) of every node under this launch's
// weights: a lane of a sweep carries its own, where init_tables built the
// shared tables with another's. Every thread, then a barrier.
__device__ void learned_rows(const ReplayArgs& a) {
  bool any = false;
  for (int pi = 0; pi < a.n_pol; ++pi) any |= a.pol_column[pi] == kLearnedNode;
  if (!any) return;
  for (int node = threadIdx.x; node < a.n; node += blockDim.x) {
    const int val = learned_node_value(a, load_node(a, node), a.mem_cap[node]);
    for (int pi = 0; pi < a.n_pol; ++pi) {
      if (a.pol_column[pi] != kLearnedNode) continue;
      for (int k = 0; k < a.k; ++k)
        a.score[(static_cast<size_t>(pi) * a.k + k) * a.n + node] = val;
    }
  }
  __syncthreads();
}

// <kGeneral, kRandomized, kStaged, kFaults>: kRandomized adds RandomScore's
// draw and gpu_sel random (the key chain in es, advanced by the last warp
// while warp 0 commits); kStaged is the staged form, false the global one;
// kFaults is the fault form (the merged stream of fault_lane.py: kinds 3-6,
// the FaultFields, the retry queue; the key chain takes a step a merged
// step, as tpusim's lane does); kKeyOut is the chunk form, which writes the
// key chain's key after its last event (write_key_out); kRecord is the
// record form (replay_records.cu and replay_blocked_records.cu), which also
// writes the counters, the decision and series rows and the heartbeat ticks
// of ReplayArgs; kLearned adds the learned columns and the node column's
// rows at the start (learned_rows; replay_learned.cu, replay_learned_records.cu
// and replay_forced.cu instantiate it).
template <bool kGeneral, bool kRandomized = false, bool kStaged = true,
          bool kFaults = false, bool kKeyOut = false, bool kRecord = false,
          bool kLearned = false>
__device__ __forceinline__ void replay_body(const ReplayArgs& a) {
  constexpr int kWarps = kReplayThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Best warp_res[kWarps];
  __shared__ int warp_lo[kWarps][kMaxPolicies];
  __shared__ int warp_hi[kWarps][kMaxPolicies];
  __shared__ unsigned long long warp_draw[kRandomized ? kWarps : 1];
  __shared__ EventState es;
  __shared__ FaultSharedOf<kFaults> fsh;
  FaultShared* fs = fault_shared<kFaults>(fsh);
  __shared__ RecordSharedOf<kRecord> rsh;
  RecordShared* rs = record_shared<kRecord>(rsh);
  __shared__ long long s_clk[kNumClocks];
  __shared__ long long s_work[3];
  PhaseClock pc;
  pc.start(s_clk);
  if (kClocked && threadIdx.x == 0) s_work[0] = s_work[1] = s_work[2] = 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gpu_sel = kGeneral ? a.gpu_sel : (a.sel >= 0 ? kSelSelf : kSelBest);
  if constexpr (kRecord) {
    if (tid == 0) record_begin(a, *rs);
  }
  bool any_norm = false;
  bool draws = false;  // a RandomScore policy
  if (kGeneral)
    for (int pi = 0; pi < a.n_pol; ++pi) {
      any_norm |= a.pol_norm[pi] != kNormNone;
      draws |= kRandomized && a.pol_column[pi] == kRandomScore;
    }
  const int n_pol = kGeneral ? a.n_pol : 1;
  if constexpr (kLearned) learned_rows(a);
  const Smem m = replay_smem<kStaged>(a, smem, n_pol, false);
  const bool fgd_terms = begin_replay<kGeneral, kStaged, kRandomized>(a, m, es);
  stage_faults<kFaults>(a, fs, 0, true);
  if (kRandomized && tid == 0)
    advance_keys(es, make_uint2(a.key[0], a.key[1]), 0);
  __syncthreads();
  if constexpr (kFaults) {
    if (warp == 0) pop_ahead(a, es, *fs, 0, lane);
    __syncthreads();
  }
  const long long t0 = clock_now();

  for (int i = 0; i < a.e; ++i) {
    prefetch_events(a, es, i);
    stage_faults<kFaults>(a, fs, i);
    // refresh the column of the node the previous event changed
    const int dirty = es.dirty[i & 1];
    if (dirty >= 0) {
      const long long t_ref = clock_now();
      refresh_column<kGeneral, false, true, kRandomized, kLearned>(
          a, m, es, dirty, s_work);
      pc.end_work(s_work);
      if (tid == 0) {
        pc.count(kClkRefreshes, 1);
        pc.count(kClkItems, es.seg[n_pol]);
      }
      pc.sync();
      pc.finish_work(s_work, t_ref);
      pc.mark(kClkRefresh);
    }

    const EventFields ev = es.ev[(i / kEvBatch) & 1][i % kEvBatch];
    if constexpr (kRecord) {
      if (a.rec_every > 0 && (rs->p0 + i) % a.rec_every == 0)
        record_sample<kLearned>(a, *rs, i, ev.type);
    }
    if (ev.kind == kCreate) {
      const int type = ev.type;
      const int pin = ev.pin;
      const int* frow = a.feas + static_cast<size_t>(type) * a.n;
      int lo[kMaxPolicies];
      int hi[kMaxPolicies];
      int pick = -1;  // RandomScore's node
      if (kGeneral && (any_norm || draws)) {
        // the feasible extrema of each normalised policy's row, and
        // RandomScore's draw: the feasible node of the largest
        // uniform(k_rand, (N,)), the first on ties, as (mantissa + 1) << 32
        // | INT_MAX - node (0 where no node is feasible)
        for (int pi = 0; pi < a.n_pol; ++pi) {
          lo[pi] = INT_MAX;
          hi[pi] = -INT_MAX;
        }
        unsigned long long draw = 0;
        const uint2 krand = kRandomized ? es.krand[i & 1] : uint2{};
        // loads issued before the feasibility test, so that unrolled
        // iterations overlap
#pragma unroll 4
        for (int node = tid; node < a.n; node += blockDim.x) {
          const bool f = frow[node] != 0 && (pin < 0 || node == pin);
          for (int pi = 0; pi < a.n_pol; ++pi) {
            if (a.pol_norm[pi] == kNormNone) continue;
            const int r =
                a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
            lo[pi] = f ? min(lo[pi], r) : lo[pi];
            hi[pi] = f ? max(hi[pi], r) : hi[pi];
          }
          if (kRandomized && draws && f) {
            const unsigned long long d =
                (static_cast<unsigned long long>(uniform_mantissa(krand, node)) +
                 1ull) << 32 |
                static_cast<uint32_t>(INT_MAX - node);
            draw = d > draw ? d : draw;
          }
        }
        for (int pi = 0; pi < a.n_pol; ++pi) {
          lo[pi] = __reduce_min_sync(0xffffffffu, lo[pi]);
          hi[pi] = __reduce_max_sync(0xffffffffu, hi[pi]);
          if (lane == 0) {
            warp_lo[warp][pi] = lo[pi];
            warp_hi[warp][pi] = hi[pi];
          }
        }
        if (kRandomized) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long o = __shfl_xor_sync(0xffffffffu, draw, off);
            draw = o > draw ? o : draw;
          }
          if (lane == 0) warp_draw[warp] = draw;
        }
        pc.sync();
        for (int pi = 0; pi < a.n_pol; ++pi) {  // lane w reads warp w's
          lo[pi] = __reduce_min_sync(
              0xffffffffu, lane < nwarps ? warp_lo[lane][pi] : INT_MAX);
          hi[pi] = __reduce_max_sync(
              0xffffffffu, lane < nwarps ? warp_hi[lane][pi] : -INT_MAX);
        }
        if (kRandomized) {
          draw = lane < nwarps ? warp_draw[lane] : 0ull;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long o = __shfl_xor_sync(0xffffffffu, draw, off);
            draw = o > draw ? o : draw;
          }
          pick = draw == 0 ? -1
                           : INT_MAX - static_cast<int>(draw & 0xffffffffull);
        }
        pc.mark(kClkExtrema);
      }
      Best b = no_candidate();
      if constexpr (kRecord) {
        if (tid == 0) rs->pick = pick;
      }
      int from = 0;  // nodes below it are taken by the 16-byte loop
      if (!kGeneral && (a.n & 3) == 0) {
        // rows of whole int4s: four nodes a load (the FGD shape at scale)
        const int4* f4 = reinterpret_cast<const int4*>(frow);
        const int4* s4 = reinterpret_cast<const int4*>(
            a.score + static_cast<size_t>(type) * a.n);
        const int4* r4 = reinterpret_cast<const int4*>(a.rank);
        const uint32_t w = static_cast<uint32_t>(a.pol_weight[0]);
        for (int q = tid; q < a.n / 4; q += blockDim.x) {
          const int4 f = f4[q];
          const int4 sc = s4[q];
          const int4 rk = r4[q];
          const int fs[4] = {f.x, f.y, f.z, f.w};
          const int ss[4] = {sc.x, sc.y, sc.z, sc.w};
          const int rs[4] = {rk.x, rk.y, rk.z, rk.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int node = 4 * q + e;
            const Best c = {static_cast<int>(w * static_cast<uint32_t>(ss[e])),
                            rs[e], node};
            if (fs[e] != 0 && (pin < 0 || node == pin) && beats(c, b)) b = c;
          }
        }
        from = a.n;
      }
#pragma unroll 4
      for (int node = from + tid; node < a.n; node += blockDim.x) {
        const bool f = frow[node] != 0 && (pin < 0 || node == pin);
        int total;
        if (!kGeneral) {
          total = static_cast<int>(
              static_cast<uint32_t>(a.pol_weight[0]) *
              static_cast<uint32_t>(a.score[static_cast<size_t>(type) * a.n + node]));
        } else {
          uint32_t sum = 0;
          for (int pi = 0; pi < a.n_pol; ++pi) {
            int r;
            if (kRandomized && a.pol_column[pi] == kRandomScore) {
              r = node == pick ? kMaxNodeScore : 0;  // no table row
            } else {
              r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
              if (a.pol_norm[pi] != kNormNone)
                r = normalize(r, lo[pi], hi[pi], a.pol_norm[pi]);
            }
            sum += static_cast<uint32_t>(a.pol_weight[pi]) * static_cast<uint32_t>(r);
          }
          total = static_cast<int>(sum);
        }
        const Best c = {total, a.rank[node], node};
        if (f && beats(c, b)) b = c;
      }
      b = warp_best(b);
      if (lane == 0) warp_res[warp] = b;
      pc.sync();
      pc.mark(kClkSelect);
      if (warp == 0) {
        b = warp_best(lane < nwarps ? warp_res[lane] : no_candidate());
        const int node = __shfl_sync(0xffffffffu, b.node, 0);
        end_event<kRandomized, kFaults>(a, m, es, i, ev,
                                        node == INT_MAX ? -1 : node, gpu_sel,
                                        fgd_terms, n_pol, lane, fs);
      }
    } else if (warp == 0) {
      end_event<kRandomized, kFaults>(a, m, es, i, ev, -1, gpu_sel, fgd_terms,
                                      n_pol, lane, fs);
    }
    // the next event's keys, by a thread of the last warp while warp 0
    // commits: every event takes one step of the chain, whatever its kind
    if (kRandomized && tid == blockDim.x - 32 && i + 1 < a.e)
      advance_keys(es, es.key, (i + 1) & 1);
    pc.sync();
    pc.mark(kClkCommit);
    if constexpr (kRecord) {
      if (ev.kind == kCreate && a.rec_dec != nullptr)
        record_decision<kLearned>(a, *rs, warp_res, i, ev.type, ev.pin,
                                  a.ev_node[i], false);
      if (tid == 0) record_count<kLearned>(a, *rs, i, ev.kind);
    }
  }
  if constexpr (kRecord) {
    if (tid == 0) record_end(a, *rs, 0);
  }
  if constexpr (kKeyOut) {
    if (tid == 0) write_key_out<kRandomized>(a, es);
  }
  pc.finish(a.clocks, t0);
}

template <bool kGeneral, bool kRandomized = false, bool kStaged = true,
          bool kFaults = false, bool kKeyOut = false, bool kRecord = false,
          bool kLearned = false>
__global__ void __launch_bounds__(kReplayThreads, 1) replay_kernel(ReplayArgs a) {
  replay_body<kGeneral, kRandomized, kStaged, kFaults, kKeyOut, kRecord,
              kLearned>(a);
}

// ---------------------------------------------------------------------------
// replay_blocked: replay_kernel's event loop with a two-level selectHost over
// 128-node block summaries (pallas_engine.py _make_hbm_kernel :1346, whose
// algorithm is the blocked table engine's: table_engine.py make_blocked_body
// :684, init :1294-1320, _totals :664; step.py block_reduce :218).
// ---------------------------------------------------------------------------

// One warp summarises block c of type t: the best (total, rank, node) of its
// 128 nodes (their ranks in brank), where a node's total is the i32
// weighted sum with each normalised policy s scaled against lo[s * ld],
// hi[s * ld], and -INT_MAX where the type is infeasible; with `extrema`,
// also each normalised policy's feasible raw min and max over the block.
// Lane 0 writes them.
template <bool kGeneral>
__device__ void summarize_block(const ReplayArgs& a, int t, int c,
                                const int* lo, const int* hi, int ld,
                                bool extrema, int lane, const int* brank) {
  const int nblk = a.n / kBlock;
  int mn[kMaxPolicies];
  int mx[kMaxPolicies];
  for (int s = 0; s < kMaxPolicies; ++s) {
    mn[s] = INT_MAX;
    mx[s] = -INT_MAX;
  }
  Best b = no_candidate();
  for (int j = lane; j < kBlock; j += 32) {
    const int node = c * kBlock + j;
    const size_t i = static_cast<size_t>(t) * a.n + node;
    const bool f = a.feas[i] != 0;
    uint32_t sum = 0;
    if (!kGeneral) {
      sum = static_cast<uint32_t>(a.pol_weight[0]) *
            static_cast<uint32_t>(a.score[i]);
    } else {
      int s = 0;
      for (int pi = 0; pi < a.n_pol; ++pi) {
        int r = a.score[(static_cast<size_t>(pi) * a.k + t) * a.n + node];
        if (a.pol_norm[pi] != kNormNone) {
          if (f) {
            mn[s] = min(mn[s], r);
            mx[s] = max(mx[s], r);
          }
          r = normalize(r, lo[s * ld], hi[s * ld], a.pol_norm[pi]);
          ++s;
        }
        sum += static_cast<uint32_t>(a.pol_weight[pi]) * static_cast<uint32_t>(r);
      }
    }
    const Best cand = {f ? static_cast<int>(sum) : -INT_MAX, brank[j], node};
    if (beats(cand, b)) b = cand;
  }
  b = warp_best(b);
  if (kGeneral && extrema) {
    int s = 0;
    for (int pi = 0; pi < a.n_pol; ++pi) {
      if (a.pol_norm[pi] == kNormNone) continue;
      const int blo = __reduce_min_sync(0xffffffffu, mn[s]);
      const int bhi = __reduce_max_sync(0xffffffffu, mx[s]);
      if (lane == 0) {
        const size_t e = (static_cast<size_t>(s) * a.k + t) * nblk + c;
        a.brmin[e] = blo;
        a.brmax[e] = bhi;
      }
      ++s;
    }
  }
  if (lane == 0) {
    const size_t at = static_cast<size_t>(t) * nblk + c;
    a.bt[at] = b.total;
    a.br[at] = b.rank;
    a.bn[at] = b.node;
  }
}

// The dirty block's summaries after one node changed, one thread per type,
// from the refresh's old and new raw scores and Filter bits (the plain
// version is hbm_engine.update_block_summaries). Nothing else in the block
// changed and the stored extrema are fixed, so the node's new candidate
// (total, rank, node) decides: against a winner that is another node the
// better of the two wins; a winner that is this node stays if its new
// candidate does not lose to its old one. A normalised policy's block
// extrema widen to the new raw value; where the old value was the block's
// min (max) and moved inward, or the node became infeasible, they are
// unknown. Those types, and those whose winner lost, are listed in
// m.rescan for a warp's summarize_block. `rank_d` is the node's rank.
template <bool kGeneral>
__device__ void update_summaries(const ReplayArgs& a, const Smem& m, int node,
                                 int rank_d, int* n_rescan) {
  const int k_count = a.k;
  const int nblk = a.n / kBlock;
  const int c = node / kBlock;
  for (int t = threadIdx.x; t < k_count; t += blockDim.x) {
    const bool of = m.old_feas[t] != 0;
    const bool nf = m.new_feas[t] != 0;
    bool rescan = false;
    uint32_t so = 0;
    uint32_t sn = 0;
    if (!kGeneral) {
      so = static_cast<uint32_t>(a.pol_weight[0]) *
           static_cast<uint32_t>(m.old_raw[t]);
      sn = static_cast<uint32_t>(a.pol_weight[0]) *
           static_cast<uint32_t>(m.new_raw[t]);
    } else {
      int s = 0;
      for (int pi = 0; pi < a.n_pol; ++pi) {
        int ro = m.old_raw[pi * k_count + t];
        int rn = m.new_raw[pi * k_count + t];
        if (a.pol_norm[pi] != kNormNone) {
          const size_t e = (static_cast<size_t>(s) * k_count + t) * nblk + c;
          const int mn = a.brmin[e];
          const int mx = a.brmax[e];
          rescan |= of && ro == mn && (!nf || rn > ro);
          rescan |= of && ro == mx && (!nf || rn < ro);
          if (nf && rn < mn) a.brmin[e] = rn;  // a rescan rewrites both
          if (nf && rn > mx) a.brmax[e] = rn;
          const int lo = a.slo[s * k_count + t];
          const int hi = a.shi[s * k_count + t];
          ro = normalize(ro, lo, hi, a.pol_norm[pi]);
          rn = normalize(rn, lo, hi, a.pol_norm[pi]);
          ++s;
        }
        so += static_cast<uint32_t>(a.pol_weight[pi]) * static_cast<uint32_t>(ro);
        sn += static_cast<uint32_t>(a.pol_weight[pi]) * static_cast<uint32_t>(rn);
      }
    }
    const int old_total = of ? static_cast<int>(so) : -INT_MAX;
    const int new_total = nf ? static_cast<int>(sn) : -INT_MAX;
    const size_t at = static_cast<size_t>(t) * nblk + c;
    const Best held = {a.bt[at], a.br[at], a.bn[at]};
    const Best cand = {new_total, rank_d, node};
    Best b = held;
    if (held.node != node) {
      if (beats(cand, held)) b = cand;
    } else if (new_total >= old_total) {
      b.total = new_total;
    } else {
      rescan = true;
    }
    if (rescan) {
      m.rescan[atomicAdd(n_rescan, 1)] = t;
    } else if (b.total != held.total || b.node != held.node) {
      a.bt[at] = b.total;
      a.br[at] = b.rank;
      a.bn[at] = b.node;
    }
  }
}

// <kGeneral, kStaged, kAllColumns, kFaults>: kStaged is the staged form,
// false the global one; <true, true, false> is the staged general kernel
// for the configurations without Simon (policy_pair); kFaults is the fault
// form, as replay_body's. A fault step touches one node, as an event does,
// so the dirty node's block summaries stay the one update a step. kKeyOut
// is the chunk form and kRecord the record form, as replay_body's (the
// blocked decision row carries the winner's block).
template <bool kGeneral, bool kStaged = true, bool kAllColumns = true,
          bool kFaults = false, bool kKeyOut = false, bool kRecord = false,
          bool kLearned = false>
__device__ __forceinline__ void replay_blocked_body(const ReplayArgs& a) {
  constexpr int kWarps = kReplayThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Best warp_res[kWarps];
  __shared__ int warp_lo[kWarps][kMaxPolicies];
  __shared__ int warp_hi[kWarps][kMaxPolicies];
  __shared__ EventState es;
  __shared__ FaultSharedOf<kFaults> fsh;
  FaultShared* fs = fault_shared<kFaults>(fsh);
  __shared__ RecordSharedOf<kRecord> rsh;
  RecordShared* rs = record_shared<kRecord>(rsh);
  __shared__ int s_rank[kBlock];  // the dirty block's tie-break ranks
  __shared__ int s_rescans;
  __shared__ long long s_clk[kNumClocks];
  __shared__ long long s_work[3];
  PhaseClock pc;
  pc.start(s_clk);
  if (kClocked && threadIdx.x == 0) s_work[0] = s_work[1] = s_work[2] = 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nblk = a.n / kBlock;
  const int gpu_sel = kGeneral ? a.gpu_sel : (a.sel >= 0 ? kSelSelf : kSelBest);
  int nn = 0;  // normalised policies: the rows of brmin/brmax and slo/shi
  if (kGeneral)
    for (int pi = 0; pi < a.n_pol; ++pi) nn += a.pol_norm[pi] != kNormNone ? 1 : 0;
  const int n_pol = kGeneral ? a.n_pol : 1;
  if constexpr (kLearned) learned_rows(a);
  const Smem m = replay_smem<kStaged>(a, smem, n_pol, true);
  const bool fgd_terms = begin_replay<kGeneral, kStaged>(a, m, es);
  stage_faults<kFaults>(a, fs, 0, true);
  if constexpr (kRecord) {
    if (tid == 0) record_begin(a, *rs);
  }

  // the summaries of the initial tables: every block's extrema, the stored
  // extrema as their min/max over blocks, then every block's summary under
  // the stored extrema (one warp per (type, block))
  if (nn > 0) {
    for (int w = warp; w < a.k * nblk; w += nwarps)
      summarize_block<kGeneral>(a, w / nblk, w % nblk, a.slo, a.shi, 0, true,
                                lane, a.rank + (w % nblk) * kBlock);
    __syncthreads();
    for (int w = warp; w < nn * a.k; w += nwarps) {
      const size_t row = static_cast<size_t>(w) * nblk;
      int lo = INT_MAX;
      int hi = -INT_MAX;
      for (int c = lane; c < nblk; c += 32) {
        lo = min(lo, a.brmin[row + c]);
        hi = max(hi, a.brmax[row + c]);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        a.slo[w] = lo;
        a.shi[w] = hi;
      }
    }
    __syncthreads();
  }
  for (int w = warp; w < a.k * nblk; w += nwarps) {
    const int t = w / nblk;
    const int c = w % nblk;
    summarize_block<kGeneral>(a, t, c, a.slo + t, a.shi + t, a.k, false,
                              lane, a.rank + c * kBlock);
  }
  if (tid == 0) {
    a.stats[0] = 0;  // waits and starts: the kernel issues no async copies
    a.stats[1] = 0;
    a.stats[2] = 0;  // summary-row rebuilds
  }
  __syncthreads();
  if constexpr (kFaults) {
    if (warp == 0) pop_ahead(a, es, *fs, 0, lane);
    __syncthreads();
  }
  pc.mark(kClkInit);
  const long long t0 = clock_now();

  for (int i = 0; i < a.e; ++i) {
    prefetch_events(a, es, i);
    stage_faults<kFaults>(a, fs, i);
    // refresh the column of the node the previous event changed, then that
    // node's block summaries of every type under the stored extrema
    const int dirty = es.dirty[i & 1];
    if (dirty >= 0) {
      const int c = dirty / kBlock;
      if (tid < kBlock) s_rank[tid] = a.rank[c * kBlock + tid];
      if (tid == 0) {
        s_rescans = 0;
        pc.count(kClkRefreshes, 1);
      }
      const long long t_ref = clock_now();
      refresh_column<kGeneral, true, kAllColumns, false, kLearned>(
          a, m, es, dirty, s_work);
      pc.end_work(s_work);
      if (tid == 0) pc.count(kClkItems, es.seg[n_pol]);
      pc.sync();
      pc.finish_work(s_work, t_ref);
      pc.mark(kClkRefresh);
      update_summaries<kGeneral>(a, m, dirty, s_rank[dirty % kBlock],
                                 &s_rescans);
      pc.sync();
      const int rescans = s_rescans;
      if (rescans > 0) {
        for (int r = warp; r < rescans; r += nwarps) {
          const int t = m.rescan[r];
          summarize_block<kGeneral>(a, t, c, a.slo + t, a.shi + t, a.k,
                                    nn > 0, lane, s_rank);
        }
        if (tid == 0) pc.count(kClkRescans, rescans);
        pc.sync();
      }
      pc.mark(kClkBlock);
    }

    const EventFields ev = es.ev[(i / kEvBatch) & 1][i % kEvBatch];
    const int type = ev.type;
    if constexpr (kRecord) {
      if (a.rec_every > 0 && (rs->p0 + i) % a.rec_every == 0)
        record_sample<kLearned>(a, *rs, i, type);
    }
    if (kGeneral && nn > 0) {
      // drift check, every event: the event type's current extrema (the
      // min/max of its block extrema) against the stored ones; if one moved,
      // rebuild the type's summary row over all N under the current extrema
      int lo[kMaxPolicies];
      int hi[kMaxPolicies];
      for (int s = 0; s < nn; ++s) {
        const size_t row = (static_cast<size_t>(s) * a.k + type) * nblk;
        int l = INT_MAX;
        int h = -INT_MAX;
        for (int c = tid; c < nblk; c += blockDim.x) {
          l = min(l, a.brmin[row + c]);
          h = max(h, a.brmax[row + c]);
        }
        l = __reduce_min_sync(0xffffffffu, l);
        h = __reduce_max_sync(0xffffffffu, h);
        if (lane == 0) {
          warp_lo[warp][s] = l;
          warp_hi[warp][s] = h;
        }
      }
      pc.sync();
      bool changed = false;
      for (int s = 0; s < nn; ++s) {  // lane w reads warp w's
        lo[s] = __reduce_min_sync(
            0xffffffffu, lane < nwarps ? warp_lo[lane][s] : INT_MAX);
        hi[s] = __reduce_max_sync(
            0xffffffffu, lane < nwarps ? warp_hi[lane][s] : -INT_MAX);
        changed |= lo[s] != a.slo[s * a.k + type] || hi[s] != a.shi[s * a.k + type];
      }
      if (changed) {  // the same in every thread
        for (int c = warp; c < nblk; c += nwarps)
          summarize_block<kGeneral>(a, type, c, lo, hi, 1, false, lane,
                                    a.rank + c * kBlock);
        pc.sync();  // every thread has read the stored extrema
        if (tid == 0) {
          for (int s = 0; s < nn; ++s) {
            a.slo[s * a.k + type] = lo[s];
            a.shi[s * a.k + type] = hi[s];
          }
          a.stats[2] += 1;
        }
      }
      pc.mark(kClkDrift);
    }

    if (ev.kind == kCreate && ev.pin < 0) {
      // selectHost over the type's block summaries: valid blocks (a total
      // other than -INT_MAX), max total, then min rank, then min block
      const size_t row = static_cast<size_t>(type) * nblk;
      Best b = no_candidate();
      for (int c = tid; c < nblk; c += blockDim.x) {
        const int total = a.bt[row + c];
        if (total == -INT_MAX) continue;
        const Best cand = {total, a.br[row + c], c};
        if (beats(cand, b)) b = cand;
      }
      b = warp_best(b);
      if (lane == 0) warp_res[warp] = b;
      pc.sync();
      pc.mark(kClkSelect);
      if (warp == 0) {
        b = warp_best(lane < nwarps ? warp_res[lane] : no_candidate());
        const int blk = __shfl_sync(0xffffffffu, b.node, 0);
        end_event<false, kFaults>(a, m, es, i, ev,
                                  blk == INT_MAX ? -1 : a.bn[row + blk],
                                  gpu_sel, fgd_terms, n_pol, lane, fs);
      }
    } else if (warp == 0) {
      // a pinned pod has one candidate: its Filter bit decides
      const bool ok = ev.kind == kCreate && ev.pin < a.n &&
                      a.feas[static_cast<size_t>(type) * a.n + ev.pin] != 0;
      end_event<false, kFaults>(a, m, es, i, ev, ok ? ev.pin : -1, gpu_sel,
                                fgd_terms, n_pol, lane, fs);
    }
    pc.sync();
    pc.mark(kClkCommit);
    if constexpr (kRecord) {
      if (ev.kind == kCreate && a.rec_dec != nullptr)
        record_decision<kLearned>(a, *rs, warp_res, i, type, ev.pin,
                                  a.ev_node[i], true);
      if (tid == 0) record_count<kLearned>(a, *rs, i, ev.kind);
    }
  }
  if constexpr (kRecord) {
    if (tid == 0) record_end(a, *rs, a.stats[2]);
  }
  if constexpr (kKeyOut) {
    if (tid == 0) write_key_out<false>(a, es);
  }
  pc.finish(a.clocks, t0);
}

template <bool kGeneral, bool kStaged = true, bool kAllColumns = true,
          bool kFaults = false, bool kKeyOut = false, bool kRecord = false,
          bool kLearned = false>
__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_blocked_kernel(ReplayArgs a) {
  replay_blocked_body<kGeneral, kStaged, kAllColumns, kFaults, kKeyOut,
                      kRecord, kLearned>(a);
}

// ---------------------------------------------------------------------------
// init_tables: the tables of the initial state, laid out for throughput
// (pallas_engine.py's event-0 table build :903-910 and pass 1 of
// _make_hbm_kernel :1669-1701, which build them through the column
// functions of the refresh)
//
// What bounds it: instruction issue. At the scale run's shape the function
// is about 13k float32 and int32 operations a node (node_ops in
// chip_smoke.py, one distinct device value a node) against 1.8 kB of tables
// written, so on paper the bytes bound it; but each of those operations
// takes the kernel several instructions (the fit tests, each type's CPU
// test and select, the Filter's integer divisions), and FGD's sums over the
// typical pods are most of them. So the design does each piece of work once
// where it belongs. A block takes a tile of 32 nodes and, where the tiles
// are too few to fill the card (openb's 1213 nodes are 38), a slice of the
// type batches. It stages the type fields and the typical pods of nonzero
// frequency in shared memory. Per tile, FGD's node-only half (per typical
// pod the fit count and sum over the node's devices and whether the pod
// can be Q3 there, the node's current frag summed in index order, its distinct device
// values, Sub's device order) is computed once per node into [field][node]
// arrays, not once per (type, node) pair. Then each warp takes the tile's
// 32 nodes, one a lane, under one batch of types at a time: the types'
// fields are uniform across the warp, the per-node terms are read without
// bank conflicts, and each table row is written in 128-byte segments. FGD's
// hypothetical frag depends on a type only through its share or whole
// branch, its milli, its GPU count and, per typical pod, whether the pod's
// CPU fits the node after the type's; so the types are batched by the
// first three (up to kBatch of one key) and each pod's term is computed
// once for the batch, each type then taking it or the term without Q3 by
// its own CPU test, in its own sum in index order. A share batch sums one
// hypothetical per distinct device value of the node (share_term's
// algebra), a whole batch its Sub's pick, updating the node's fit counts
// and sums where the taken devices had one value (whole_term_same's). PWR's
// and DotProduct's node figures are computed once per node, and Sub's pick
// comes from the staged order.
// ---------------------------------------------------------------------------

// a tile's node fields in shared memory, [field][node]
enum NodeField {
  kNfCpu, kNfMem, kNfCap, kNfGcnt, kNfGtyp, kNfCtyp, kNfG,
  kNfAff = kNfG + kDevs, kNodeFields = kNfAff + kAffClasses,
};

// Added to a node's staged fit count where typical pod t can be Q3 on it
// (a GPU request whose model mask the node passes), and to the staged t_num:
// where it cannot, the count stays below every t_num.
constexpr int kQa = 16;

// The dynamic shared memory of init_tables (carve_init lays it out).
// Staged once per block: the typical pods of nonzero frequency (tq: milli,
// num + kQa, cpu, frequency bits; tmask) and the type fields t_*. Per tile,
// each [.][kTile]: the node fields; per typical pod t the node's fit word
// fit[t], fit sum << 8 | (kQa + fit count where t can be Q3 there, else 0);
// the node's current frag, free GPU milli and number of distinct device
// values that some share type fits (uval, the first device of each in
// ufirst, in device order); and its devices in Sub's order, least free
// first, ties by index, each as 8 x free milli + device. Per block: the
// types in batches (torder from fused_engine.type_order, bstart); per
// warp its batch's FGD scores and device picks, [type][node].
struct InitSmem {
  int4* tq;
  int* tmask;
  int* t_cpu;
  int* t_mem;
  int* t_milli;
  int* t_num;
  int* t_mask;
  int* node;
  int* fit;
  float* cur;
  int* gsum;
  int* nv;
  int* uval;
  int* ufirst;
  int* sorted;
  int* torder;
  int* bstart;
  int* fscore;
  int* fdev;
};

// Lays the arrays out from `base` (nullptr: sizes only); returns the bytes.
__host__ __device__ inline size_t carve_init(unsigned char* base, int k, int t,
                                             InitSmem* m) {
  Carver c{base, 0};
  InitSmem s;
  s.tq = c.take<int4>(t);
  s.tmask = c.take<int>(t);
  s.t_cpu = c.take<int>(k);
  s.t_mem = c.take<int>(k);
  s.t_milli = c.take<int>(k);
  s.t_num = c.take<int>(k);
  s.t_mask = c.take<int>(k);
  s.node = c.take<int>(kNodeFields * kTile);
  s.fit = c.take<int>(static_cast<long long>(t) * kTile);
  s.cur = c.take<float>(kTile);
  s.gsum = c.take<int>(kTile);
  s.nv = c.take<int>(kTile);
  s.uval = c.take<int>(kDevs * kTile);
  s.ufirst = c.take<int>(kDevs * kTile);
  s.sorted = c.take<int>(kDevs * kTile);
  s.torder = c.take<int>(k);
  s.bstart = c.take<int>(k);
  s.fscore = c.take<int>(kInitThreads / 32 * kBatch * kTile);
  s.fdev = c.take<int>(kInitThreads / 32 * kBatch * kTile);
  if (m != nullptr) *m = s;
  return c.off;
}

// Stages the type fields and order, the typical pods whose frequency is
// not 0 in order (their count to *t_count; stage() says why that is exact),
// and the least milli a share type requests (*min_p).
__device__ void stage_init(const ReplayArgs& a, const InitSmem& m,
                           int* t_count, int* min_p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    int kept = 0;
    for (int base = 0; base < a.t; base += 32) {
      const int t = base + lane;
      const bool keep = t < a.t && a.tp_freq[t] != 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int at = kept + __popc(mask & ((1u << lane) - 1));
        m.tq[at] = make_int4(a.tp_milli[t], a.tp_num[t] + kQa, a.tp_cpu[t],
                             __float_as_int(a.tp_freq[t]));
        m.tmask[at] = a.tp_mask[t];
      }
      kept += __popc(mask);
    }
    if (lane == 0) *t_count = kept;
  } else if (warp == 1) {
    int mp = INT_MAX;
    for (int k = lane; k < a.ks; k += 32) mp = min(mp, a.t_milli[k]);
    mp = __reduce_min_sync(0xffffffffu, mp);
    if (lane == 0) *min_p = mp;
  }
  for (int k = threadIdx.x; k < a.k; k += blockDim.x) {
    m.t_cpu[k] = a.t_cpu[k];
    m.t_mem[k] = a.t_mem[k];
    m.t_milli[k] = a.t_milli[k];
    m.t_num[k] = a.t_num[k];
    m.t_mask[k] = a.t_mask[k];
    m.torder[k] = a.t_order[k];
  }
}

// The fields of nodes first .. first + count - 1 into m.node; the rest of
// the tile holds nodes without resources or GPUs, which nothing writes out.
__device__ void load_tile(const ReplayArgs& a, const InitSmem& m, int first,
                          int count) {
  for (int i = threadIdx.x; i < kNfG * kTile; i += blockDim.x) {
    const int f = i / kTile;
    const int j = i % kTile;
    int x = f == kNfGtyp ? -1 : 0;
    if (j < count) {
      const int* src = f == kNfCpu    ? a.cpu_left
                       : f == kNfMem  ? a.mem_left
                       : f == kNfCap  ? a.cpu_cap
                       : f == kNfGcnt ? a.gpu_cnt
                       : f == kNfGtyp ? a.gpu_type
                                      : a.cpu_type;
      x = src[first + j];
    }
    m.node[i] = x;
  }
  // in gpu_left's and aff_cnt's own order, so that the loads coalesce
  const size_t base = static_cast<size_t>(first);
  for (int i = threadIdx.x; i < kDevs * kTile; i += blockDim.x) {
    const int j = i / kDevs;
    m.node[(kNfG + i % kDevs) * kTile + j] =
        j < count ? a.gpu_left[base * kDevs + i] : 0;
  }
  for (int i = threadIdx.x; i < kAffClasses * kTile; i += blockDim.x) {
    const int j = i / kAffClasses;
    m.node[(kNfAff + i % kAffClasses) * kTile + j] =
        j < count ? a.aff_cnt[base * kAffClasses + i] : 0;
  }
}

__device__ __forceinline__ NodeView tile_node(const InitSmem& m, int j) {
  NodeView v;
  v.cpu = m.node[kNfCpu * kTile + j];
  v.mem = m.node[kNfMem * kTile + j];
  v.cap = m.node[kNfCap * kTile + j];
  v.gcnt = m.node[kNfGcnt * kTile + j];
  v.gtyp = m.node[kNfGtyp * kTile + j];
  v.ctyp = m.node[kNfCtyp * kTile + j];
  v.bit = v.gtyp >= 0 ? (1 << v.gtyp) : 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) v.g[d] = m.node[(kNfG + d) * kTile + j];
#pragma unroll
  for (int c = 0; c < kAffClasses; ++c)
    v.aff[c] = m.node[(kNfAff + c) * kTile + j];
  return v;
}

// The tile's node-only terms: with `fgd`, each node's fit word per typical
// pod (a thread per (pod, node)); every node's free GPU milli, distinct
// device values and Sub's order (a lane per (node, device), 4 nodes a warp).
__device__ void tile_terms(const InitSmem& m, int t_count, int min_p,
                           bool fgd) {
  const unsigned lane = threadIdx.x & 31;
  if (fgd) {
    // blockDim is a multiple of kTile, so this thread's node is fixed
    const int j = threadIdx.x % kTile;
    int g[kDevs];
#pragma unroll
    for (int d = 0; d < kDevs; ++d) g[d] = m.node[(kNfG + d) * kTile + j];
    const int gtyp = m.node[kNfGtyp * kTile + j];
    const int bit = gtyp >= 0 ? (1 << gtyp) : 0;
    for (int i = threadIdx.x; i < t_count * kTile; i += blockDim.x) {
      const int t = i / kTile;
      const int milli = m.tq[t].x;
      const int mask = m.tmask[t];
      int fitcnt = 0;
      int fitsum = 0;
#pragma unroll
      for (int d = 0; d < kDevs; ++d) {
        if (milli > 0 && g[d] >= milli) {
          ++fitcnt;
          fitsum += g[d];
        }
      }
      const bool qa = milli > 0 && (mask == 0 || (mask & bit) != 0);
      m.fit[i] = (fitsum << 8) | (qa ? fitcnt + kQa : 0);
    }
  }
  static_assert(kTile * kDevs % kInitThreads == 0, "whole warps per round");
  for (int i = threadIdx.x; i < kTile * kDevs; i += blockDim.x) {
    const int j = i / kDevs;
    const int d = i % kDevs;
    const int gd = m.node[(kNfG + d) * kTile + j];
    int rank = 0;
    int gsum = 0;
#pragma unroll
    for (int e = 0; e < kDevs; ++e) {
      const int ge = m.node[(kNfG + e) * kTile + j];
      rank += (ge < gd || (ge == gd && e < d)) ? 1 : 0;
      gsum += ge;
    }
    m.sorted[rank * kTile + j] = gd * kDevs + d;
    // the first device of each value that some share type fits
    const unsigned same = __match_any_sync(
        0xffffffffu, (static_cast<unsigned long long>(j) << 32) |
                         static_cast<unsigned>(gd));
    const bool keep = __ffs(same) - 1 == static_cast<int>(lane) && gd >= min_p;
    const unsigned kept =
        __ballot_sync(0xffffffffu, keep) & (0xffu << (lane & ~7u));
    if (keep) {
      const int at = __popc(kept & ((1u << lane) - 1));
      m.uval[at * kTile + j] = gd;
      m.ufirst[at * kTile + j] = d;
    }
    if (d == 0) {
      m.nv[j] = __popc(kept);
      m.gsum[j] = gsum;
    }
  }
}

// node j's current frag from its fit words, summed in index order as
// fgd_pair sums it
__device__ float current_frag(const InitSmem& m, int t_count, int j) {
  const int gsum = m.gsum[j];
  const int cpu = m.node[kNfCpu * kTile + j];
  const float total = static_cast<float>(gsum);
  float c = 0.0f;
  for (int t = 0; t < t_count; ++t) {
    const int4 q = m.tq[t];
    const int w = m.fit[t * kTile + j];
    const bool q3 = (w & 0xff) >= q.y && cpu >= q.z;
    c = __fadd_rn(c, __fmul_rn(__int_as_float(q.w),
                               q3 ? static_cast<float>(gsum - (w >> 8))
                                  : total));
  }
  return c;
}

// Typical pod t's term for a share type of p milli placed on a device with
// gd free, on the tile's node of fit word w, where the pod's CPU fits the
// node after the type's (share_term with its CPU test true); where it does
// not, the term is freq x (gsum - p)
__device__ __forceinline__ float share_fit_term(int4 q, int w, int gd, int p,
                                                int gsum) {
  const int gdp = gd - p;
  const bool fit = gd >= q.x;
  const bool fitp = gdp >= q.x;
  const int cnt = (w & 0xff) - (fit ? 1 : 0) + (fitp ? 1 : 0);
  const int sum = (w >> 8) - (fit ? gd : 0) + (fitp ? gdp : 0);
  return __fmul_rn(__int_as_float(q.w),
                   static_cast<float>(cnt >= q.y ? gsum - p - sum : gsum - p));
}

// whole_term_same's term where the pod's CPU fits; else freq x g2sum
__device__ __forceinline__ float whole_fit_term_same(int4 q, int w, int ntk,
                                                     int v, int v2,
                                                     int g2sum) {
  const int cnt = (w & 0xff) + ntk * ((v2 >= q.x ? 1 : 0) - (v >= q.x ? 1 : 0));
  const int sum = (w >> 8) + ntk * ((v2 >= q.x ? v2 : 0) - (v >= q.x ? v : 0));
  return __fmul_rn(__int_as_float(q.w),
                   static_cast<float>(cnt >= q.y ? g2sum - sum : g2sum));
}

// whole_term's term where the pod's CPU fits (the fit word's kQa bit says
// whether t can be Q3 on the node); else freq x g2sum
__device__ __forceinline__ float whole_fit_term(int4 q, int w, Devs g2,
                                                int g2sum) {
  int cnt = w & kQa;
  int sum = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    if (g2.g[d] >= q.x) {
      ++cnt;
      sum += g2.g[d];
    }
  }
  return __fmul_rn(__int_as_float(q.w),
                   static_cast<float>(cnt >= q.y ? g2sum - sum : g2sum));
}

// The hypothetical frags of a batch of types that differ only in their CPU
// request, on the tile's node j: acc[i] = sum_t freq_t x term_t in index
// order, fgd_pair's sum for type i. `fit_term(q, w)` is term_t where the
// pod's CPU fits the node after the type's (cpu_x[i] >= the pod's cpu),
// `rest` the frag left where it does not. Each pod's term is computed once
// for the batch, kRound4 pods at a time before any is added.
constexpr int kRound4 = 4;

template <typename FitTerm>
__device__ __forceinline__ void batch_sums(const InitSmem& m, int t_count,
                                           int j, const int cpu_x[kBatch],
                                           float rest, float acc[kBatch],
                                           FitTerm fit_term) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) acc[i] = 0.0f;
  for (int base = 0; base < t_count; base += kRound4) {
    float fits[kRound4];
    float rests[kRound4];
    int cpus[kRound4];
#pragma unroll
    for (int r = 0; r < kRound4; ++r) {
      const int t = min(base + r, t_count - 1);
      const int4 q = m.tq[t];
      fits[r] = fit_term(q, m.fit[t * kTile + j]);
      rests[r] = __fmul_rn(__int_as_float(q.w), rest);
      cpus[r] = q.z;
    }
#pragma unroll
    for (int r = 0; r < kRound4; ++r) {
      if (base + r < t_count) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          acc[i] = __fadd_rn(acc[i], cpu_x[i] >= cpus[r] ? fits[r] : rests[r]);
      }
    }
  }
}

// Sub's pick (packed_take) on the tile's node j from its staged order: the
// taken devices as bits, their count, and the least and most free milli
// among them
__device__ __forceinline__ unsigned sub_pick(const InitSmem& m, int j, int p,
                                             int wn, int* ntk, int* lo,
                                             int* hi) {
  unsigned taken = 0;
  int c = 0;
  int l = INT_MAX;
  int h = INT_MIN;
#pragma unroll
  for (int r = 0; r < kDevs; ++r) {
    const int key = m.sorted[r * kTile + j];
    const int gd = key >> 3;
    const bool take = p > 0 && gd >= p && c < wn;
    taken |= take ? 1u << (key & (kDevs - 1)) : 0u;
    c += take ? 1 : 0;
    l = take ? min(l, gd) : l;
    h = take ? max(h, gd) : h;
  }
  *ntk = c;
  *lo = l;
  *hi = h;
  return taken;
}

// The first positions of the batches of m.torder (the types by FGD's key,
// share or whole, milli and GPU count) into m.bstart, their count to
// *batches, by one warp: a batch starts where the key changes and every
// kBatch types of one key after that.
__device__ void list_batches(const ReplayArgs& a, const InitSmem& m,
                             int* batches) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  int key_at = 0;  // where the key of the position before this round began
  for (int base = 0; base < a.k; base += 32) {
    const int r = base + lane;
    bool new_key = r == 0;
    if (r > 0 && r < a.k) {
      const int k = m.torder[r];
      const int q = m.torder[r - 1];
      new_key = (k < a.ks) != (q < a.ks) || m.t_milli[k] != m.t_milli[q] ||
                m.t_num[k] != m.t_num[q];
    }
    const unsigned keys = __ballot_sync(0xffffffffu, new_key);
    const unsigned upto = keys & (0xffffffffu >> (31 - lane));
    const int at = upto != 0 ? base + 31 - __clz(upto) : key_at;
    const bool start = r < a.k && (r - at) % kBatch == 0;
    const unsigned mask = __ballot_sync(0xffffffffu, start);
    if (start) m.bstart[n + __popc(mask & ((1u << lane) - 1))] = r;
    n += __popc(mask);
    key_at = keys != 0 ? base + 31 - __clz(keys) : key_at;
  }
  if (lane == 0) *batches = n;
}

// FGD's scores (and share-device picks) of the types of positions r0 ..
// r0 + bn - 1 of m.torder, one key, on the tile's node of this lane, into
// this warp's m.fscore / m.fdev rows: a share batch sums each distinct
// device value of the node that holds p, keeping each type's best (the
// first device on ties); a whole batch sums its Sub's pick, updating the
// node's fit counts and sums where the taken devices had one value.
__device__ void fgd_batch(const InitSmem& m, int t_count, int lane, int warp,
                          const NodeView& v, int r0, int bn, bool share,
                          int p, int wn, float cur, int gsum, int nv,
                          int nvmax) {
  int cpu_x[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    cpu_x[i] = i < bn ? v.cpu - m.t_cpu[m.torder[r0 + i]] : INT_MIN;
  float acc[kBatch];
  int* fscore = m.fscore + warp * kBatch * kTile + lane;
  int* fdev = m.fdev + warp * kBatch * kTile + lane;
  if (share) {  // each type's best so far in fscore / fdev
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      fscore[i * kTile] = -1;
      fdev[i * kTile] = -1;
    }
    for (int u = 0; u < nvmax; ++u) {
      const int gd = u < nv ? m.uval[u * kTile + lane] : -1;
      if (u < nv && gd >= p) {
        batch_sums(m, t_count, lane, cpu_x, static_cast<float>(gsum - p), acc,
                   [=](int4 q, int w) {
                     return share_fit_term(q, w, gd, p, gsum);
                   });
        const int first = m.ufirst[u * kTile + lane];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int s = sigmoid_score(cur, acc[i]);
          if (s > fscore[i * kTile]) {
            fscore[i * kTile] = s;
            fdev[i * kTile] = first;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      fscore[i * kTile] = max(fscore[i * kTile], 0);
    return;
  }
  int ntk;
  int lo;
  int hi;
  const unsigned taken = sub_pick(m, lane, p, wn, &ntk, &lo, &hi);
  Devs g2;
  int g2sum = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    g2.g[d] = v.g[d] - ((taken >> d) & 1 ? p : 0);
    g2sum += g2.g[d];
  }
  const int vt = ntk == 0 ? 0 : lo;
  const float rest = static_cast<float>(g2sum);
  if (__all_sync(0xffffffffu, ntk == 0 || lo == hi)) {  // the warp's branch
    batch_sums(m, t_count, lane, cpu_x, rest, acc, [=](int4 q, int w) {
      return whole_fit_term_same(q, w, ntk, vt, vt - p, g2sum);
    });
  } else {
    batch_sums(m, t_count, lane, cpu_x, rest, acc, [=](int4 q, int w) {
      return whole_fit_term(q, w, g2, g2sum);
    });
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    fscore[i * kTile] = sigmoid_score(cur, acc[i]);
    fdev[i * kTile] = -1;
  }
}

// The table entries of the tile's nodes first .. first + count - 1 for
// slice `slice` of `slices` of the type batches: warp w takes batches
// (slice x warps + w) + i x slices x warps, a lane per node, FGD's sums
// for the whole batch at once, then every table policy type by type.
// <false> is the paper's FGD shape (fgd_only); <true> reads the policy
// descriptor.
template <bool kGeneral>
__device__ void tile_items(const ReplayArgs& a, const InitSmem& m,
                           int t_count, int batches, int first, int count,
                           int slice, int slices, bool fgd, bool pwr,
                           bool pack, bool dot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int n_pol = kGeneral ? table_rows(a) : 1;
  const NodeView v = tile_node(m, lane);
  const bool valid = lane < count;
  const size_t node = static_cast<size_t>(first) + lane;
  const int gsum = m.gsum[lane];
  const float cur = fgd ? m.cur[lane] : 0.0f;
  const int nv = m.nv[lane];
  const int nvmax = __reduce_max_sync(0xffffffffu, nv);
  const int fully_free = idle_count(v);
  PwrNode pw{};
  if (kGeneral && pwr) pw = pwr_node(a, v);
  DotNode dn{};
  if (kGeneral && dot) dn = dot_node(a, v);
  for (int b = slice * warps + warp; b < batches; b += slices * warps) {
    const int r0 = m.bstart[b];
    const int bn = (b + 1 < batches ? m.bstart[b + 1] : a.k) - r0;
    const int k0 = m.torder[r0];
    const int p = m.t_milli[k0];
    const int wn = m.t_num[k0];
    const bool share = k0 < a.ks;
    if (fgd)
      fgd_batch(m, t_count, lane, warp, v, r0, bn, share, p, wn, cur, gsum, nv,
                nvmax);
    const bool pwr_share_type = wn == 1 && p < kMilli;
    int ntk = 0;
    int lo = INT_MAX;
    int hi = INT_MIN;
    unsigned taken = 0;
    if ((pwr && !pwr_share_type) || pack)  // warp-uniform
      taken = sub_pick(m, lane, p, wn, &ntk, &lo, &hi);
    bool take[kDevs];
#pragma unroll
    for (int d = 0; d < kDevs; ++d) take[d] = (taken >> d) & 1;
    for (int i = 0; i < bn; ++i) {
      const int k = m.torder[r0 + i];
      const int tcpu = m.t_cpu[k];
      int sel_dev = -1;
      for (int pi = 0; pi < n_pol; ++pi) {
        int score = 0;
        int dev = -1;
        switch (kGeneral ? a.pol_column[pi] : kFgd) {
          case kFgd:
            score = m.fscore[(warp * kBatch + i) * kTile + lane];
            dev = m.fdev[(warp * kBatch + i) * kTile + lane];
            break;
          case kBestFit:
            score = bestfit_pair(a, v, k);
            break;
          case kPacking:
            if (p * wn > 0) {
              score = fully_free == v.gcnt
                          ? max(kMaxNodeScore / 3 - fully_free, fully_free)
                          : (ntk >= wn ? packing_tiers(v, take) : 0);
            }
            break;
          case kClustering:  // a copy it may index at run time: v stays
            score = clustering_pair(a, tile_node(m, lane), k);  // in registers
            break;
          case kPwr: {
            const float base =
                __fadd_rn(cpu_watts(a, v, v.cpu - tcpu), pw.gpu_old);
            if (pwr_share_type) {
              pwr_share(v, pw, base, p, &score, &dev);
            } else {
              score = pwr_whole(v, pw, base, wn, take);
            }
            break;
          }
          case kSimon:
            score = simon_pair(a, v, valid ? a.mem_cap[node] : 0, k);
            break;
          case kDotProd:
          default:
            dotprod_score(a, tile_node(m, lane), dn, k, &score, &dev);
            break;
        }
        if (valid)
          a.score[(static_cast<size_t>(pi) * a.k + k) * a.n + node] = score;
        if (pi == a.sel) sel_dev = dev;
      }
      if (valid) {
        const size_t at = static_cast<size_t>(k) * a.n + node;
        a.sdev[at] = sel_dev;
        // whole GPUs divide by a constant (the same quotients, fewer steps)
        a.feas[at] = p == kMilli
                         ? feas_of(v, tcpu, m.t_mem[k], kMilli, wn, m.t_mask[k])
                         : feas_of(v, tcpu, m.t_mem[k], p, wn, m.t_mask[k]);
      }
    }
  }
}

// Block b builds slice b % slices of the type batches on tile b / slices.
template <bool kGeneral>
__global__ void __launch_bounds__(kInitThreads)
    init_tables_kernel(ReplayArgs a, int slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_t_count;
  __shared__ int s_min_p;
  __shared__ int s_batches;
  InitSmem m;
  carve_init(smem, a.k, a.t, &m);
  stage_init(a, m, &s_t_count, &s_min_p);
  const int first = static_cast<int>(blockIdx.x / slices) * kTile;
  const int count = min(kTile, a.n - first);
  load_tile(a, m, first, count);
  bool fgd = !kGeneral;
  bool pwr = false;
  bool pack = false;
  bool dot = false;
  if (kGeneral) {
    for (int pi = 0; pi < a.n_pol; ++pi) {
      fgd |= a.pol_column[pi] == kFgd;
      pwr |= a.pol_column[pi] == kPwr;
      pack |= a.pol_column[pi] == kPacking;
      dot |= a.pol_column[pi] == kDotProd;
    }
  }
  __syncthreads();
  const int t_count = s_t_count;
  tile_terms(m, t_count, s_min_p, fgd);
  __syncthreads();
  if (fgd && threadIdx.x < kTile)
    m.cur[threadIdx.x] = current_frag(m, t_count, threadIdx.x);
  if ((threadIdx.x >> 5) == 1) list_batches(a, m, &s_batches);
  __syncthreads();
  tile_items<kGeneral>(a, m, t_count, s_batches, first, count,
                       blockIdx.x % slices, slices, fgd, pwr, pack, dot);
}

#ifndef TPUSIM_LANES_TU  // replay_lanes.cu compiles the lanes kernels alone

// init_tables' global form, for shapes past the staged limits: a thread per
// (type, node), nodes fastest, through the column functions of policy_pair
// (FGD's fgd_pair sums every typical pod, where a pod of frequency 0 adds
// zero), reading the types and typical pods from device memory.
__global__ void __launch_bounds__(kInitThreads) init_pairs_kernel(ReplayArgs a) {
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
    policy_pair(a, v, pi, k, node, &score, &dev);
    a.score[(static_cast<size_t>(pi) * a.k + k) * a.n + node] = score;
    if (pi == a.sel) sel_dev = dev;
  }
  const size_t at = static_cast<size_t>(k) * a.n + node;
  a.sdev[at] = sel_dev;
  a.feas[at] = feas_pair(a, v, k);
}

// an empty kernel: what a launch costs without work
__global__ void empty_kernel() {}

#endif  // TPUSIM_LANES_TU

// whether a shape fits the staged forms (shared memory)
bool staged_shape(const ReplayArgs* a) {
  return a->k <= kMaxTypes && a->t <= kMaxTypical;
}

// whether a configuration has a policy of column `column`
bool has_column(const ReplayArgs* a, int column) {
  for (int pi = 0; pi < a->n_pol; ++pi)
    if (a->pol_column[pi] == column) return true;
  return false;
}

// a configuration with a learned column (fit_dev_pct's or the node
// column): the kLearned instantiations run it
bool learned(const ReplayArgs* a) {
  return has_column(a, kFitDev) || has_column(a, kLearnedNode);
}

// a configuration that draws per event: RandomScore or gpu_sel random
bool randomized(const ReplayArgs* a) {
  return a->gpu_sel == kSelRandom || has_column(a, kRandomScore);
}

// the paper's shape: one FGDScore policy without normalisation, gpu_sel
// FGDScore (sel 0) or best
bool fgd_only(const ReplayArgs* a) {
  return a->n_pol == 1 && a->pol_column[0] == kFgd &&
         a->pol_norm[0] == kNormNone &&
         (a->gpu_sel == kSelBest || (a->gpu_sel == kSelSelf && a->sel == 0));
}

// the record operands: counters always, a decision row an event where
// rec_dec is set, the sample rows where rec_every > 0 (the frag tree's
// three levels take at most 32^3 typical pods), a ring where hb_ring is
inline bool record_operands(const ReplayArgs* a) {
  if (a->ctr == nullptr || a->rec_every < 0 || a->hb_every < 0 ||
      a->rec_nodes < 0 || a->rec_nodes > a->n)
    return false;
  if (a->rec_every > 0 && (a->rec_ser == nullptr || a->t > 32 * 32 * 32))
    return false;
  if (a->hb_ring != nullptr && a->hb_slots < 1) return false;
  return true;
}

// Launches a replay kernel: the staged form (no scratch) with the dynamic
// shared memory its shape needs, which refuses a shape past the staged
// limits; the global form (a scratch buffer) with none.
template <typename Kernel>
int launch_replay(Kernel kernel, const ReplayArgs* a, bool general,
                  bool blocked, cudaStream_t s) {
  const bool staged = a->scratch == nullptr;
  if (a->k < 1 || a->t < 0 || a->ks < 0 || a->ks > a->k ||
      (staged && !staged_shape(a)))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  if (staged) {
    bytes = carve(nullptr, a->k, a->t, general ? a->n_pol : 1, blocked,
                  nullptr);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<1, kReplayThreads, bytes, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Launches init_tables with the dynamic shared memory its shape needs: a
// block per (tile, slice of the type batches). One slice a tile where the
// tiles fill the card; on fewer nodes the batches are sliced until the
// blocks fill it (a slice for each 4 types a warp, about a batch each),
// for the latency of one tile's work falls with its batches. Refuses a shape
// past the staged limits (init_tables launches init_pairs for those). The
// card's resident blocks are looked up once per device and shape.
template <typename Kernel>
int launch_init(Kernel kernel, const ReplayArgs* a, cudaStream_t s) {
  if (!staged_shape(a) || a->t < 0 || a->ks < 0 || a->ks > a->k ||
      a->t_order == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  struct Geometry {
    Kernel kernel;
    int device;
    size_t bytes;
    long long resident;
  };
  static thread_local Geometry last{nullptr, -1, 0, 0};
  const size_t bytes = carve_init(nullptr, a->k, a->t, nullptr);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (last.kernel != kernel || last.device != device || last.bytes != bytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    int sms = 0;
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kInitThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    last = {kernel, device, bytes,
            static_cast<long long>(sms) * std::max(per_sm, 1)};
  }
  const long long tiles = (static_cast<long long>(a->n) + kTile - 1) / kTile;
  constexpr int kTypesPerSlice = 4 * kInitThreads / 32;
  const long long slices = std::max(
      1LL, std::min((last.resident + tiles - 1) / tiles,
                    static_cast<long long>((a->k + kTypesPerSlice - 1) /
                                           kTypesPerSlice)));
  kernel<<<static_cast<unsigned>(tiles * slices), kInitThreads, bytes, s>>>(
      *a, static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef TPUSIM_LANES_TU

extern "C" {

// the learned instantiations (replay_learned.cu, replay_blocked_learned.cu)
int init_tables_learned(const ReplayArgs* a, void* stream);
int replay_learned(const ReplayArgs* a, void* stream);
int replay_blocked_learned(const ReplayArgs* a, void* stream);

int init_tables(const ReplayArgs* a, void* stream) {
  if (static_cast<long long>(a->k) * a->n == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies)
    return static_cast<int>(cudaErrorInvalidValue);
  if (learned(a)) return init_tables_learned(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged_shape(a)) {  // the global form
    if (a->t < 0 || a->ks < 0 || a->ks > a->k)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long pairs = static_cast<long long>(a->k) * a->n;
    init_pairs_kernel<<<static_cast<unsigned>((pairs + kInitThreads - 1) /
                                              kInitThreads),
                        kInitThreads, 0, s>>>(*a);
    return static_cast<int>(cudaGetLastError());
  }
  if (fgd_only(a)) return launch_init(init_tables_kernel<false>, a, s);
  return launch_init(init_tables_kernel<true>, a, s);
}

// Bytes of the replays' scratch buffer in the global form: the arrays the
// staged form keeps in shared memory (carve)
size_t replay_scratch_bytes(int k, int t, int n_pol, int blocked) {
  return carve(nullptr, k, t, n_pol, blocked != 0, nullptr);
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// the chunk forms (replay_chunks.cu), which write the key chain's key out
int replay_chunk(const ReplayArgs* a, void* stream);
int replay_blocked_chunk(const ReplayArgs* a, void* stream);
// the record forms (replay_records.cu, replay_blocked_records.cu), which
// write the records out
int replay_record(const ReplayArgs* a, void* stream);
int replay_blocked_record(const ReplayArgs* a, void* stream);

int replay(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies)
    return static_cast<int>(cudaErrorInvalidValue);
  if (learned(a)) return replay_learned(a, stream);
  if (a->ctr != nullptr) return replay_record(a, stream);
  if (a->key_out != nullptr) return replay_chunk(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = a->scratch == nullptr;
  if (randomized(a)) {
    if (staged)
      return launch_replay(replay_kernel<true, true, true>, a, true, false, s);
    return launch_replay(replay_kernel<true, true, false>, a, true, false, s);
  }
  if (!staged)
    return launch_replay(replay_kernel<true, false, false>, a, true, false, s);
  if (fgd_only(a)) return launch_replay(replay_kernel<false>, a, false, false, s);
  return launch_replay(replay_kernel<true>, a, true, false, s);
}

// the randomized configurations run the flat replay only
int replay_blocked(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies || a->n % kBlock != 0 ||
      randomized(a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (learned(a)) return replay_blocked_learned(a, stream);
  if (a->ctr != nullptr) return replay_blocked_record(a, stream);
  if (a->key_out != nullptr) return replay_blocked_chunk(a, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->scratch != nullptr)
    return launch_replay(replay_blocked_kernel<true, false>, a, true, true, s);
  if (fgd_only(a))
    return launch_replay(replay_blocked_kernel<false>, a, false, true, s);
  if (has_column(a, kSimon))
    return launch_replay(replay_blocked_kernel<true>, a, true, true, s);
  return launch_replay(replay_blocked_kernel<true, true, false>, a, true, true,
                       s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // TPUSIM_LANES_TU
