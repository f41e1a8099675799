// The teacher-forced form of `replay` (replaces the lax.scan of tpusim's
// TeacherReplay, tpusim/learn/dataset.py :73-360; tpusim_torch/learn/
// dataset.py): the flat replay's event loop over a learned family's tables
// (the kLearned columns, replay_learned.cu), where each create is bound to
// the node a decision log recorded (ReplayArgs::fr_node) instead of the
// select's winner. Per create it writes the family's own argmax under the
// launch's weights (max weighted total, then min tie-break rank, then min
// node), the feasible count, and the family's feature rows at the recorded
// top-3 and at the argmax; then Reserve and Bind the recorded node, with
// the device the recorded gpuSelMethod picks there: best or worst fit, or
// a selector's own pick (FGDScore, PWRScore, DotProductScore: fr_sel, its
// column function evaluated at the recorded node only, for the family need
// not hold it), best fit where it has none. A delete returns the recorded
// placement. The weights are an operand, so the agreement of many weight
// vectors reuses one build.
//
// What bounds it: like `replay`, the serial chain of events on one SM. The
// recorded node and top-3 are known when the event is staged, and the
// state they read is final once the previous commit is, so the create's
// side work runs beside the select instead of after it: warps 0-11 select
// over all N nodes (the block reductions; the family's policies are
// normalised "none", the host refuses others), warps 12-14 each compute
// one recorded top-3 row, and warp 15 the selector's pick at the recorded
// node, a lane per distinct device value (or device, or DotProduct slot)
// with each sum over the typical pods in index order, so that the pick is
// the column function's bit for bit (warp_select_pick). After the select,
// warp 0 commits while warp 2 computes the argmax's row (a copy of a
// top-3 row at the same node where there is one; warp 0 computes it
// before committing where the argmax is the recorded node, whose state
// the commit changes). A row (warp_family_row): a table policy's raw
// score at the node, the node-only features by the warp as warp 1's node
// stage computes them (warp_feature_sums: the lanes' pod terms, then
// three lanes' plan-ordered sums, in shared memory). Every row reads the
// state from before the event's commit. A row or pick on one thread
// each, after the select, would put ~30 us an event on the chain.
// Non-create events write pick -1, feasible 0 and feature rows of -1.
//
// Compiled apart, in parallel with the others. The kernel's body is
// compiled here in the main build and by replay_forced_clocked.cu, a
// source of its own, in the clocked one (the phase clocks: refresh,
// select, the feature rows, the selector's pick, commit, warp 1's node
// stage), where `replay_forced` launches that. Interface: plain C, bound
// with ctypes; the launcher returns the CUDA error code of the launch and
// never synchronises.

#define TPUSIM_LANES_TU
#include "replay.cu"

#if defined(TPUSIM_PHASE_CLOCKS) == defined(TPUSIM_FORCED_CLOCKED_TU)
namespace {

// the create's roles: warps 0 .. kSelectWarps - 1 select, warp kRowWarp
// + j computes the recorded top-3's row j, warp kPickWarp the selector's
// pick (during the select); warp kArgWarp the argmax's row (after it)
constexpr int kForcedWarps = kReplayThreads / 32;
constexpr int kSelectWarps = kForcedWarps - 4;
constexpr int kRowWarp = kSelectWarps;
constexpr int kPickWarp = kForcedWarps - 1;
constexpr int kArgWarp = 2;

// A row warp's buffers in dynamic shared memory, after the replay's
// (carve): the typical pods' terms [t] and the three sums' stage lanes
struct RowBuf {
  float4* pods;
  float* slots;
};

__host__ __device__ inline size_t row_buf_bytes(int t) {
  return (static_cast<size_t>(t) * sizeof(float4) + 15) / 16 * 16 +
         3 * kPlanSlots * sizeof(float);
}

// buffer r (0-2: the top-3 rows, 3: the argmax's) of the block
__device__ __forceinline__ RowBuf row_buf(const ReplayArgs& a,
                                          unsigned char* smem, int r) {
  unsigned char* p = smem + carve(nullptr, a.k, a.t, a.n_pol, false,
                                  nullptr) +
                     static_cast<size_t>(r) * row_buf_bytes(a.t);
  return {reinterpret_cast<float4*>(p),
          reinterpret_cast<float*>(
              p + (static_cast<size_t>(a.t) * sizeof(float4) + 15) / 16 *
                      16)};
}

// The family's feature row at `node` for type `type` into out[fam_n], by
// one warp: a table policy's raw score there, a node-only feature the
// node's (features_of over the warp's three sums, warp_feature_sums, as
// node_features computes them). Lane j writes feature j.
__device__ void warp_family_row(const ReplayArgs& a, int type, int node,
                                int* out, const RowBuf& buf, int lane) {
  bool any_node = false;
  for (int j = 0; j < a.fam_n; ++j) any_node |= a.fam_src[j] < 0;
  int f[kNodeFeatures];
  if (any_node) {
    const NodeView v = load_node(a, node);
    const float3 s = warp_feature_sums(a, v, lane, buf.pods, buf.slots);
    features_of(v, a.mem_cap[node], s.x, s.y, s.z, f);
  }
  if (lane < a.fam_n) {
    const int pi = a.fam_src[lane];
    out[lane] = pi < 0 ? f[-1 - pi]
                       : a.score[(static_cast<size_t>(pi) * a.k + type) *
                                     a.n +
                                 node];
  }
}

// FGDScore's share-device pick of share type k on node v (fgd_pair's), by
// one warp: lane u sums the hypothetical frag of the node's u-th distinct
// free milli that fits the type, lane kDevs the node's current frag, each
// over the typical pods in index order, 32 pods' products at a time
// (prod[kDevs + 1][32]: lane l computes pod base + l's products, in
// fgd_pair's operations); then the first device of the best score.
__device__ int warp_fgd_pick(const ReplayArgs& a, const NodeView& v, int k,
                             int lane, float (*prod)[32]) {
  const int p = a.t_milli[k];
  const int gsum = gpu_sum(v);
  const float total = static_cast<float>(gsum);
  const float total_h = static_cast<float>(gsum - p);
  const int cpu_h = v.cpu - a.t_cpu[k];
  // the fitting devices that are the first of their free milli, and the
  // rank of each among them
  bool first[kDevs];
  int rank[kDevs];
  int nv = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {
    bool seen = false;
#pragma unroll
    for (int e = 0; e < d; ++e) seen |= v.g[e] == v.g[d];
    first[d] = v.g[d] >= p && !seen;
    rank[d] = nv;
    nv += first[d] ? 1 : 0;
  }
  float nw = 0.0f;
  float cur = 0.0f;
  for (int base = 0; base < a.t; base += 32) {
    const int t = base + lane;
    if (t < a.t) {
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
      prod[kDevs][lane] =
          __fmul_rn(fr, q3 ? static_cast<float>(gsum - fitsum) : total);
      const bool cpu_ok = cpu_h >= c;
#pragma unroll
      for (int d = 0; d < kDevs; ++d) {
        if (!first[d]) continue;
        const int gd = v.g[d];
        const bool fit = gpu_pod && gd >= m;
        const bool fitp = gpu_pod && gd - p >= m;
        const int cnt_h = fitcnt - (fit ? 1 : 0) + (fitp ? 1 : 0);
        const int sum_h = fitsum - (fit ? gd : 0) + (fitp ? gd - p : 0);
        const bool q = gpu_pod && acc && cnt_h >= num && cpu_ok;
        prod[rank[d]][lane] = __fmul_rn(
            fr, q ? static_cast<float>(gsum - p - sum_h) : total_h);
      }
    }
    __syncwarp();
    const int cnt = min(32, a.t - base);
    if (lane < nv) {
      for (int j = 0; j < cnt; ++j) nw = __fadd_rn(nw, prod[lane][j]);
    } else if (lane == kDevs) {
      for (int j = 0; j < cnt; ++j) cur = __fadd_rn(cur, prod[kDevs][j]);
    }
    __syncwarp();
  }
  cur = __shfl_sync(0xffffffffu, cur, kDevs);
  const int s = sigmoid_score(cur, nw);
  int best = -1;
  int best_dev = -1;
#pragma unroll
  for (int d = 0; d < kDevs; ++d) {  // first device on ties
    const int sd = __shfl_sync(0xffffffffu, s, rank[d] & 31);
    if (first[d] && sd > best) {
      best = sd;
      best_dev = d;
    }
  }
  return best_dev;
}

// The selector's share-device pick for type k at `node` (the column of
// fr_sel: fgd_pair's, pwr_pair's or dotprod_pair's device), by one warp,
// into sdev[k, node] (lane 0): FGD's by warp_fgd_pick; PWR's and
// DotProduct's a lane per device (or slot) and the first of the best.
__device__ void warp_select_pick(const ReplayArgs& a, int k, int node,
                                 int lane, float (*prod)[32]) {
  const NodeView v = load_node(a, node);
  int dev = -1;
  if (a.fr_sel == kFgd) {
    if (k < a.ks) dev = warp_fgd_pick(a, v, k, lane, prod);
  } else if (a.fr_sel == kPwr) {
    const int milli = a.t_milli[k];
    if (a.t_num[k] == 1 && milli < kMilli) {
      const PwrNode w = pwr_node(a, v);
      const float base =
          __fadd_rn(cpu_watts(a, v, v.cpu - a.t_cpu[k]), w.gpu_old);
      const int d = lane & (kDevs - 1);
      const bool ok = lane < kDevs && v.g[d] >= milli;
      const bool flip = v.g[d] == kMilli && milli > 0;
      const int s =
          to_i32(__fsub_rn(w.old, __fadd_rn(base, flip ? w.busy : 0.0f)));
      const int top = __reduce_max_sync(0xffffffffu, ok ? s : INT_MIN);
      const unsigned hit = __ballot_sync(0xffffffffu, ok && s == top);
      dev = hit != 0 ? __ffs(hit) - 1 : -1;
    }
  } else {
    const DotNode dn = dot_node(a, v);
    const int slots = a.dim_ext == kMerge ? 1 : kDevs + 1;
    float val = -INFINITY;
    const bool ok = lane < slots && dot_slot(a, v, dn, k, lane, &val);
    float top = ok ? val : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
    const unsigned hit = __ballot_sync(0xffffffffu, ok && val == top);
    dev = dot_slot_dev(a, v, hit != 0 ? __ffs(hit) - 1 : -1);
  }
  if (lane == 0) a.sdev[static_cast<size_t>(k) * a.n + node] = dev;
}

// the clocked build: this warp's cycles since `w0` into `slot` (the
// event's longest of its kind), by lane 0
__device__ __forceinline__ void note_span(unsigned long long* slot,
                                          long long w0, int lane) {
  if constexpr (kClocked)
    if (lane == 0)
      atomicMax(slot, static_cast<unsigned long long>(clock_now() - w0));
}

__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_forced_kernel(ReplayArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Best warp_res[kForcedWarps];
  __shared__ int warp_cnt[kForcedWarps];
  __shared__ EventState es;
  __shared__ float s_prod[kDevs + 1][32];  // the pick's products
  __shared__ long long s_clk[kNumClocks];
  __shared__ long long s_work[3];
  // the clocked build: by event parity, the event's longest top-3 row,
  // argmax row and pick
  __shared__ unsigned long long s_span[2][3];
  PhaseClock pc;
  pc.start(s_clk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_pol = a.n_pol;
  if (kClocked && tid < 6) s_span[tid / 3][tid % 3] = 0;
  learned_rows(a);
  const Smem m = replay_smem<true>(a, smem, n_pol, false);
  const bool fgd_terms = begin_replay<true, true>(a, m, es);
  const size_t f_n = static_cast<size_t>(a.fam_n);
  __syncthreads();
  const long long t0 = clock_now();

  for (int i = 0; i < a.e; ++i) {
    prefetch_events(a, es, i);
    const int dirty = es.dirty[i & 1];
    if (dirty >= 0) {
      refresh_column<true, false, true, false, true>(a, m, es, dirty, s_work);
      pc.sync();
      pc.mark(kClkRefresh);
    }
    const EventFields ev = es.ev[(i / kEvBatch) & 1][i % kEvBatch];
    const bool create = ev.kind == kCreate;
    const int rec = a.fr_node[i];
    // the selector's device pick at the recorded node, which commit_create
    // reads as a self-select policy's
    const bool self_pick = create && a.fr_sel >= 0 && rec >= 0 &&
                           ev.num == 1 && ev.milli < kMilli;
    unsigned long long* span = s_span[i & 1];
    if (create) {
      if (warp < kSelectWarps) {
        const int type = ev.type;
        const int pin = ev.pin;
        const int* frow = a.feas + static_cast<size_t>(type) * a.n;
        Best b = no_candidate();
        int cnt = 0;
#pragma unroll 4
        for (int node = tid; node < a.n; node += kSelectWarps * 32) {
          const bool f = frow[node] != 0 && (pin < 0 || node == pin);
          uint32_t sum = 0;
          for (int pi = 0; pi < n_pol; ++pi)
            sum += static_cast<uint32_t>(a.pol_weight[pi]) *
                   static_cast<uint32_t>(
                       a.score[(static_cast<size_t>(pi) * a.k + type) * a.n +
                               node]);
          const Best c = {static_cast<int>(sum), a.rank[node], node};
          if (f) {
            ++cnt;
            if (beats(c, b)) b = c;
          }
        }
        b = warp_best(b);
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (lane == 0) {
          warp_res[warp] = b;
          warp_cnt[warp] = cnt;
        }
      } else if (warp < kPickWarp) {  // a recorded top-3 row
        const long long w0 = clock_now();
        const int j = warp - kRowWarp;
        const int tk = a.fr_topk[static_cast<size_t>(i) * 3 + j];
        int* out = a.fr_feats + (static_cast<size_t>(i) * 3 + j) * f_n;
        if (tk >= 0) {
          warp_family_row(a, ev.type, min(tk, a.n - 1), out,
                          row_buf(a, smem, j), lane);
        } else if (lane < a.fam_n) {
          out[lane] = -1;
        }
        note_span(span + 0, w0, lane);
      } else if (self_pick) {
        const long long w0 = clock_now();
        warp_select_pick(a, ev.type, rec, lane, s_prod);
        note_span(span + 2, w0, lane);
      }
    }
    pc.sync();
    pc.mark(kClkSelect);
    if (create && (warp == 0 || warp == kArgWarp)) {
      // the select's result, in both warps
      const Best w =
          warp_best(lane < kSelectWarps ? warp_res[lane] : no_candidate());
      const int pick = __shfl_sync(0xffffffffu, w.node, 0);
      const int pk = pick == INT_MAX ? -1 : pick;
      const int at = max(pk, 0);  // the argmax's row's node (0 where none)
      int same = -1;  // the recorded top-3 row at that node, if any
      for (int j = 2; j >= 0; --j) {
        const int tk = a.fr_topk[static_cast<size_t>(i) * 3 + j];
        if (tk >= 0 && min(tk, a.n - 1) == at) same = j;
      }
      // where the row is the recorded node's and no top-3 row is, warp 0
      // computes it before its commit changes that node
      const bool early = same < 0 && at == rec;
      int* out = a.fr_pick_feats + static_cast<size_t>(i) * f_n;
      const long long w0 = clock_now();
      if (warp == 0) {
        const int feasible = __reduce_add_sync(
            0xffffffffu, lane < kSelectWarps ? warp_cnt[lane] : 0);
        if (lane == 0) {
          a.fr_pick[i] = pk;
          a.fr_feasible[i] = feasible;
        }
        if (early) {
          warp_family_row(a, ev.type, at, out, row_buf(a, smem, 3), lane);
          note_span(span + 1, w0, lane);
        }
        __syncwarp();
        end_event<false, false, true>(a, m, es, i, ev, rec,
                                      self_pick ? kSelSelf : a.gpu_sel,
                                      fgd_terms, n_pol, lane);
      } else {
        if (same >= 0) {
          if (lane < a.fam_n)
            out[lane] =
                a.fr_feats[(static_cast<size_t>(i) * 3 + same) * f_n + lane];
        } else if (!early) {
          warp_family_row(a, ev.type, at, out, row_buf(a, smem, 3), lane);
        }
        note_span(span + 1, w0, lane);
      }
    } else if (!create && warp == 0) {
      if (lane == 0) {
        a.fr_pick[i] = -1;
        a.fr_feasible[i] = 0;
      }
      int* feats = a.fr_feats + static_cast<size_t>(i) * 3 * f_n;
      int* pick_feats = a.fr_pick_feats + static_cast<size_t>(i) * f_n;
      for (int j = lane; j < 3 * a.fam_n; j += 32) feats[j] = -1;
      for (int j = lane; j < a.fam_n; j += 32) pick_feats[j] = -1;
      __syncwarp();
      end_event<false, false, true>(a, m, es, i, ev, -1, a.gpu_sel,
                                    fgd_terms, n_pol, lane);
    }
    if (warp == 1 && has_node_column(a))
      learned_node_stage(a, es, i, lane, kClocked ? s_clk + kClkNode : nullptr);
    pc.sync();
    if (kClocked && tid == 0) {
      s_clk[kClkRows] += span[0];
      s_clk[kClkArow] += span[1];
      s_clk[kClkPick] += span[2];
      span[0] = span[1] = span[2] = 0;
    }
    pc.mark(kClkCommit);
  }
  pc.finish(a.clocks, t0);
}

bool forced_operands(const ReplayArgs* a) {
  if (a->scratch != nullptr || !staged_shape(a) || a->fam_n < 1 ||
      a->fam_n > kMaxFamily || a->ln_n < 0 || a->ln_n > kMaxFamily ||
      randomized(a) || a->sel >= 0 || a->fr_node == nullptr ||
      a->fr_topk == nullptr || a->fr_pick == nullptr ||
      a->fr_feasible == nullptr || a->fr_feats == nullptr ||
      a->fr_pick_feats == nullptr ||
      (a->gpu_sel != kSelBest && a->gpu_sel != kSelWorst))
    return false;
  if (a->fr_sel != -1 && a->fr_sel != kFgd && a->fr_sel != kPwr &&
      a->fr_sel != kDotProd)
    return false;
  for (int pi = 0; pi < a->n_pol; ++pi)
    if (a->pol_norm[pi] != kNormNone) return false;
  return true;
}

int launch_forced(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies || !forced_operands(a))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_replay(replay_forced_kernel, a, true, false,
                       static_cast<cudaStream_t>(stream),
                       4 * row_buf_bytes(a->t));
}

}  // namespace
#endif  // the forced body

#ifndef TPUSIM_FORCED_CLOCKED_TU
extern "C" {

#ifdef TPUSIM_PHASE_CLOCKS
int replay_forced_clocked(const ReplayArgs* a, void* stream);
#endif

int replay_forced(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  return replay_forced_clocked(a, stream);
#else
  return launch_forced(a, stream);
#endif
}

}  // extern "C"
#endif  // TPUSIM_FORCED_CLOCKED_TU
