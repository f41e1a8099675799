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
// The select is the flat replay's (all N nodes, a block of 512 threads, the
// block reductions); the family's policies are normalised "none" (the host
// refuses others). Feature rows: a table policy's raw score at the node, a
// node-only feature computed there (node_features), by four lanes of warp
// 0 before it commits. Non-create events write pick -1, feasible 0 and
// feature rows of -1.
//
// Compiled apart, in parallel with the others; the clocked variant builds
// nothing here (its launcher refuses). Interface: plain C, bound with
// ctypes; the launcher returns the CUDA error code of the launch and never
// synchronises.

#define TPUSIM_LANES_TU
#include "replay.cu"

#ifndef TPUSIM_PHASE_CLOCKS
namespace {

// the family's feature row at `node` for type `type` into out[fam_n]
__device__ void family_row(const ReplayArgs& a, int type, int node,
                           int* out) {
  bool any_node = false;
  for (int j = 0; j < a.fam_n; ++j) any_node |= a.fam_src[j] < 0;
  int f[kNodeFeatures];
  if (any_node) node_features(a, load_node(a, node), a.mem_cap[node], f);
  for (int j = 0; j < a.fam_n; ++j) {
    const int pi = a.fam_src[j];
    out[j] = pi < 0 ? f[-1 - pi]
                    : a.score[(static_cast<size_t>(pi) * a.k + type) * a.n +
                              node];
  }
}

__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_forced_kernel(ReplayArgs a) {
  constexpr int kWarps = kReplayThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Best warp_res[kWarps];
  __shared__ int warp_cnt[kWarps];
  __shared__ EventState es;
  __shared__ long long s_work[3];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_pol = a.n_pol;
  learned_rows(a);
  const Smem m = replay_smem<true>(a, smem, n_pol, false);
  const bool fgd_terms = begin_replay<true, true>(a, m, es);
  __syncthreads();

  for (int i = 0; i < a.e; ++i) {
    prefetch_events(a, es, i);
    const int dirty = es.dirty[i & 1];
    if (dirty >= 0) {
      refresh_column<true, false, true, false, true>(a, m, es, dirty, s_work);
      __syncthreads();
    }
    const EventFields ev = es.ev[(i / kEvBatch) & 1][i % kEvBatch];
    const bool create = ev.kind == kCreate;
    if (create) {
      const int type = ev.type;
      const int pin = ev.pin;
      const int* frow = a.feas + static_cast<size_t>(type) * a.n;
      Best b = no_candidate();
      int cnt = 0;
      for (int node = tid; node < a.n; node += blockDim.x) {
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
    }
    __syncthreads();
    if (warp == 0) {
      const int rec = a.fr_node[i];
      if (create) {
        const Best w =
            warp_best(lane < nwarps ? warp_res[lane] : no_candidate());
        const int pick = __shfl_sync(0xffffffffu, w.node, 0);
        const int feasible = __reduce_add_sync(
            0xffffffffu, lane < nwarps ? warp_cnt[lane] : 0);
        const int pk = pick == INT_MAX ? -1 : pick;
        const size_t f_n = static_cast<size_t>(a.fam_n);
        if (lane < 3) {  // the recorded top-3's rows
          const int tk = a.fr_topk[static_cast<size_t>(i) * 3 + lane];
          int* out = a.fr_feats + (static_cast<size_t>(i) * 3 + lane) * f_n;
          if (tk >= 0) {
            family_row(a, ev.type, min(tk, a.n - 1), out);
          } else {
            for (int j = 0; j < a.fam_n; ++j) out[j] = -1;
          }
        } else if (lane == 3) {  // the argmax's row (node 0 where none)
          family_row(a, ev.type, max(pk, 0),
                     a.fr_pick_feats + static_cast<size_t>(i) * f_n);
          a.fr_pick[i] = pk;
          a.fr_feasible[i] = feasible;
        }
        int gpu_sel = a.gpu_sel;
        if (a.fr_sel >= 0 && rec >= 0 && ev.num == 1 && ev.milli < kMilli) {
          // the selector's device pick at the recorded node, read by
          // commit_create as a self-select policy's
          gpu_sel = kSelSelf;
          if (lane == 0) {
            const NodeView v = load_node(a, rec);
            int score = 0;
            int dev = -1;
            if (a.fr_sel == kFgd) {
              fgd_pair(a, v, ev.type, &score, &dev);
            } else if (a.fr_sel == kPwr) {
              pwr_pair(a, v, ev.type, &score, &dev);
            } else {
              dotprod_pair(a, v, ev.type, &score, &dev);
            }
            a.sdev[static_cast<size_t>(ev.type) * a.n + rec] = dev;
          }
        }
        __syncwarp();
        end_event<false, false>(a, m, es, i, ev, rec, gpu_sel, fgd_terms,
                                n_pol, lane);
      } else {
        if (lane == 0) {
          a.fr_pick[i] = -1;
          a.fr_feasible[i] = 0;
          int* feats = a.fr_feats + static_cast<size_t>(i) * 3 * a.fam_n;
          int* pick_feats = a.fr_pick_feats + static_cast<size_t>(i) * a.fam_n;
          for (int j = 0; j < 3 * a.fam_n; ++j) feats[j] = -1;
          for (int j = 0; j < a.fam_n; ++j) pick_feats[j] = -1;
        }
        end_event<false, false>(a, m, es, i, ev, -1, a.gpu_sel, fgd_terms,
                                n_pol, lane);
      }
    }
    __syncthreads();
  }
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

}  // namespace
#endif  // TPUSIM_PHASE_CLOCKS

extern "C" {

int replay_forced(const ReplayArgs* a, void* stream) {
#ifdef TPUSIM_PHASE_CLOCKS
  (void)a;
  (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies || !forced_operands(a))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_replay(replay_forced_kernel, a, true, false,
                       static_cast<cudaStream_t>(stream));
#endif
}

}  // extern "C"
