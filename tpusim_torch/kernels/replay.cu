// Fused trace replay for NVIDIA Hopper (sm_90a).
//
// Replaces the fused whole-replay Pallas kernel of the JAX package
// (tpusim/sim/pallas_engine.py: _make_kernel :780, launched at :1260 by
// make_pallas_replay :1122) for every configuration it covers: any list of
// the policies FGDScore, BestFitScore, GpuPackingScore, GpuClusteringScore,
// PWRScore and DotProductScore with integer weights, and gpu_sel best,
// worst or an enabled self-select policy. Its column functions are
// _fgd_column :360, _bestfit_column :451, _packing_column :464,
// _clustering_column :494, _pwr_column :521, _make_dotprod_column :578 and
// _feas_column :739.
//
// Three kernels share the __device__ column functions (one per policy,
// `*_pair`, scoring one pod type on one node):
//   init_tables_kernel  one thread per (type, node) pair fills the
//                       [n_pol*K, N] score, [K, N] share-device and [K, N]
//                       Filter tables of the initial state (the Pallas
//                       kernel's event-0 fori_loop, :906-910).
//   replay_kernel       one persistent block walks every event in order:
//                       refresh the column of the node the previous event
//                       touched (threads over K), then on a create the
//                       min/max of each normalised policy's row over the
//                       feasible nodes, the i32 weighted sum and selectHost
//                       (threads over N, then block reductions), and one
//                       thread runs Reserve and Bind, or the unbind of a
//                       delete (:955-1103).
//   replay_blocked_kernel
//                       the same event loop for clusters whose tables
//                       outgrow L2; it replaces the HBM-residency Pallas
//                       kernel (_make_hbm_kernel :1346, launched at :2160 by
//                       _make_hbm_replay :2017). It keeps 128-node block
//                       summaries ([K, N/128], one warp per (type, block)):
//                       per event it refreshes the dirty column, then that
//                       block's summaries for all K types, checks the event
//                       type's normalisation extrema for drift (rebuilding
//                       its summary row over N only when one moved), and
//                       selects over N/128 summaries instead of N nodes.
//                       The Pallas kernel's double-buffered DMA has no
//                       counterpart: tables and summaries stay in global
//                       memory, and its waits/starts counters stay 0.
// Both replay kernels are templates on the configuration's shape: <false> is
// specialised to the paper's FGD configuration (one FGDScore policy, gpu_sel
// FGDScore or best) and skips the descriptor, the normalisation pass and the
// policy loop; <true> reads the policy descriptor.
//
// What bounds them on this card: the replay is a serial chain of events, so
// its time is latency, not bytes or operations. An event of `replay` touches
// one row per policy (N int32 each, plus the Filter row) and one column
// (n_pol + 2 values per type); the tables stay in global memory, resident in
// L2 while they fit (50 MB). `replay_blocked` reads K x 128 entries per
// policy for the block refresh and N/128 summaries for the select, so its
// event stays O(K x 128 + N/128) when the tables sit in device memory.
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

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDevs = 8;       // MAX_GPUS_PER_NODE
constexpr int kAffClasses = 9; // share + 1..8 whole-GPU pods
constexpr int kMilli = 1000;
constexpr int kMaxNodeScore = 100;
constexpr int kMaxSpecGpu = 8000;
constexpr int kCreate = 0;
constexpr int kDelete = 1;
constexpr int kInitThreads = 256;
constexpr int kReplayThreads = 512;
constexpr int kMaxPolicies = 6;
constexpr int kBlock = 128;  // nodes per block summary of replay_blocked

// column ids (tpusim_torch.policies.COLUMN_IDS)
constexpr int kFgd = 0;
constexpr int kBestFit = 1;
constexpr int kPacking = 2;
constexpr int kClustering = 3;
constexpr int kPwr = 4;
constexpr int kDotProd = 5;
// normalize modes (NORMALIZE_IDS)
constexpr int kNormNone = 0;
constexpr int kNormMinMax = 1;
// gpu_sel modes
constexpr int kSelBest = 0;
constexpr int kSelWorst = 1;
constexpr int kSelSelf = 2;
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

}  // namespace

extern "C" {

// Every device pointer, size and configuration value the two kernels read.
// Tables are row-major: score [n_pol*k, n] (policy-major, then type), sdev
// and feas [k, n]; gpu_left is [n, 8]; aff_cnt is [n, 9]. Types hold the ks
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
};

}  // extern "C"

namespace {

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

// GpuPacking (_packing_column :464; policies/packing.py), in integers
__device__ __forceinline__ int packing_pair(const ReplayArgs& a,
                                            const NodeView& v, int k) {
  const int milli = a.t_milli[k];
  const int num = a.t_num[k];
  if (milli * num <= 0) return 0;
  constexpr int t3 = kMaxNodeScore / 3;
  constexpr int t2 = kMaxNodeScore / 2;
  const int fully_free = idle_count(v);
  if (fully_free == v.gcnt) return max(t3 - fully_free, fully_free);
  bool take[kDevs];
  if (!packed_take(v, milli, num, take)) return 0;
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

// PWR (_pwr_column :521; policies/pwr.py). Every watt figure is an
// integer held exactly in float32, so only the floor/ceil inputs round.
// The branch follows the type: one GPU under 1000 milli is a share pod.
__device__ void pwr_pair(const ReplayArgs& a, const NodeView& v, int k,
                         int* score, int* sdev) {
  const float gidle = v.gtyp >= 0 ? a.gpu_idle_w[v.gtyp] : 0.0f;
  const float gfull = v.gtyp >= 0 ? a.gpu_full_w[v.gtyp] : 0.0f;
  const float busy = v.gtyp >= 0 ? __fsub_rn(gfull, gidle) : 0.0f;
  const float n_idle = static_cast<float>(idle_count(v));
  const float gpu_old = __fadd_rn(
      __fmul_rn(gidle, n_idle),
      __fmul_rn(gfull, __fsub_rn(static_cast<float>(v.gcnt), n_idle)));
  const float old = __fadd_rn(cpu_watts(a, v, v.cpu), gpu_old);
  const float base = __fadd_rn(cpu_watts(a, v, v.cpu - a.t_cpu[k]), gpu_old);
  const int milli = a.t_milli[k];
  const int num = a.t_num[k];
  if (num == 1 && milli < kMilli) {
    // share: device d flips iff it was fully idle and the pod takes milli
    int best = kPwrNeg;
    int best_dev = -1;
#pragma unroll
    for (int d = 0; d < kDevs; ++d) {
      if (v.g[d] >= milli) {
        const bool flip = v.g[d] == kMilli && milli > 0;
        const int s = to_i32(__fsub_rn(old, __fadd_rn(base, flip ? busy : 0.0f)));
        if (best_dev < 0 || s > best) {  // first device on ties
          best = s;
          best_dev = d;
        }
      }
    }
    *score = best;
    *sdev = best_dev;
    return;
  }
  // whole GPUs / CPU only: Sub's taken devices flip iff they were idle
  bool take[kDevs];
  packed_take(v, milli, num, take);
  int flips = 0;
#pragma unroll
  for (int d = 0; d < kDevs; ++d)
    flips += (num > 0 && take[d] && v.g[d] == kMilli) ? 1 : 0;
  *score = to_i32(__fsub_rn(
      old, __fadd_rn(base, __fmul_rn(static_cast<float>(flips), busy))));
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

// DotProduct (_make_dotprod_column :578; policies/dotprod.py): the best of
// up to 9 slots (8 devices + the idle pool; one under merge), first on ties
__device__ void dotprod_pair(const ReplayArgs& a, const NodeView& v, int k,
                             int* score, int* sdev) {
  const int tcpu_i = a.t_cpu[k];
  const int treq_i = a.t_milli[k] * a.t_num[k];
  const float tcpu = static_cast<float>(tcpu_i);
  const float treq = static_cast<float>(treq_i);
  const float cpu_f = static_cast<float>(v.cpu);
  const int gsum = gpu_sum(v);
  const int idle_cnt = idle_count(v);
  const bool cpu_fits = v.cpu >= tcpu_i;
  const int slots = a.dim_ext == kMerge ? 1 : kDevs + 1;
  float n_groups = 0.0f;
  if (a.dim_ext == kExtend) {
#pragma unroll
    for (int d = 0; d < kDevs; ++d)
      n_groups += (d < v.gcnt && v.g[d] > 0 && v.g[d] < kMilli) ? 1.0f : 0.0f;
    n_groups += idle_cnt > 0 ? 1.0f : 0.0f;
  }
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

// Filter-phase feasibility of type k on one node (_feas_column :739;
// step.filter_nodes without the per-event pin mask)
__device__ __forceinline__ int feas_pair(const ReplayArgs& a,
                                         const NodeView& v, int k) {
  const int m = a.t_milli[k];
  const int num = a.t_num[k];
  const int mask = a.t_mask[k];
  const bool fit = v.cpu >= a.t_cpu[k] && v.mem >= a.t_mem[k];
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

// raw score and device pick of policy `pi` for type k on one node
__device__ void policy_pair(const ReplayArgs& a, const NodeView& v, int pi,
                            int k, int* score, int* sdev) {
  *sdev = -1;
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

// every table entry of type k on `node`
template <bool kGeneral>
__device__ __forceinline__ void write_column(const ReplayArgs& a,
                                             const NodeView& v, int k,
                                             int node) {
  const size_t i = static_cast<size_t>(k) * a.n + node;
  if (!kGeneral) {  // one FGDScore policy, its own picks
    int s;
    int d;
    fgd_pair(a, v, k, &s, &d);
    a.score[i] = s;
    a.sdev[i] = a.sel == 0 ? d : -1;
  } else {
    int sel_dev = -1;
    for (int pi = 0; pi < a.n_pol; ++pi) {
      int s;
      int d;
      policy_pair(a, v, pi, k, &s, &d);
      a.score[(static_cast<size_t>(pi) * a.k + k) * a.n + node] = s;
      if (pi == a.sel) sel_dev = d;
    }
    a.sdev[i] = sel_dev;
  }
  a.feas[i] = feas_pair(a, v, k);
}

__global__ void init_tables_kernel(ReplayArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(a.k) * a.n) return;
  const int k = static_cast<int>(i / a.n);
  const int node = static_cast<int>(i % a.n);
  write_column<true>(a, load_node(a, node), k, node);
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

// Reserve + Bind of create event i on `node` (-1 = no feasible node);
// step.choose_devices / select_and_bind, pallas_engine.py:982-1064
__device__ void commit_create(const ReplayArgs& a, int i, int pod, int type,
                              int node, int gpu_sel, int* dirty) {
  const bool ok = node >= 0;
  const int pm = a.p_milli[pod];
  const int pn = a.p_num[pod];
  int bits = 0;
  if (ok && pm * pn > 0) {
    const int* g = a.gpu_left + node * kDevs;
    if (pn == 1 && pm < kMilli) {
      // share-GPU pod: tightest fit (or loosest for worst), first index;
      // a self-select policy's own pick wins where it has one
      int dev = -1;
      int key = 0;
      for (int d = 0; d < kDevs; ++d) {
        if (g[d] < pm) continue;
        const bool better = gpu_sel == kSelWorst ? g[d] > key : g[d] < key;
        if (dev < 0 || better) {
          key = g[d];
          dev = d;
        }
      }
      if (gpu_sel == kSelSelf) {
        const int s = a.sdev[static_cast<size_t>(type) * a.n + node];
        if (s >= 0) dev = s;
      }
      bits = dev >= 0 ? (1 << dev) : 0;
    } else {
      // two-pointer pack in device-index order (gpunodeinfo.go:182-201)
      int prev = 0;
      for (int d = 0; d < kDevs; ++d) {
        const int units = g[d] / pm;
        const int take = min(max(pn - prev, 0), units);
        if (take > 0) bits |= 1 << d;
        prev += units;
      }
    }
  }
  if (ok) {
    a.cpu_left[node] -= a.p_cpu[pod];
    a.mem_left[node] -= a.p_mem[pod];
    for (int d = 0; d < kDevs; ++d)
      if ((bits >> d) & 1) a.gpu_left[node * kDevs + d] -= pm;
    const int cls = affinity_class(pm, pn);
    if (cls >= 0 && cls < kAffClasses) a.aff_cnt[node * kAffClasses + cls] += 1;
  }
  a.placed[pod] = ok ? node : -1;
  a.maskb[pod] = bits;
  a.failed[pod] = ok ? 0 : 1;
  a.ev_node[i] = ok ? node : -1;
  a.ev_devb[i] = bits;
  *dirty = ok ? node : 0;
}

// Delete event i: return the pod's resources to the devices it held
// (step.unschedule, pallas_engine.py:1068-1103)
__device__ void commit_delete(const ReplayArgs& a, int i, int pod, int* dirty) {
  const int node = a.placed[pod];
  const int bits = a.maskb[pod];
  if (node >= 0) {
    const int pm = a.p_milli[pod];
    a.cpu_left[node] += a.p_cpu[pod];
    a.mem_left[node] += a.p_mem[pod];
    for (int d = 0; d < kDevs; ++d)
      if ((bits >> d) & 1) a.gpu_left[node * kDevs + d] += pm;
    const int cls = affinity_class(pm, a.p_num[pod]);
    if (cls >= 0 && cls < kAffClasses) a.aff_cnt[node * kAffClasses + cls] -= 1;
  }
  a.placed[pod] = -1;
  a.maskb[pod] = 0;
  a.ev_node[i] = node;
  a.ev_devb[i] = bits;
  *dirty = node >= 0 ? node : 0;
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

template <bool kGeneral>
__global__ void __launch_bounds__(kReplayThreads) replay_kernel(ReplayArgs a) {
  constexpr int kWarps = kReplayThreads / 32;
  __shared__ Best warp_res[kWarps];
  __shared__ int warp_lo[kWarps][kMaxPolicies];
  __shared__ int warp_hi[kWarps][kMaxPolicies];
  __shared__ int s_dirty;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gpu_sel = kGeneral ? a.gpu_sel : (a.sel >= 0 ? kSelSelf : kSelBest);
  bool any_norm = false;
  if (kGeneral)
    for (int pi = 0; pi < a.n_pol; ++pi) any_norm |= a.pol_norm[pi] != kNormNone;
  if (tid == 0) s_dirty = -1;  // the tables already hold the initial state
  __syncthreads();

  for (int i = 0; i < a.e; ++i) {
    // refresh the column of the node the previous event touched
    const int dirty = s_dirty;
    if (dirty >= 0 && tid < a.k) {
      const NodeView v = load_node(a, dirty);
      for (int k = tid; k < a.k; k += blockDim.x)
        write_column<kGeneral>(a, v, k, dirty);
    }
    __syncthreads();

    const int kind = a.ev_kind[i];
    const int pod = a.ev_pod[i];
    if (kind == kCreate) {
      const int type = a.p_type[pod];
      const int pin = a.p_pinned[pod];
      const int* frow = a.feas + static_cast<size_t>(type) * a.n;
      int lo[kMaxPolicies];
      int hi[kMaxPolicies];
      if (kGeneral && any_norm) {
        // the feasible extrema of each normalised policy's row
        for (int pi = 0; pi < a.n_pol; ++pi) {
          lo[pi] = INT_MAX;
          hi[pi] = -INT_MAX;
        }
        for (int node = tid; node < a.n; node += blockDim.x) {
          if (!frow[node] || (pin >= 0 && node != pin)) continue;
          for (int pi = 0; pi < a.n_pol; ++pi) {
            if (a.pol_norm[pi] == kNormNone) continue;
            const int r =
                a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
            lo[pi] = min(lo[pi], r);
            hi[pi] = max(hi[pi], r);
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
        __syncthreads();
        for (int pi = 0; pi < a.n_pol; ++pi) {
          for (int w = 0; w < nwarps; ++w) {
            lo[pi] = min(lo[pi], warp_lo[w][pi]);
            hi[pi] = max(hi[pi], warp_hi[w][pi]);
          }
        }
      }
      Best b = no_candidate();
      for (int node = tid; node < a.n; node += blockDim.x) {
        if (!frow[node] || (pin >= 0 && node != pin)) continue;
        int total;
        if (!kGeneral) {
          total = static_cast<int>(
              static_cast<uint32_t>(a.pol_weight[0]) *
              static_cast<uint32_t>(a.score[static_cast<size_t>(type) * a.n + node]));
        } else {
          uint32_t sum = 0;
          for (int pi = 0; pi < a.n_pol; ++pi) {
            int r = a.score[(static_cast<size_t>(pi) * a.k + type) * a.n + node];
            if (a.pol_norm[pi] != kNormNone)
              r = normalize(r, lo[pi], hi[pi], a.pol_norm[pi]);
            sum += static_cast<uint32_t>(a.pol_weight[pi]) * static_cast<uint32_t>(r);
          }
          total = static_cast<int>(sum);
        }
        const Best c = {total, a.rank[node], node};
        if (beats(c, b)) b = c;
      }
      b = warp_best(b);
      if (lane == 0) warp_res[warp] = b;
      __syncthreads();
      if (warp == 0) {
        b = lane < nwarps ? warp_res[lane] : no_candidate();
        b = warp_best(b);
        if (lane == 0)
          commit_create(a, i, pod, type, b.node == INT_MAX ? -1 : b.node,
                        gpu_sel, &s_dirty);
      }
    } else if (tid == 0) {
      if (kind == kDelete) {
        commit_delete(a, i, pod, &s_dirty);
      } else {  // EV_SKIP: nothing changes
        a.ev_node[i] = -1;
        a.ev_devb[i] = 0;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// replay_blocked: replay_kernel's event loop with a two-level selectHost over
// 128-node block summaries (pallas_engine.py _make_hbm_kernel :1346, whose
// algorithm is the blocked table engine's: table_engine.py make_blocked_body
// :684, init :1294-1320, _totals :664; step.py block_reduce :218).
// ---------------------------------------------------------------------------

// One warp summarises block c of type t: the best (total, rank, node) of its
// 128 nodes, where a node's total is the i32 weighted sum with each
// normalised policy s scaled against lo[s * ld], hi[s * ld], and -INT_MAX
// where the type is infeasible; with `extrema`, also each normalised
// policy's feasible raw min and max over the block. Lane 0 writes them.
template <bool kGeneral>
__device__ void summarize_block(const ReplayArgs& a, int t, int c,
                                const int* lo, const int* hi, int ld,
                                bool extrema, int lane) {
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
    const Best cand = {f ? static_cast<int>(sum) : -INT_MAX, a.rank[node], node};
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

template <bool kGeneral>
__global__ void __launch_bounds__(kReplayThreads)
    replay_blocked_kernel(ReplayArgs a) {
  constexpr int kWarps = kReplayThreads / 32;
  __shared__ Best warp_res[kWarps];
  __shared__ int warp_lo[kWarps][kMaxPolicies];
  __shared__ int warp_hi[kWarps][kMaxPolicies];
  __shared__ int s_dirty;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nblk = a.n / kBlock;
  const int gpu_sel = kGeneral ? a.gpu_sel : (a.sel >= 0 ? kSelSelf : kSelBest);
  int nn = 0;  // normalised policies: the rows of brmin/brmax and slo/shi
  if (kGeneral)
    for (int pi = 0; pi < a.n_pol; ++pi) nn += a.pol_norm[pi] != kNormNone ? 1 : 0;

  // the summaries of the initial tables: every block's extrema, the stored
  // extrema as their min/max over blocks, then every block's summary under
  // the stored extrema (one warp per (type, block))
  if (nn > 0) {
    for (int w = warp; w < a.k * nblk; w += nwarps)
      summarize_block<kGeneral>(a, w / nblk, w % nblk, a.slo, a.shi, 0, true,
                                lane);
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
    summarize_block<kGeneral>(a, t, w % nblk, a.slo + t, a.shi + t, a.k, false,
                              lane);
  }
  if (tid == 0) {
    s_dirty = -1;  // the tables and summaries hold the initial state
    a.stats[0] = 0;  // waits and starts: the kernel issues no async copies
    a.stats[1] = 0;
    a.stats[2] = 0;  // summary-row rebuilds
  }
  __syncthreads();

  for (int i = 0; i < a.e; ++i) {
    // refresh the column of the node the previous event touched, then that
    // node's block summaries of every type under the stored extrema
    const int dirty = s_dirty;
    if (dirty >= 0) {
      if (tid < a.k) {
        const NodeView v = load_node(a, dirty);
        for (int k = tid; k < a.k; k += blockDim.x)
          write_column<kGeneral>(a, v, k, dirty);
      }
      __syncthreads();
      const int c = dirty / kBlock;
      for (int t = warp; t < a.k; t += nwarps)
        summarize_block<kGeneral>(a, t, c, a.slo + t, a.shi + t, a.k, nn > 0,
                                  lane);
      __syncthreads();
    }

    const int kind = a.ev_kind[i];
    const int pod = a.ev_pod[i];
    const int type = a.p_type[pod];
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
      __syncthreads();
      bool changed = false;
      for (int s = 0; s < nn; ++s) {
        lo[s] = INT_MAX;
        hi[s] = -INT_MAX;
        for (int w = 0; w < nwarps; ++w) {
          lo[s] = min(lo[s], warp_lo[w][s]);
          hi[s] = max(hi[s], warp_hi[w][s]);
        }
        changed |= lo[s] != a.slo[s * a.k + type] || hi[s] != a.shi[s * a.k + type];
      }
      if (changed) {  // the same in every thread
        for (int c = warp; c < nblk; c += nwarps)
          summarize_block<kGeneral>(a, type, c, lo, hi, 1, false, lane);
        __syncthreads();  // every thread has read the stored extrema
        if (tid == 0) {
          for (int s = 0; s < nn; ++s) {
            a.slo[s * a.k + type] = lo[s];
            a.shi[s * a.k + type] = hi[s];
          }
          a.stats[2] += 1;
        }
      }
    }

    if (kind == kCreate) {
      const int pin = a.p_pinned[pod];
      if (pin >= 0) {
        // a pinned pod has one candidate: its Filter bit decides
        if (tid == 0) {
          const bool ok =
              pin < a.n && a.feas[static_cast<size_t>(type) * a.n + pin] != 0;
          commit_create(a, i, pod, type, ok ? pin : -1, gpu_sel, &s_dirty);
        }
      } else {
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
        __syncthreads();
        if (warp == 0) {
          b = lane < nwarps ? warp_res[lane] : no_candidate();
          b = warp_best(b);
          if (lane == 0)
            commit_create(a, i, pod, type,
                          b.node == INT_MAX ? -1 : a.bn[row + b.node], gpu_sel,
                          &s_dirty);
        }
      }
    } else if (tid == 0) {
      if (kind == kDelete) {
        commit_delete(a, i, pod, &s_dirty);
      } else {  // EV_SKIP: nothing changes
        a.ev_node[i] = -1;
        a.ev_devb[i] = 0;
      }
    }
    __syncthreads();
  }
}

// the paper's shape: one FGDScore policy without normalisation, gpu_sel
// FGDScore (sel 0) or best
bool fgd_only(const ReplayArgs* a) {
  return a->n_pol == 1 && a->pol_column[0] == kFgd &&
         a->pol_norm[0] == kNormNone &&
         (a->gpu_sel == kSelBest || (a->gpu_sel == kSelSelf && a->sel == 0));
}

}  // namespace

extern "C" {

int init_tables(const ReplayArgs* a, void* stream) {
  const long long pairs = static_cast<long long>(a->k) * a->n;
  if (pairs == 0) return 0;
  const int blocks = static_cast<int>((pairs + kInitThreads - 1) / kInitThreads);
  init_tables_kernel<<<blocks, kInitThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int replay(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fgd_only(a)) {
    replay_kernel<false><<<1, kReplayThreads, 0, s>>>(*a);
  } else {
    replay_kernel<true><<<1, kReplayThreads, 0, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

int replay_blocked(const ReplayArgs* a, void* stream) {
  if (a->e == 0) return 0;
  if (a->n_pol < 1 || a->n_pol > kMaxPolicies || a->n % kBlock != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fgd_only(a)) {
    replay_blocked_kernel<false><<<1, kReplayThreads, 0, s>>>(*a);
  } else {
    replay_blocked_kernel<true><<<1, kReplayThreads, 0, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
