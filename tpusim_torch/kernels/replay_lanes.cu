// Lanes: `replay` and `replay_blocked` over a grid of B lanes, one block a
// lane (seed batches and config sweeps). The kernel bodies are replay.cu's
// (replay_body, replay_blocked_body), included with its host entries left
// out; this file is compiled apart from replay.cu, so that the two build
// in parallel, and the objects are linked into one library. The fault
// forms' files include this one with its host entries left out
// (TPUSIM_FAULTS_TU) for the lanes kernels and their launcher.

#define TPUSIM_LANES_TU
#include "replay.cu"

namespace {

// The lanes' kernels copy their lane's ReplayArgs into shared memory once:
// block b replays lane b of the array.
__device__ __forceinline__ void load_lane(const ReplayArgs* __restrict__ lanes,
                                          ReplayArgs* out) {
  static_assert(sizeof(ReplayArgs) % sizeof(int) == 0, "ReplayArgs words");
  const int* src = reinterpret_cast<const int*>(lanes + blockIdx.x);
  int* dst = reinterpret_cast<int*>(out);
  for (int w = threadIdx.x; w < static_cast<int>(sizeof(ReplayArgs) / sizeof(int));
       w += blockDim.x)
    dst[w] = src[w];
  __syncthreads();
}

// replay over a grid of lanes, one block a lane
template <bool kGeneral, bool kRandomized = false, bool kStaged = true,
          bool kFaults = false>
__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_lanes_kernel(const ReplayArgs* __restrict__ lanes) {
  __shared__ __align__(16) ReplayArgs lane_args;
  load_lane(lanes, &lane_args);
  replay_body<kGeneral, kRandomized, kStaged, kFaults>(lane_args);
}

// replay_blocked over a grid of lanes, one block a lane
template <bool kGeneral, bool kStaged = true, bool kAllColumns = true,
          bool kFaults = false>
__global__ void __launch_bounds__(kReplayThreads, 1)
    replay_blocked_lanes_kernel(const ReplayArgs* __restrict__ lanes) {
  __shared__ __align__(16) ReplayArgs lane_args;
  load_lane(lanes, &lane_args);
  replay_blocked_body<kGeneral, kStaged, kAllColumns, kFaults>(lane_args);
}

// whether two lanes run the same instantiation of a replay kernel: the
// same policies and normalisations, gpu_sel and selector, and form (staged
// or global); their weights, keys, sizes and arrays may differ
bool same_instantiation(const ReplayArgs* a, const ReplayArgs* b) {
  if (a->n_pol != b->n_pol || a->sel != b->sel || a->gpu_sel != b->gpu_sel ||
      (a->scratch == nullptr) != (b->scratch == nullptr))
    return false;
  for (int pi = 0; pi < a->n_pol; ++pi)
    if (a->pol_column[pi] != b->pol_column[pi] ||
        a->pol_norm[pi] != b->pol_norm[pi])
      return false;
  return true;
}

// Launches a lanes kernel over the b lanes of `lanes` (host memory): a
// block per lane, with the largest dynamic shared memory the lanes' shapes
// need in the staged form. The lanes are copied on the stream into
// `lanes_dev` (b ReplayArgs of device memory), which the blocks read.
template <typename Kernel>
int launch_lanes(Kernel kernel, const ReplayArgs* lanes, int b,
                 ReplayArgs* lanes_dev, bool general, bool blocked,
                 cudaStream_t s) {
  const bool staged = lanes[0].scratch == nullptr;
  size_t bytes = 0;
  for (int l = 0; l < b; ++l) {
    const ReplayArgs* a = lanes + l;
    if (a->k < 1 || a->t < 0 || a->ks < 0 || a->ks > a->k || a->e < 0 ||
        (staged && !staged_shape(a)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (staged)
      bytes = std::max(bytes, carve(nullptr, a->k, a->t,
                                    general ? a->n_pol : 1, blocked, nullptr));
  }
  cudaError_t err;
  if (staged) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemcpyAsync(lanes_dev, lanes, sizeof(ReplayArgs) * b,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kReplayThreads, bytes, s>>>(lanes_dev);
  return static_cast<int>(cudaGetLastError());
}

// Checks a lane array: b >= 1 lanes of one instantiation (the first
// lane's), each with 1..kMaxPolicies policies
bool check_lanes(const ReplayArgs* lanes, int b) {
  if (b < 1 || lanes[0].n_pol < 1 || lanes[0].n_pol > kMaxPolicies)
    return false;
  for (int l = 1; l < b; ++l)
    if (!same_instantiation(lanes, lanes + l)) return false;
  return true;
}

#ifdef TPUSIM_FAULTS_TU
// whether a ReplayArgs carries the fault operands the fault forms read
bool fault_operands(const ReplayArgs* a) {
  return a->p >= 1 && a->f_cap_r >= 1 && a->f_rows >= 1 && a->f_cols >= 1 &&
         a->f_nrec >= 0 && a->f_pos != nullptr && a->f_arg != nullptr &&
         a->f_aux != nullptr && a->f_draws != nullptr && a->q_pod != nullptr &&
         a->f_dctr != nullptr && a->y_rpod != nullptr &&
         (a->f_nrec == 0 || a->snap_cpu != nullptr);
}
#endif

}  // namespace

#ifndef TPUSIM_FAULTS_TU

extern "C" {

// the learned instantiations (replay_learned.cu, replay_blocked_learned.cu)
int replay_lanes_learned(const ReplayArgs* lanes, int b, void* lanes_dev,
                         void* stream);
int replay_blocked_lanes_learned(const ReplayArgs* lanes, int b,
                                 void* lanes_dev, void* stream);

// replay over b lanes, one block each; refuses lanes of different
// instantiations (check_lanes)
int replay_lanes(const ReplayArgs* lanes, int b, void* lanes_dev,
                 void* stream) {
  if (!check_lanes(lanes, b)) return static_cast<int>(cudaErrorInvalidValue);
  if (learned(lanes)) return replay_lanes_learned(lanes, b, lanes_dev, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ReplayArgs* dev = static_cast<ReplayArgs*>(lanes_dev);
  const ReplayArgs* a = lanes;
  const bool staged = a->scratch == nullptr;
  if (randomized(a)) {
    if (staged)
      return launch_lanes(replay_lanes_kernel<true, true, true>, lanes, b, dev,
                          true, false, s);
    return launch_lanes(replay_lanes_kernel<true, true, false>, lanes, b, dev,
                        true, false, s);
  }
  if (!staged)
    return launch_lanes(replay_lanes_kernel<true, false, false>, lanes, b, dev,
                        true, false, s);
  if (fgd_only(a))
    return launch_lanes(replay_lanes_kernel<false>, lanes, b, dev, false,
                        false, s);
  return launch_lanes(replay_lanes_kernel<true>, lanes, b, dev, true, false, s);
}

// replay_blocked over b lanes, one block each; refuses lanes of different
// instantiations and the randomized configurations, as replay_blocked does
int replay_blocked_lanes(const ReplayArgs* lanes, int b, void* lanes_dev,
                         void* stream) {
  if (!check_lanes(lanes, b) || randomized(lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < b; ++l)
    if (lanes[l].n % kBlock != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (learned(lanes))
    return replay_blocked_lanes_learned(lanes, b, lanes_dev, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ReplayArgs* dev = static_cast<ReplayArgs*>(lanes_dev);
  const ReplayArgs* a = lanes;
  if (a->scratch != nullptr)
    return launch_lanes(replay_blocked_lanes_kernel<true, false>, lanes, b, dev,
                        true, true, s);
  if (fgd_only(a))
    return launch_lanes(replay_blocked_lanes_kernel<false>, lanes, b, dev,
                        false, true, s);
  if (has_column(a, kSimon))
    return launch_lanes(replay_blocked_lanes_kernel<true>, lanes, b, dev, true,
                        true, s);
  return launch_lanes(replay_blocked_lanes_kernel<true, true, false>, lanes, b,
                      dev, true, true, s);
}

}  // extern "C"

#endif  // TPUSIM_FAULTS_TU
