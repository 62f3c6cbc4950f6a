// Mohr-Coulomb return map with consistent tangent: the CUDA kernels (sm_90a).
//
// Replaces the per-Gauss-point return map that the JAX package compiles
// with XLA (not a Pallas kernel): dolfinx_external_operator_tpu/models/
// mohr_coulomb.py::MohrCoulombMaterial._build, return_mapping :224-342 and
// tangent_stress_point :344-361, with ops/abbo_sloan.py:118-166, vmapped
// at :374-376 and in the sorted chunks :384-486.
//
// What bounds it on this card: operations.  Per point it reads 64 bytes
// and writes 188, while a plastic point runs up to 8 f32 Newton iterations
// of ~2,125 operations each, then an f64 polish and a 5x5 tangent solve
// (the counts of chip_smoke.py, MC_ITER_OPS and MC_FIXED_*).  What sets
// the time is less the sum of those operations than the longest serial
// chain, and the lanes that wait on it: 79% of the main path's lanes are
// elastic and need a few hundred operations, the rest need 1 to 8
// iterations.  So the work is split in two passes (body in
// mohr_coulomb.cuh):
//
// Pass A, trial and elastic (mc_trial_pass), one thread per point,
// elementwise: the trial stress, f(sig_tr) and the convergence scale.  An
// elastic lane whose start residuals already meet both tolerances (J = I,
// no Newton step: nearly every elastic lane) then writes its whole
// result, tangent C.  Every other lane, plastic or an elastic one that
// must iterate, appends its index to a list in device memory, one
// atomicAdd per warp on a counter (__ballot_sync, then each lane's place
// by __popc): an elastic lane's serial line search in pass A would hold
// its whole warp.  The list's order differs from run to run, but it
// changes no lane's result: lanes are independent, each output is written
// at the lane's own index, and no sum runs over lanes.
//
// Pass B, listed lanes (mc_plastic_pass), a tile of 8 threads per point
// (cooperative_groups::thread_block_tile<8>, TileGroup below), persistent:
// as many blocks as the occupancy calculator fits on the card (computed
// at a device's first launch and kept), and each
// warp takes the next 4 list entries from a second atomic counter until
// the list runs out, so that lanes of 1 and of 8 iterations balance
// across the SMs.  Within a tile one iteration's work runs side by side:
// the Jacobian as four one-tangent Dual evaluations of the potential (and
// the yield surface's gradient on thread 4 when the flow is not
// associative; J = I for an elastic lane), the line search's 6 (f32) or 3
// (f64) candidates on threads 0-5, the pick by ballot, the tangent's four
// columns on threads 0-3; the 5x5 solve runs on every thread, redundantly.
// That cuts a plastic iteration's serial chain from ~2,125 operations to
// ~650.  Every
// branch inside a tile depends only on values that all its threads hold,
// so a tile never diverges; the 4 tiles of a warp may.  The price is
// redundant work (the solve on 8 threads, the value in each one-tangent
// Dual, idle roles): once the list outnumbers the tiles the card holds at
// once, a lane costs more here than on one thread (PERF.md).
//
// No host sync, and no allocation: the wrapper hands in a workspace of
// n + 2 int32 (the two counters, then the list), and the launcher resets
// the counters with cudaMemsetAsync on the caller's stream, so a call can
// be captured in a CUDA graph.  Pass B reads the list's length on the
// card, never on the host.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "mohr_coulomb.cuh"

namespace cg = cooperative_groups;

namespace mc {

__device__ __forceinline__ cg::thread_block_tile<kRoles> tile8() {
  return cg::tiled_partition<kRoles>(cg::this_thread_block());
}

// The roles of one point on the 8 threads of a tile: thread r takes role r
// (a thread past the role count repeats the last role), and exchanges by
// shuffles and ballots.
struct TileGroup {
  int rank;  // this thread's rank in its tile

  template <typename T, int W>
  struct Slots {
    T v[W];
    MC_HD T* at(int) { return v; }
  };
  MC_HD int role(int count) const { return rank < count ? rank : count - 1; }
  template <typename F>
  MC_HD void compute(int count, F&& f) {
    f(role(count));
  }
  template <typename F>
  MC_HD void store(int count, F&& f) {
    if (rank < count) f(rank);
  }
  template <typename F>
  MC_HD unsigned ballot(int count, F&& pred) {
#ifdef __CUDA_ARCH__
    return tile8().ballot(pred(role(count))) & ((1u << count) - 1u);
#else
    return 0u;
#endif
  }
  template <typename T, int W>
  MC_HD T from(Slots<T, W>& s, int src, int i) {
#ifdef __CUDA_ARCH__
    return tile8().shfl(s.v[i], src);
#else
    return s.v[i];
#endif
  }
};

}  // namespace mc

namespace {

constexpr int kThreadsA = 128;
constexpr int kThreadsB = 128;
// 65,536 / (6 x 128): at most 80 registers a thread, with some spills; at
// 65,536 points the 24 warps an SM then holds hide more of the chains'
// latency than the spills cost (PERF.md)
constexpr int kMinBlocksB = 6;
constexpr int kTilesPerWarp = 32 / mc::kRoles;
constexpr int kList = 2;  // work[0]: listed lanes, work[1]: next list entry

__global__ void __launch_bounds__(kThreadsA)
mc_trial_pass(const double* __restrict__ deps, const double* __restrict__ sig_n, mc::Outputs o,
              int* __restrict__ work, long long n, const __grid_constant__ mc::Params P) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreadsA + threadIdx.x;
  const bool valid = i < n;
  bool listed = false;
  if (valid) {
    mc::Trial t = mc::load_trial(deps, sig_n, i, n, P.c64);
    mc::set_yield(t, mc::trial_yield(t, P.c64));
    o.yielding[i] = t.f_tr;
    listed = t.f_tr > 0.0 || !mc::elastic_at_rest(t, P, o, i, n);
  }
  // append the listed lanes: one atomic per warp, each lane's place by rank
  const unsigned lane = threadIdx.x & 31u;
  const unsigned vote = __ballot_sync(0xffffffffu, listed);
  int base = 0;
  if (lane == 0u && vote != 0u) base = atomicAdd(work, __popc(vote));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (listed) work[kList + base + __popc(vote & ((1u << lane) - 1u))] = static_cast<int>(i);
}

__global__ void __launch_bounds__(kThreadsB, kMinBlocksB)
mc_plastic_pass(const double* __restrict__ deps, const double* __restrict__ sig_n, mc::Outputs o,
                int* __restrict__ work, long long n, const __grid_constant__ mc::Params P) {
  const int count = work[0];
  const unsigned lane = threadIdx.x & 31u;
  mc::TileGroup g{static_cast<int>(lane % mc::kRoles)};
  const int slot = static_cast<int>(lane / mc::kRoles);
  for (;;) {
    int base = 0;
    if (lane == 0u) base = atomicAdd(work + 1, kTilesPerWarp);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= count) break;
    const int j = base + slot;
    if (j < count) {
      const long long i = work[kList + j];
      mc::Trial t = mc::load_trial(deps, sig_n, i, n, P.c64);
      mc::set_yield(t, o.yielding[i]);
      if (t.f_tr > 0.0) {
        mc::plastic_point(g, t, P, o, i, n);
      } else {
        mc::elastic_point(g, t, P, o, i, n);
      }
    }
  }
}

// The pass-B grid on the current device: as many blocks as its SMs hold at
// once.  Computed at the device's first launch and kept, so that a call
// makes no attribute or occupancy query after that.
cudaError_t plastic_fill(long long* fill) {
  constexpr int kMaxDevices = 64;
  static std::atomic<long long> kept[kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*fill = kept[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mc_plastic_pass, kThreadsB,
                                                           0)) != cudaSuccess)
    return err;
  *fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (dev < kMaxDevices) kept[dev].store(*fill, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// Launches both passes on the caller's stream and does not synchronise.
// ``work`` is n + 2 int32 of device memory; ``params`` the host array of
// mc::kParams packed constants, read before the launch.  Returns the first
// CUDA error, so that a refused launch is seen by the caller.
extern "C" int mohr_coulomb_launch(const double* deps, const double* sig_n, double* C,
                                   double* sig, int* niter, double* yielding, double* norm_res,
                                   double* dlambda, int* work, long long n, const double* params,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const mc::Params P = mc::make_params(params);
  const mc::Outputs o{C, sig, niter, yielding, norm_res, dlambda};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long fill = 0;
  cudaError_t err;
  if ((err = plastic_fill(&fill)) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(work, 0, kList * sizeof(int), s)) != cudaSuccess) return err;
  const long long blocks_a = (n + kThreadsA - 1) / kThreadsA;
  mc_trial_pass<<<static_cast<unsigned int>(blocks_a), kThreadsA, 0, s>>>(deps, sig_n, o, work, n,
                                                                          P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // enough blocks to fill the card, and no more than n points need
  const long long need = (n + kThreadsB / mc::kRoles - 1) / (kThreadsB / mc::kRoles);
  const long long blocks_b = need < fill ? need : fill;
  mc_plastic_pass<<<static_cast<unsigned int>(blocks_b), kThreadsB, 0, s>>>(deps, sig_n, o, work,
                                                                           n, P);
  return static_cast<int>(cudaGetLastError());
}
