// Von Mises return map with consistent tangent: the CUDA kernels (sm_90a).
//
// Replaces dolfinx_external_operator_tpu/ops/vonmises_pallas.py::
// vonmises_return_map_pallas (the pl.pallas_call at :97, body _kernel
// :30-83), the one Pallas kernel of the JAX package.  Two entry points run
// the one per-point body (vonmises.cuh), with no communication between
// points:
//
//   - the f32 entry (vonmises_return_map_launch): the Pallas kernel's own
//     contract, f32 SoA in and out.  It reads 9 floats a point and writes
//     21: 120 bytes.
//   - the f64 entry (vonmises_f64_launch): the fused step's contract,
//     which the JAX wrapper (models/von_mises.py::pallas_batched_kernel)
//     and its first port met with a pad to the TPU's 512-lane tile, casts
//     to f32, a zero p, the kernel, slices and casts back: ten launches in
//     all.  Here the casts happen in registers and the kernel reads the
//     f64 strain and stress where they lie, at any strides (the block step
//     hands deps as the (4, n) transpose of a point-major array, strides
//     (1, 4), and sig_n SoA), so the whole call is one launch.  It reads 8
//     doubles a point and writes 20 (p and dp are optional): 224 bytes.
//
// What bounds it: bytes.  At 138 f32 operations a point (utils/roofline.py)
// against 120 or 224 bytes, the H100's 67 TFLOP/s and 3.35 TB/s put the
// operations at a tenth of the time of the bytes.  So the design is about
// the memory system:
//   - one point per thread, each value one scalar access at its strides.
//     Wider accesses (float4, double2: several points a thread) were built
//     and measured: they lose while the card's resident threads (132 SMs x
//     2,048) outnumber the points, which every workload of this repo does
//     (at 65,536 points the f32 entry took 3.20 us with one point a
//     thread, 4.26 with four; PERF.md);
//   - the outputs are written once and never read here: streaming stores
//     (__stcs) keep them from evicting what is still to be read;
//   - a grid-stride loop over at most as many blocks as the SMs hold at
//     once, fewer for small n.
// At the main path's 3,750 points the bytes take 0.13 us (f32 entry) or
// 0.25 us (f64 entry), below the ~1 us that any launch costs on this card,
// so there the launches count, not the bandwidth.
#include <cuda_runtime.h>

#include <atomic>

#include "vonmises.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 16;  // 2,048 threads: what one SM holds

// The current device's SM count, queried at its first launch and kept, so
// that a call makes no attribute query after that.
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> kept[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*sms = kept[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (dev < kMaxDevices) kept[dev].store(*sms, std::memory_order_relaxed);
  return cudaSuccess;
}

// the blocks that cover n points, at most as many as the SMs hold at once
unsigned int grid_for(long long n, int sms) {
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<unsigned int>(need < most ? need : most);
}

__global__ void __launch_bounds__(kThreads)
vonmises_f32_kernel(const float* __restrict__ deps, const float* __restrict__ sig_n,
                    const float* __restrict__ p, float* __restrict__ C,
                    float* __restrict__ sig, float* __restrict__ dp, long long n,
                    const VmParams k) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    float e[4], sn[4], c[16], s[4], d;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      e[r] = __ldg(deps + r * n + i);
      sn[r] = __ldg(sig_n + r * n + i);
    }
    vonmises_eval(e, sn, __ldg(p + i), k, c, s, d);
#pragma unroll
    for (int r = 0; r < 16; ++r) __stcs(C + r * n + i, c[r]);
#pragma unroll
    for (int r = 0; r < 4; ++r) __stcs(sig + r * n + i, s[r]);
    __stcs(dp + i, d);
  }
}

// The f64 entry: deps and sig_n at any (row, point) strides, as the fused
// step hands them (deps point-major, sig_n SoA)
__global__ void __launch_bounds__(kThreads)
vonmises_f64_kernel(const double* __restrict__ deps, long long rs_d, long long ps_d,
                    const double* __restrict__ sig_n, long long rs_s, long long ps_s,
                    const double* __restrict__ p, double* __restrict__ C,
                    double* __restrict__ sig, double* __restrict__ dp, long long n,
                    const VmParams k) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    float e[4], sn[4], c[16], s[4], d;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      e[r] = vm_narrow(__ldg(deps + r * rs_d + i * ps_d));
      sn[r] = vm_narrow(__ldg(sig_n + r * rs_s + i * ps_s));
    }
    vonmises_eval(e, sn, p == nullptr ? 0.0f : vm_narrow(__ldg(p + i)), k, c, s, d);
#pragma unroll
    for (int r = 0; r < 16; ++r) __stcs(C + r * n + i, static_cast<double>(c[r]));
#pragma unroll
    for (int r = 0; r < 4; ++r) __stcs(sig + r * n + i, static_cast<double>(s[r]));
    if (dp != nullptr) __stcs(dp + i, static_cast<double>(d));
  }
}

}  // namespace

// The f32 entry.  Launches on the caller's stream and does not
// synchronise.  Returns the CUDA error, so that a refused launch is seen by
// the caller.
extern "C" int vonmises_return_map_launch(const float* deps, const float* sig_n, const float* p,
                                          float* C, float* sig, float* dp, long long n,
                                          float lmbda, float mu, float H, float sig0,
                                          void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  vonmises_f32_kernel<<<grid_for(n, sms), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      deps, sig_n, p, C, sig, dp, n, VmParams{lmbda, mu, H, sig0});
  return static_cast<int>(cudaGetLastError());
}

// The f64 entry: deps and sig_n (4, n) f64 at (row, point) strides in
// elements; p (n,) f64 or null (p = 0); C (16, n), sig (4, n) and dp (n,)
// contiguous f64, dp null when not asked for.
extern "C" int vonmises_f64_launch(const double* deps, long long rs_d, long long ps_d,
                                   const double* sig_n, long long rs_s, long long ps_s,
                                   const double* p, double* C, double* sig, double* dp,
                                   long long n, float lmbda, float mu, float H, float sig0,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  vonmises_f64_kernel<<<grid_for(n, sms), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      deps, rs_d, ps_d, sig_n, rs_s, ps_s, p, C, sig, dp, n, VmParams{lmbda, mu, H, sig0});
  return static_cast<int>(cudaGetLastError());
}
