// The element chain of the fused plasticity step: the CUDA kernels
// (sm_90a).
//
// Replaces the per-cell products that the JAX package computes as XLA
// einsums (dolfinx_external_operator_tpu/parallel/spmd.py:493 strain,
// :508 residual, :514-516 tangent matvec, :521 diagonal, the element
// blocks at :612, :651, :745, :794, :947, the element-blocked matvec at
// :617-620, parallel/mg.py:890 the AMG setup's level-1 triple and
// assembly.py:114-139 the operand evaluation), which the port's plain
// versions (ops/element_chain.py) run as torch einsums, matmuls and
// torch.bmm.  Five kernels, one thread for each output, each output one
// sum in the fixed order of element_chain.cuh:
//
//   E1 cell_strain    (c, q, i)  deps of the Gauss points, fed to K1 / K2
//   E2 cell_residual  (c, k)     the cells' residual contributions
//   E3 cell_tangent   (c, k) or (c, k, l): mode 0 the tangent matvec,
//                     1 its diagonal, 2 the f64 blocks, 3 the f32 blocks
//   E4 ebe_matvec     (c, a)     the element-blocked matvec, f64 or f32 (also
//                                the general pipeline's matrix-free action)
//   E5 cell_product   (b0, b1, m, n)  a batched product at any strides, f64
//                                or f32 (the general pipeline's operand
//                                evaluation); its values-and-gradients
//                                pair and the level-1 triple each one
//                                launch at the repo's shapes
//
// Why by hand: the batched products' kernels that cuBLAS picks depend on
// the batch count, so a rank's cells gave other bits than the whole
// batch's (tools/slice_bits.py).  Here no kernel reads the batch to pick
// a tile, a grid split or a reduction: the grid only covers the outputs,
// a thread computes one output from its own indices alone, with no split
// sum and no atomics.
//
// What bounds them: at the main path's 1,250 cells each moves 1-3 MB
// (B alone, 1,250 x 3 x 4 x 12 f64, is 1.44 MB), well under a microsecond
// at 3.35 TB/s, below the ~1 us that a launch costs on this card; the
// operations (at most ~0.2 MFLOP an E3 call) are further below their
// f64 peak.  So the time is latency: the launch, then the chain of
// dependent loads on a thread's path, and whatever a thread recomputes
// that its cell's other threads compute too.  The unstaged kernels loop
// over run-time trip counts, so they issue their loads one iteration
// after another, and E3's recompute a cell's strain (matvec) or its C B
// table (blocks) in every output.  At the shapes the repo runs each
// kernel is staged; staging moves where an operand is read from, never a
// sum's order, so the staged kernels give the unstaged ones' bits:
//   E1, E4 (12 outputs a cell, each a sum of 12 gathered terms): a block
//     takes kThreads / 12 cells, each thread loads its row of the cell's
//     block into registers and the block gathers each cell's 12 vector
//     entries once into shared memory (an index, then its value; every
//     load in flight at once), then after one barrier each thread sums
//     its output through the same body (ec_dot): two dependent global
//     round trips in place of twelve.
//   E2, E3 (3 points of 4 components, 12 dofs a cell; element_chain.cuh,
//     ec_quad_staged): trip counts fixed at compile time, and each thread
//     issues every load of its operands at its start (ec_*_load: one
//     round trip).  E2 and the diagonal then sum one output a thread
//     (the diagonal's C B terms are its own); the matvec gathers each
//     cell's x once into shared memory and computes its de, dsig and y
//     once a cell in three stages a barrier apart, 12 threads a cell, 10
//     cells a block; the blocks, 144 threads a cell and one cell a block,
//     read the cell's B once into shared memory, compute its C B table
//     once (an entry a thread), then each output from B's and the
//     table's columns, a barrier between the stages.
//   E5 (element_chain.cuh, ec_product_staged_form, ec_pair_staged_form,
//     ec_triple_staged): the product at summed lengths 2, 3, 6 takes the
//     length as a template parameter, 32-bit indices split by divisors
//     fixed on the host (the unstaged body splits with four 64-bit
//     divisions, emulated in tens of instructions each), and reads A
//     where it is small enough to be a table (a basis or geometry
//     tabulation) once a block into shared memory, its copy in flight
//     with the thread's other loads before one barrier.  The pair of a
//     coefficient's values and gradients reads a group of cells' dofs
//     once into shared memory and writes both outputs in one launch; the
//     level-1 triple keeps T = W^T K in shared memory (in f32, as the two
//     launches store it) and computes T W in the same launch.
// Every other shape takes the unstaged kernel (the pair and the triple
// there are two ec_product_launch calls; their own launchers refuse those
// shapes).  Each launcher runs on the
// caller's stream, does not synchronise and allocates nothing
// (graph-capturable), and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "element_chain.cuh"

namespace {

constexpr int kThreads = 128;
// a grid-stride loop past this many blocks (never reached by this repo's
// meshes; no output's value depends on the grid)
constexpr long long kMaxBlocks = 1LL << 20;

unsigned int grid_for(long long outputs) {
  const long long need = (outputs + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(need < kMaxBlocks ? need : kMaxBlocks);
}

__device__ __forceinline__ long long first_output() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long output_stride() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

// the blocks' strides of E4, passed by value
struct EcStrides3 {
  long long s[3];
};

__global__ void __launch_bounds__(kThreads)
cell_strain_kernel(const double* __restrict__ B, const long long* __restrict__ dof,
                   const double* __restrict__ u, long long n, double* __restrict__ out,
                   const EcShape s) {
  const long long total = s.nc * s.nq * s.ni;
  for (long long t = first_output(); t < total; t += output_stride()) {
    const int i = static_cast<int>(t % s.ni);
    const long long cq = t / s.ni;
    out[t] = ec_strain(B, dof, u, n, s, cq / s.nq, static_cast<int>(cq % s.nq), i);
  }
}

__global__ void __launch_bounds__(kThreads)
cell_residual_kernel(const double* __restrict__ B, const double* __restrict__ sig, long long s0,
                     long long s1, long long s2, const double* __restrict__ w,
                     double* __restrict__ out, const EcShape s) {
  const long long total = s.nc * s.nk;
  for (long long t = first_output(); t < total; t += output_stride()) {
    out[t] = ec_residual(B, sig, s0, s1, s2, w, s, t / s.nk, static_cast<int>(t % s.nk));
  }
}

__global__ void __launch_bounds__(kThreads)
cell_tangent_vec_kernel(int mode, const double* __restrict__ B, const EcTangent tg,
                        const double* __restrict__ w, const long long* __restrict__ dof,
                        const double* __restrict__ x, long long n, double* __restrict__ out,
                        const EcShape s) {
  const long long total = s.nc * s.nk;
  for (long long t = first_output(); t < total; t += output_stride()) {
    const long long c = t / s.nk;
    const int k = static_cast<int>(t % s.nk);
    out[t] = mode == 0 ? ec_tangent_matvec(B, tg, w, dof, x, n, s, c, k)
                       : ec_tangent_block<double>(B, tg, w, nullptr, s, c, k, k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_tangent_block_kernel(const double* __restrict__ B, const EcTangent tg,
                          const double* __restrict__ w, const double* __restrict__ keep,
                          T* __restrict__ out, const EcShape s) {
  const long long kk = static_cast<long long>(s.nk) * s.nk;
  const long long total = s.nc * kk;
  for (long long t = first_output(); t < total; t += output_stride()) {
    const long long r = t % kk;
    out[t] = ec_tangent_block<T>(B, tg, w, keep, s, t / kk, static_cast<int>(r / s.nk),
                                 static_cast<int>(r % s.nk));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ebe_matvec_kernel(const T* __restrict__ K, const EcStrides3 ks, const long long* __restrict__ idx,
                  const T* __restrict__ x, long long n, T* __restrict__ out, long long nc, int na,
                  int nb, int bs) {
  const long long total = nc * na;
  for (long long t = first_output(); t < total; t += output_stride()) {
    out[t] = ec_ebe<T>(K, ks.s, idx, x, n, t / na, static_cast<int>(t % na), nb, bs);
  }
}

// E1 and E4 staged: NA outputs a cell, each the sum of NB terms K[c, a, b]
// x[gathered b]; a block takes G cells.  Each thread loads its output's
// row of K into registers (NB independent loads, all in flight), the
// block gathers each cell's NB vector entries once into shared memory
// (an index, then its value), and after one barrier each thread sums its
// row against the cell's entries.  (Staging the rows of K in shared
// memory as well, with coalesced loads, was slower on the H100: the
// stores to shared memory wait for the loads, ahead of the barrier.)
constexpr int kStagedNA = 12;
constexpr int kStagedNB = 12;
// cells a block of the staged kernel at NA outputs a cell
template <int NA>
constexpr int kStagedCells = kThreads / NA;

template <typename T, int NA, int NB, int BS>
__global__ void __launch_bounds__(kThreads)
staged_matvec_kernel(const T* __restrict__ K, const EcStrides3 ks,
                     const long long* __restrict__ idx, const T* __restrict__ x, long long n,
                     T* __restrict__ out, long long nc) {
  constexpr int G = kStagedCells<NA>;
  static_assert(G >= 1 && G * NB <= kThreads && NB % BS == 0, "staged shape");
  __shared__ T xs[G * NB];
  const int tid = threadIdx.x;
  for (long long c0 = static_cast<long long>(blockIdx.x) * G; c0 < nc;
       c0 += static_cast<long long>(gridDim.x) * G) {
    const int cells = nc - c0 < G ? static_cast<int>(nc - c0) : G;
    const bool mine = tid < cells * NA;
    T row[NB];
    if (mine) {
      const T* r = K + (c0 + tid / NA) * ks.s[0] + (tid % NA) * ks.s[1];
#pragma unroll
      for (int b = 0; b < NB; ++b) row[b] = r[b * ks.s[2]];
    }
    if (tid < cells * NB) {
      const int g = tid / NB, b = tid % NB;
      const long long node = idx[(c0 + g) * (NB / BS) + b / BS];
      xs[tid] = ec_read<T>(x, n, node < 0 ? -1 : node * BS + b % BS);
    }
    __syncthreads();
    if (mine) {
      const T* xg = xs + (tid / NA) * NB;
      out[c0 * NA + tid] = ec_dot(row, 1, [&](int b) { return xg[b]; }, NB);
    }
    __syncthreads();
  }
}

// blocks for groups of G cells a block
unsigned int grid_of_groups(long long nc, int G) {
  const long long need = (nc + G - 1) / G;
  return static_cast<unsigned int>(need < kMaxBlocks ? need : kMaxBlocks);
}

template <typename T, int BS>
void launch_staged(const T* K, const EcStrides3& ks, const long long* idx, const T* x,
                   long long n, T* out, long long nc, cudaStream_t st) {
  staged_matvec_kernel<T, kStagedNA, kStagedNB, BS>
      <<<grid_of_groups(nc, kStagedCells<kStagedNA>), kThreads, 0, st>>>(K, ks, idx, x, n, out,
                                                                         nc);
}

// E2 and E3 staged at the shape of element_chain.cuh (ec_quad_staged: 3
// points, 4 components, 12 dofs), through its loads and stages.  E2 and
// the diagonal: one thread an output, every operand loaded up front (no
// stage is shared between a cell's outputs).
__global__ void __launch_bounds__(kThreads)
staged_residual_kernel(const double* __restrict__ B, const double* __restrict__ sig, long long s0,
                       long long s1, long long s2, const double* __restrict__ w,
                       double* __restrict__ out, long long nc) {
  for (long long t = first_output(); t < nc * kEcNK; t += output_stride()) {
    EcResidualOps o;
    ec_residual_load(o, B, sig, s0, s1, s2, w, t / kEcNK, static_cast<int>(t % kEcNK));
    out[t] = ec_residual_staged(o);
  }
}

__global__ void __launch_bounds__(kThreads)
staged_tangent_diag_kernel(const double* __restrict__ B, const EcTangent tg,
                           const double* __restrict__ w, double* __restrict__ out, long long nc) {
  for (long long t = first_output(); t < nc * kEcNK; t += output_stride()) {
    EcDiagOps o;
    ec_diag_load(o, B, tg, w, t / kEcNK, static_cast<int>(t % kEcNK));
    out[t] = ec_diag_staged(o);
  }
}

// The matvec: a block takes kEcVecCells cells, 12 threads each; every
// thread loads its operands, the block gathers each cell's x once into
// shared memory, then three stages, a barrier apart, compute each cell's
// de, dsig and y once (ec_matvec_de, _ds, _out).
__global__ void __launch_bounds__(kThreads)
staged_tangent_matvec_kernel(const double* __restrict__ B, const EcTangent tg,
                             const double* __restrict__ w, const long long* __restrict__ dof,
                             const double* __restrict__ x, long long n, double* __restrict__ out,
                             long long nc) {
  constexpr int G = kEcVecCells;
  static_assert(G * kEcNK <= kThreads, "staged matvec group");
  __shared__ double xs[G * kEcNK], de[G * kEcNK], ds[G * kEcNK];
  const int tid = threadIdx.x, r = tid % kEcNK, cell = tid - r;
  for (long long c0 = static_cast<long long>(blockIdx.x) * G; c0 < nc;
       c0 += static_cast<long long>(gridDim.x) * G) {
    const int cells = nc - c0 < G ? static_cast<int>(nc - c0) : G;
    const bool mine = tid < cells * kEcNK;
    EcMatvecOps o;
    if (mine) {
      ec_matvec_load(o, B, tg, w, dof, c0 + tid / kEcNK, r);
      xs[tid] = ec_read<double>(x, n, o.dof);
    }
    __syncthreads();
    if (mine) de[tid] = ec_matvec_de(o, xs + cell);
    __syncthreads();
    if (mine) ds[tid] = ec_matvec_ds(o, de + cell, r);
    __syncthreads();
    if (mine) out[c0 * kEcNK + tid] = ec_matvec_out(o, ds + cell);
    __syncthreads();
  }
}

// The blocks in T: a block takes kEcBlockCells cells, 144 threads each;
// every thread loads its operands and one entry of its cell's B into
// shared memory (the cell's B is read once, coalesced, where each thread
// would read 16 of its entries); after a barrier each computes its entry
// of the cell's table t[q, i, l] once into shared memory, and after
// another its output from the columns of B and the table
// (ec_block_table, ec_block_out).  One cell a block beat two (a block of
// 288 threads fills its warps) and four.
constexpr int kBlockThreads = kEcBlockCells * kEcNK * kEcNK;

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
staged_tangent_block_kernel(const double* __restrict__ B, const EcTangent tg,
                            const double* __restrict__ w, const double* __restrict__ keep,
                            T* __restrict__ out, long long nc) {
  constexpr int G = kEcBlockCells, R = kEcNK * kEcNK;
  __shared__ T bs[G * R], tab[G * R];
  const int tid = threadIdx.x, r = tid % R, cell = tid - r;
  for (long long c0 = static_cast<long long>(blockIdx.x) * G; c0 < nc;
       c0 += static_cast<long long>(gridDim.x) * G) {
    const int cells = nc - c0 < G ? static_cast<int>(nc - c0) : G;
    const bool mine = tid < cells * R;
    EcBlockOps<T> o;
    if (mine) bs[tid] = ec_block_load(o, B, tg, w, keep, c0 + tid / R, r);
    __syncthreads();
    if (mine) tab[tid] = ec_block_table(o, bs + cell, r);
    __syncthreads();
    if (mine) out[c0 * R + tid] = ec_block_out(o, bs + cell, tab + cell, r, keep != nullptr);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_product_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ out,
                    const EcProduct p) {
  const long long total = p.n[0] * p.n[1] * p.n[2] * p.n[3];
  for (long long t = first_output(); t < total; t += output_stride()) {
    out[t] = ec_product<T>(A, B, p, t);
  }
}

// E5 staged (element_chain.cuh, ec_product_staged_form): the summed
// length NK fixed, 32-bit indices split by the host's divisors, one
// output a thread.  Each thread first issues the loads of its operands
// that are not the table (ec_product_load) and its share of the table (A,
// where p.tab_n > 0) into shared memory, all in flight together; after
// one barrier it reads the table's values there and sums
// (ec_product_sum).
template <typename T>
__device__ __forceinline__ void copy_table(const T* src, int n, T* tab) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = src[i];
}

template <typename T, int NK>
__global__ void __launch_bounds__(kThreads)
staged_product_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ out,
                      const EcProduct32 p) {
  __shared__ T tab[kEcTableMax];
  const long long t0 = first_output();
  EcProductOps<T, NK> o;
  if (t0 < p.total) ec_product_load(o, A, B, p, static_cast<int>(t0));
  if (p.tab_n > 0) {
    copy_table(A, p.tab_n, tab);
    __syncthreads();
  }
  for (long long t = t0; t < p.total; t += output_stride()) {
    if (t != t0) ec_product_load(o, A, B, p, static_cast<int>(t));
    out[t] = ec_product_sum(o, tab, p);
  }
}

// The values-and-gradients pair of one coefficient in one launch: a
// block takes G cells (ec_pair_staged_form); each thread issues its loads
// (a gradient's row of gp), its entries of the group's d2 and of phi (the
// table, once a block), all in flight, d2 and phi into shared memory;
// after a barrier each computes its output (ec_pair_out), the group's
// values and then its gradients written coalesced.
template <typename T, int NB>
__global__ void __launch_bounds__(kEcPairThreads)
staged_values_grads_kernel(const T* __restrict__ phi, const T* __restrict__ gp,
                           const T* __restrict__ d2, T* __restrict__ val, T* __restrict__ grad,
                           const EcPair p) {
  // a group's d2: G nb bs <= nb kEcPairThreads / (1 + ng) entries
  __shared__ T tab[kEcTableMax], ds[NB * (kEcPairThreads / (1 + kEcPairNG))];
  copy_table(phi, p.tab_n, tab);  // before the first group's barrier
  const int tid = threadIdx.x, nd = p.nbbs.d;
  for (long long c0 = static_cast<long long>(blockIdx.x) * p.G; c0 < p.nc;
       c0 += static_cast<long long>(gridDim.x) * p.G) {
    const int cells = p.nc - c0 < p.G ? static_cast<int>(p.nc - c0) : p.G;
    EcPairOut<T, NB> o;
    const bool mine = ec_pair_load(o, gp, val, grad, p, c0, cells, tid);
    for (int i = tid; i < cells * nd; i += kEcPairThreads) ds[i] = ec_pair_d2(d2, p, c0, i);
    __syncthreads();
    if (mine) *o.dst = ec_pair_out(o, tab, ds + o.cell * nd, p);
    __syncthreads();
  }
}

// The level-1 triple in one launch: a block takes G cells, 72 threads
// each.  Every thread loads one entry of its group's W and two of its K
// (coalesced, all in flight) into shared memory; after a barrier each
// computes one entry of its cell's T = W^T K (ec_triple_t), kept in
// shared memory in f32 as the first of the two products stores it; after
// another the first 36 of a cell's threads compute out = T W
// (ec_triple_out), written coalesced.
constexpr int kTripleCell = kEcTripleNK * kEcTripleNA;  // W's and T's entries, threads a cell
constexpr int kTripleThreads = kEcTripleCells * kTripleCell;
static_assert(kEcTripleNK * kEcTripleNK == 2 * kTripleCell, "two of K's entries a thread");

__global__ void __launch_bounds__(kTripleThreads)
staged_triple_kernel(const float* __restrict__ W, const float* __restrict__ K,
                     float* __restrict__ out, long long nc) {
  constexpr int G = kEcTripleCells, NW = kTripleCell, NKK = 2 * kTripleCell,
                NO = kEcTripleNA * kEcTripleNA;
  __shared__ float ws[G * NW], ks[G * NKK], ts[G * NW];
  const int tid = threadIdx.x, r = tid % NW, cell = tid / NW;
  for (long long c0 = static_cast<long long>(blockIdx.x) * G; c0 < nc;
       c0 += static_cast<long long>(gridDim.x) * G) {
    const int cells = nc - c0 < G ? static_cast<int>(nc - c0) : G;
    const int n = cells * NW;
    const float* Wg = W + c0 * NW;
    const float* Kg = K + c0 * NKK;
    if (tid < n) {
      const float w = Wg[tid], k0 = Kg[tid], k1 = Kg[n + tid];
      ws[tid] = w;
      ks[tid] = k0;
      ks[n + tid] = k1;
    }
    __syncthreads();
    if (tid < n) ts[tid] = ec_triple_t(ws + cell * NW, ks + cell * NKK, r);
    __syncthreads();
    if (tid < cells * NO) {
      const int g = tid / NO;
      out[c0 * NO + tid] = ec_triple_out(ts + g * NW, ws + g * NW, tid % NO);
    }
    __syncthreads();
  }
}

template <typename T>
void launch_staged_product(const T* A, const T* B, T* out, const EcProduct32& q, int nk,
                           cudaStream_t st) {
  const unsigned int grid = grid_for(q.total);
  if (nk == 2) {
    staged_product_kernel<T, 2><<<grid, kThreads, 0, st>>>(A, B, out, q);
  } else if (nk == 3) {
    staged_product_kernel<T, 3><<<grid, kThreads, 0, st>>>(A, B, out, q);
  } else {
    staged_product_kernel<T, 6><<<grid, kThreads, 0, st>>>(A, B, out, q);
  }
}

template <typename T>
void launch_staged_pair(const T* phi, const T* gp, const T* d2, T* val, T* grad,
                        const EcPair& q, int nb, cudaStream_t st) {
  const unsigned int grid = grid_of_groups(q.nc, q.G);
  if (nb == 2) {
    staged_values_grads_kernel<T, 2><<<grid, kEcPairThreads, 0, st>>>(phi, gp, d2, val, grad, q);
  } else if (nb == 3) {
    staged_values_grads_kernel<T, 3><<<grid, kEcPairThreads, 0, st>>>(phi, gp, d2, val, grad, q);
  } else {
    staged_values_grads_kernel<T, 6><<<grid, kEcPairThreads, 0, st>>>(phi, gp, d2, val, grad, q);
  }
}

bool shape_ok(long long nc, int nq, int ni, int nk) {
  return nc >= 0 && nq > 0 && ni > 0 && ni <= kEcMaxComp && nk > 0;
}

}  // namespace

// E1: B (nc, nq, ni, nk), dof (nc, nk), u (n,), out (nc, nq, ni); all f64
// but dof (int64), contiguous.
extern "C" int ec_strain_launch(const double* B, const long long* dof, const double* u,
                                long long n, double* out, long long nc, int nq, int ni, int nk,
                                void* stream) {
  if (!shape_ok(nc, nq, ni, nk)) return static_cast<int>(cudaErrorInvalidValue);
  const EcShape s{nc, nq, ni, nk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 0 && nq * ni == kStagedNA && nk == kStagedNB) {
    // B as the (nc, nq * ni, nk) blocks of E4 against u gathered by dof
    const EcStrides3 rows{{static_cast<long long>(nq) * ni * nk, nk, 1}};
    launch_staged<double, 1>(B, rows, dof, u, n, out, nc, st);
  } else if (nc > 0) {
    cell_strain_kernel<<<grid_for(nc * nq * ni), kThreads, 0, st>>>(B, dof, u, n, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// E2: sigma (nc, nq, ni) at strides (s0, s1, s2), w (nc, nq), out (nc, nk).
extern "C" int ec_residual_launch(const double* B, const double* sig, long long s0, long long s1,
                                  long long s2, const double* w, double* out, long long nc,
                                  int nq, int ni, int nk, void* stream) {
  if (!shape_ok(nc, nq, ni, nk)) return static_cast<int>(cudaErrorInvalidValue);
  const EcShape s{nc, nq, ni, nk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 0 && ec_quad_staged(nq, ni, nk)) {
    staged_residual_kernel<<<grid_for(nc * nk), kThreads, 0, st>>>(B, sig, s0, s1, s2, w, out, nc);
  } else if (nc > 0) {
    cell_residual_kernel<<<grid_for(nc * nk), kThreads, 0, st>>>(B, sig, s0, s1, s2, w, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// E3: C (nc, nq, ni, ni) at strides c0..c3.  mode 0: the matvec against x
// (n,) gathered by dof, out (nc, nk) f64; 1: the diagonal, out (nc, nk)
// f64; 2: the blocks, out (nc, nk, nk) f64; 3: the blocks in f32, out
// f32.  keep (nc, nk) f64 or null masks the blocks (modes 2 and 3).
extern "C" int ec_tangent_launch(int mode, const double* B, const double* C, long long c0,
                                 long long c1, long long c2, long long c3, const double* w,
                                 const long long* dof, const double* x, long long n,
                                 const double* keep, void* out, long long nc, int nq, int ni,
                                 int nk, void* stream) {
  if (!shape_ok(nc, nq, ni, nk) || mode < 0 || mode > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EcShape s{nc, nq, ni, nk};
  const EcTangent tg{C, {c0, c1, c2, c3}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 0 && ec_quad_staged(nq, ni, nk)) {
    double* od = static_cast<double*>(out);
    if (mode == 0) {
      staged_tangent_matvec_kernel<<<grid_of_groups(nc, kEcVecCells), kThreads, 0, st>>>(
          B, tg, w, dof, x, n, od, nc);
    } else if (mode == 1) {
      staged_tangent_diag_kernel<<<grid_for(nc * nk), kThreads, 0, st>>>(B, tg, w, od, nc);
    } else if (mode == 2) {
      staged_tangent_block_kernel<double>
          <<<grid_of_groups(nc, kEcBlockCells), kBlockThreads, 0, st>>>(B, tg, w, keep, od, nc);
    } else {
      staged_tangent_block_kernel<float><<<grid_of_groups(nc, kEcBlockCells), kBlockThreads, 0,
                                           st>>>(B, tg, w, keep, static_cast<float*>(out), nc);
    }
  } else if (nc > 0) {
    if (mode <= 1) {
      cell_tangent_vec_kernel<<<grid_for(nc * nk), kThreads, 0, st>>>(
          mode, B, tg, w, dof, x, n, static_cast<double*>(out), s);
    } else if (mode == 2) {
      cell_tangent_block_kernel<double><<<grid_for(nc * nk * nk), kThreads, 0, st>>>(
          B, tg, w, keep, static_cast<double*>(out), s);
    } else {
      cell_tangent_block_kernel<float><<<grid_for(nc * nk * nk), kThreads, 0, st>>>(
          B, tg, w, keep, static_cast<float*>(out), s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// E4: K (nc, na, nb) at strides (k0, k1, k2), x (n,) and out (nc, na) in
// f64 (f32 == 0) or f32, idx (nc, nb / bs) int64; x, idx, out contiguous.
extern "C" int ec_ebe_launch(int f32, const void* K, long long k0, long long k1, long long k2,
                             const long long* idx, const void* x, long long n, void* out,
                             long long nc, int na, int nb, int bs, void* stream) {
  if (nc < 0 || na <= 0 || nb <= 0 || bs <= 0 || nb % bs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EcStrides3 ks{{k0, k1, k2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 0 && na == kStagedNA && nb == kStagedNB && (bs == 1 || bs == 2)) {
    if (f32) {
      const float* Kf = static_cast<const float*>(K);
      const float* xf = static_cast<const float*>(x);
      float* of = static_cast<float*>(out);
      bs == 1 ? launch_staged<float, 1>(Kf, ks, idx, xf, n, of, nc, st)
              : launch_staged<float, 2>(Kf, ks, idx, xf, n, of, nc, st);
    } else {
      const double* Kd = static_cast<const double*>(K);
      const double* xd = static_cast<const double*>(x);
      double* od = static_cast<double*>(out);
      bs == 1 ? launch_staged<double, 1>(Kd, ks, idx, xd, n, od, nc, st)
              : launch_staged<double, 2>(Kd, ks, idx, xd, n, od, nc, st);
    }
  } else if (nc > 0) {
    if (f32) {
      ebe_matvec_kernel<float><<<grid_for(nc * na), kThreads, 0, st>>>(
          static_cast<const float*>(K), ks, idx, static_cast<const float*>(x), n,
          static_cast<float*>(out), nc, na, nb, bs);
    } else {
      ebe_matvec_kernel<double><<<grid_for(nc * na), kThreads, 0, st>>>(
          static_cast<const double*>(K), ks, idx, static_cast<const double*>(x), n,
          static_cast<double*>(out), nc, na, nb, bs);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// E5: out (n0, n1, n2, n3) contiguous in f64 (f32 == 0) or f32, the sum
// over k < nk of A[i . as + k ak] B[i . bs + k bk] at the strides given
// (elements; 0 broadcasts an operand along an output axis).
extern "C" int ec_product_launch(int f32, const void* A, const void* B, void* out, long long n0,
                                 long long n1, long long n2, long long n3, long long a0,
                                 long long a1, long long a2, long long a3, long long b0,
                                 long long b1, long long b2, long long b3, long long ak,
                                 long long bk, int nk, void* stream) {
  if (n0 < 0 || n1 < 0 || n2 < 0 || n3 < 0 || nk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EcProduct p{{n0, n1, n2, n3}, {a0, a1, a2, a3}, {b0, b1, b2, b3}, ak, bk, nk};
  const long long total = n0 * n1 * n2 * n3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EcProduct32 q;
  if (total > 0 && ec_product_staged_form(p, q)) {
    if (f32) {
      launch_staged_product(static_cast<const float*>(A), static_cast<const float*>(B),
                            static_cast<float*>(out), q, nk, st);
    } else {
      launch_staged_product(static_cast<const double*>(A), static_cast<const double*>(B),
                            static_cast<double*>(out), q, nk, st);
    }
  } else if (total > 0) {
    if (f32) {
      cell_product_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
          static_cast<const float*>(A), static_cast<const float*>(B), static_cast<float*>(out),
          p);
    } else {
      cell_product_kernel<double><<<grid_for(total), kThreads, 0, st>>>(
          static_cast<const double*>(A), static_cast<const double*>(B),
          static_cast<double*>(out), p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// E5, the values-and-gradients pair of one coefficient in one launch: phi
// (nq, nb) at strides (p0, p1), gp (nc, nq, nb, ng) at (g0..g3), d2 (nc,
// nb, bs) at (d0..d2s); val (nc, nq, bs) and grad (nc, nq, bs, ng)
// contiguous, f64 (f32 == 0) or f32.  Only at the staged shapes
// (ec_pair_staged_form); anything else is refused: there the two products
// are two ec_product_launch calls.
extern "C" int ec_values_grads_launch(int f32, const void* phi, long long p0, long long p1,
                                      const void* gp, long long g0, long long g1, long long g2,
                                      long long g3, const void* d2, long long d0, long long d1,
                                      long long d2s, void* val, void* grad, long long nc,
                                      long long nq, long long nb, long long bs, long long ng,
                                      void* stream) {
  const long long ps[2] = {p0, p1}, gs[4] = {g0, g1, g2, g3}, ds[3] = {d0, d1, d2s};
  EcPair q;
  if (!ec_pair_staged_form(nc, nq, nb, bs, ng, ps, gs, ds, q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 0) {
    if (f32) {
      launch_staged_pair(static_cast<const float*>(phi), static_cast<const float*>(gp),
                         static_cast<const float*>(d2), static_cast<float*>(val),
                         static_cast<float*>(grad), q, static_cast<int>(nb), st);
    } else {
      launch_staged_pair(static_cast<const double*>(phi), static_cast<const double*>(gp),
                         static_cast<const double*>(d2), static_cast<double*>(val),
                         static_cast<double*>(grad), q, static_cast<int>(nb), st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// E5, the level-1 triple W^T K W in one launch: W (nc, nk, na) at strides
// (w0, w1, w2) and K (nc, nk, nk) at (k0, k1, k2), f32, out (nc, na, na)
// contiguous.  Only at the staged shape (ec_triple_staged); anything else
// is refused: there the triple is two ec_product_launch calls.
extern "C" int ec_triple_launch(const float* W, long long w0, long long w1, long long w2,
                                const float* K, long long k0, long long k1, long long k2,
                                float* out, long long nc, long long nk, long long na,
                                void* stream) {
  const long long ws[3] = {w0, w1, w2}, ks[3] = {k0, k1, k2};
  if (!ec_triple_staged(nc, nk, na, ws, ks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 0) {
    staged_triple_kernel<<<grid_of_groups(nc, kEcTripleCells), kTripleThreads, 0, st>>>(
        W, K, out, nc);
  }
  return static_cast<int>(cudaGetLastError());
}
