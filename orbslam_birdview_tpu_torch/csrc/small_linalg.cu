// Batched SVD and symmetric eigen-decomposition of small f32 matrices for
// the solvers (two-view initialization, relocalization's PnP, loop
// closing's Sim3, the BEV ICP): jacobi_svd_f32 stands for the JAX
// package's jnp.linalg.svd, jacobi_eigh_f32 for its jnp.linalg.eigh, at
// the solvers' shapes (at most 12 columns and 16 rows, batches of the 256
// RANSAC hypotheses or one matrix; a taller matrix, pnp_dlt on more than 8
// points, gives S and V only). They replace no Pallas kernel: the JAX
// package leaves these decompositions to XLA. Here they replace
// torch.linalg.svd / eigh, which go to cuSOLVER and check its `info` on
// the host, one sync per call; these launch once, never synchronise and
// give NaN for a matrix with a non-finite entry, as JAX does.
//
// What bounds them: neither bytes nor operations. At 256 matrices of
// 12x12 the inputs and outputs are a few hundred KB and the rotations a few
// tens of MFLOP, under a microsecond of the card at its f32 rate, so
// launch latency sets the bound. The design is the simple one that is
// right: one thread per matrix running the per-matrix routines of
// small_linalg.cuh, with its work matrices in shared memory, interleaved
// across the block's threads so that neighbouring threads touch
// neighbouring banks (at most (16*12 + 12*12) floats a thread, 32 threads a
// block: 43,008 bytes). A warp per matrix with a parallel rotation order is
// later work.
// The kernels allocate nothing and do not synchronise; each entry point
// launches on the given stream and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "small_linalg.cuh"

namespace {

constexpr int kThreads = 32;

// rows of the SVD's work matrix W: A's, or R's when A is reduced first
__host__ __device__ int work_rows(int m, int n) {
  return m > small_linalg::kMaxM ? n : m;
}

__global__ void __launch_bounds__(kThreads)
svd_kernel(const float* __restrict__ A, int batch, int m, int n, float* S,
           float* U, float* Vh) {
  extern __shared__ float smem[];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  float* W = smem + threadIdx.x;
  float* V = smem + work_rows(m, n) * n * kThreads + threadIdx.x;
  const long long k = m < n ? m : n;
  small_linalg::svd(A + b * static_cast<long long>(m) * n, W, V, kThreads, m,
                    n, S + b * k,
                    U ? U + b * static_cast<long long>(m) * m : nullptr,
                    Vh + b * static_cast<long long>(n) * n);
}

__global__ void __launch_bounds__(kThreads)
eigh_kernel(const float* __restrict__ A, int batch, int n, float* w,
            float* V) {
  extern __shared__ float smem[];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  float* M = smem + threadIdx.x;
  float* Vw = smem + n * n * kThreads + threadIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  small_linalg::eigh(A + b * nn, M, Vw, kThreads, n, w + b * n, V + b * nn);
}

int blocks(int batch) { return (batch + kThreads - 1) / kThreads; }

}  // namespace

// A (batch, m, n) -> S (batch, min(m, n)) descending, U (batch, m, m) and
// Vh (batch, n, n), all contiguous f32; U may be null. n <= 12; m <= 16,
// or any m when U is null.
extern "C" int jacobi_svd_f32(const float* A, int batch, int m, int n,
                              float* S, float* U, float* Vh, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || n > small_linalg::kMaxN ||
      Vh == nullptr || (U != nullptr && m > small_linalg::kMaxM)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(work_rows(m, n) * n + n * n) *
                      kThreads * sizeof(float);
  svd_kernel<<<blocks(batch), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(A, batch, m, n, S, U,
                                                     Vh);
  return cudaGetLastError();
}

// A (batch, n, n) symmetric (lower triangle read) -> w (batch, n) ascending
// and V (batch, n, n) with the eigenvectors in its columns.
extern "C" int jacobi_eigh_f32(const float* A, int batch, int n, float* w,
                               float* V, void* stream) {
  if (batch < 1 || n < 1 || n > small_linalg::kMaxN) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(2 * n * n) * kThreads * sizeof(float);
  eigh_kernel<<<blocks(batch), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(A, batch, n, w, V);
  return cudaGetLastError();
}
