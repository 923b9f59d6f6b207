// Batched SVD and symmetric eigen-decomposition of small f32 matrices for
// the solvers (two-view initialization, relocalization's PnP, loop
// closing's Sim3, the BEV ICP): jacobi_svd_f32 stands for the JAX
// package's jnp.linalg.svd, jacobi_eigh_f32 for its jnp.linalg.eigh, at
// the solvers' shapes (at most 12 columns and 16 rows, batches of the 256
// RANSAC hypotheses or one matrix; a taller matrix, pnp_dlt on 9 to 32
// points, up to 64 rows, gives S and V only). They replace no Pallas
// kernel: the JAX package leaves these decompositions to XLA. Here they
// replace torch.linalg.svd / eigh, which go to cuSOLVER and check its
// `info` on the host, one sync per call; these launch once, never
// synchronise and give NaN for a matrix with a non-finite entry, as JAX
// does.
//
// What bounds them: neither bytes nor operations. At 256 matrices of
// 12x12 the inputs and outputs are a few hundred KB and the rotations a few
// tens of MFLOP, under a microsecond of the card, so the bound is far below
// what a launch costs. What is left is latency: a Jacobi sweep is a chain
// of dependent steps, each a dot product over the rows, an angle (square
// roots and divisions, correctly rounded) and an update. The design
// spreads each matrix over a lane group of a warp (4, 8 or 16 lanes, one
// row of the matrix and of V a lane, up to 16 rows; 32 lanes of 2 rows
// above), in registers for the SVD: a dot product is a two- to five-step
// shuffle butterfly instead of a serial loop over the rows, an update one
// lane-local step. The SVD takes its column pairs in a round-robin order
// whose disjoint pairs share one butterfly, lane i working out pair i's
// angle (a 12-column sweep is 11 steps, not 66), with the pairs at fixed
// register slots and the rounds as a loop (a fully unrolled sweep ran
// slower). The eigensolver keeps its matrix in a
// per-group shared tile, where each rotation indexes its rows and columns
// directly, cyclic one pair at a time (a round-robin there, with two
// passes and a copy of the triangle a round, ran slower). Groups that
// share a warp vote on their sweep loops, so the warp never diverges.
// Blocks of 128 threads (the block size changed nothing between 32 and
// 128); U is assembled in a per-group shared tile where columns have to
// be completed.
// The kernels allocate nothing and do not synchronise; each entry point
// launches on the given stream and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "small_linalg.cuh"

namespace {

// threads a block
constexpr int kThreads = 128;

// The lanes of a warp that work on one matrix: G of them, G = 4, 8, 16 or
// 32. `warp` names the lanes of the warp's groups that are at work (a group
// past the end of the batch is not): groups fill a warp's lanes in order.
template <int G>
struct WarpLanes {
  static constexpr int kSize = G;
  using F = float;
  using I = int;
  using B = bool;

  unsigned mask, warp;
  int l;

  __device__ WarpLanes(int tid, int groups_at_work)
      : mask((0xffffffffu >> (32 - G)) << (tid & 31 & ~(G - 1))),
        warp(groups_at_work * G >= 32 ? 0xffffffffu
                                      : (1u << (groups_at_work * G)) - 1u),
        l(tid & (G - 1)) {}

  __device__ int lane() const { return l; }
  template <class X>
  __device__ X sel(bool b, X x, X y) const { return b ? x : y; }
  __device__ bool finite(float x) const { return fabsf(x) <= FLT_MAX; }
  __device__ float abs(float x) const { return fabsf(x); }
  __device__ float sqrt(float x) const { return sqrtf(x); }
  __device__ float sign(float x) const { return copysignf(1.f, x); }
  __device__ float pow2_inv(float x) const {
    // x's biased exponent E: x in [2^(E-127), 2^(E-126)), so 2^(126-E)
    const int e = (__float_as_int(x) >> 23) & 0xff;
    return x < FLT_MIN ? 1.f : __int_as_float((253 - min(e, 252)) << 23);
  }
  __device__ float fmax(float x, float y) const { return fmaxf(x, y); }

  template <int K>
  __device__ void sum(float (&out)[K], const float (&x)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = x[k];
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) out[k] += __shfl_xor_sync(mask, out[k], o, G);
    }
  }
  __device__ float sum(float x) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o, G);
    return x;
  }
  __device__ float max(float x) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      x = fmaxf(x, __shfl_xor_sync(mask, x, o, G));
    }
    return x;
  }
  __device__ int argmax(float x) const {
    int i = l;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(mask, x, o, G);
      const int j = __shfl_xor_sync(mask, i, o, G);
      if (y > x || (y == x && j < i)) {
        x = y;
        i = j;
      }
    }
    return i;
  }
  __device__ bool all(bool b) const { return __all_sync(mask, b); }
  __device__ bool any(bool b) const { return __any_sync(mask, b); }
  __device__ bool any_warp(bool b) const { return __any_sync(warp, b); }
  __device__ float bcast(float x, int src) const {
    return __shfl_sync(mask, x, src, G);
  }
  __device__ float load(const float* p, int off, bool ok) const {
    return ok ? p[off] : 0.f;
  }
  __device__ void store(float* p, int off, bool ok, float x) const {
    if (ok) p[off] = x;
  }
  __device__ void store1(float* p, int off, float x) const {
    if (l == 0) p[off] = x;
  }
  __device__ void sync() const { __syncwarp(mask); }
};

// The group of matrix b, of G lanes: its lanes and the warp's groups at
// work (those of the warp's matrices that are < batch).
template <int G>
__device__ WarpLanes<G> group_of(long long b, int batch) {
  constexpr int kPerWarp = 32 / G;
  const long long left = batch - (b - b % kPerWarp);
  return WarpLanes<G>(threadIdx.x, left < kPerWarp ? static_cast<int>(left)
                                                   : kPerWarp);
}

template <int G, int ROWS>
__global__ void __launch_bounds__(kThreads)
svd_kernel(const float* __restrict__ A, int batch, int m, int n, float* S,
           float* U, float* Vh) {
  __shared__ float tiles[kThreads / G][G * small_linalg::kTileStride];
  const long long b = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) / G;
  if (b >= batch) return;
  const long long k = m < n ? m : n;
  small_linalg::svd<WarpLanes<G>, ROWS>(
      group_of<G>(b, batch), A + b * m * n, m, n, S + b * k,
      U ? U + b * m * m : nullptr, Vh + b * n * n, tiles[threadIdx.x / G]);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
eigh_kernel(const float* __restrict__ A, int batch, int n, float* w,
            float* V) {
  __shared__ float tiles[kThreads / G][2 * G * small_linalg::kEighStride];
  const long long b = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) / G;
  if (b >= batch) return;
  const long long nn = static_cast<long long>(n) * n;
  small_linalg::eigh(
      group_of<G>(b, batch), A + b * nn, n, w + b * n, V + b * nn,
      tiles[threadIdx.x / G]);
}

__global__ void empty_kernel() {}

int blocks(int batch, int group) {
  return static_cast<int>((static_cast<long long>(batch) * group + kThreads -
                           1) / kThreads);
}

}  // namespace

// A (batch, m, n) -> S (batch, min(m, n)) descending, U (batch, m, m) and
// Vh (batch, n, n), all contiguous f32; U may be null. n <= 12; m <= 16,
// or m <= 64 when U is null.
extern "C" int jacobi_svd_f32(const float* A, int batch, int m, int n,
                              float* S, float* U, float* Vh, void* stream) {
  const int group = small_linalg::svd_group(m, n);
  if (batch < 1 || m < 1 || n < 1 || n > small_linalg::kMaxN ||
      Vh == nullptr || group == 0 ||
      (U != nullptr && m > small_linalg::kMaxM)) {
    return cudaErrorInvalidValue;
  }
  const int grid = blocks(batch, group);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 4) {
    svd_kernel<4, 1><<<grid, kThreads, 0, s>>>(A, batch, m, n, S, U, Vh);
  } else if (group == 8) {
    svd_kernel<8, 1><<<grid, kThreads, 0, s>>>(A, batch, m, n, S, U, Vh);
  } else if (group == 16) {
    svd_kernel<16, 1><<<grid, kThreads, 0, s>>>(A, batch, m, n, S, U, Vh);
  } else {
    svd_kernel<32, 2><<<grid, kThreads, 0, s>>>(A, batch, m, n, S, U, Vh);
  }
  return cudaGetLastError();
}

// A (batch, n, n) symmetric (lower triangle read) -> w (batch, n) ascending
// and V (batch, n, n) with the eigenvectors in its columns.
extern "C" int jacobi_eigh_f32(const float* A, int batch, int n, float* w,
                               float* V, void* stream) {
  if (batch < 1 || n < 1 || n > small_linalg::kMaxN) {
    return cudaErrorInvalidValue;
  }
  const int group = small_linalg::eigh_group(n);
  const int grid = blocks(batch, group);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 4) {
    eigh_kernel<4><<<grid, kThreads, 0, s>>>(A, batch, n, w, V);
  } else if (group == 8) {
    eigh_kernel<8><<<grid, kThreads, 0, s>>>(A, batch, n, w, V);
  } else {
    eigh_kernel<16><<<grid, kThreads, 0, s>>>(A, batch, n, w, V);
  }
  return cudaGetLastError();
}

// One launch of an empty kernel of one block, on the given stream: the
// floor under any launch of this library, for timing beside the kernels.
extern "C" int small_linalg_empty(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
