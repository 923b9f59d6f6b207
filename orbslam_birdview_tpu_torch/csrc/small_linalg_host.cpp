// Host build of the per-matrix Jacobi routines of small_linalg.cuh, the
// same code the kernels of small_linalg.cu run, one matrix after another.
// Built with the host C++ compiler; used by the tests, which hold it
// against the JAX package's svd / eigh where there is no card. The entry
// points take the kernels' arguments without the stream, plus `sweeps`
// ((batch,) int32, may be null), which receives each matrix's sweep count
// for the tests' convergence check; they return 0, or 1 for a size the
// routines do not take.
#include "small_linalg.cuh"

extern "C" int jacobi_svd_f32_host(const float* A, int batch, int m, int n,
                                   float* S, float* U, float* Vh,
                                   int* sweeps) {
  using namespace small_linalg;
  if (batch < 0 || m < 1 || n < 1 || n > kMaxN || (U && m > kMaxM)) return 1;
  float W[kMaxM * kMaxN];
  float V[kMaxN * kMaxN];
  const long long k = m < n ? m : n;
  for (long long b = 0; b < batch; ++b) {
    const int it = svd(A + b * m * n, W, V, 1, m, n, S + b * k,
                       U ? U + b * m * m : nullptr,
                       Vh ? Vh + b * n * n : nullptr);
    if (sweeps) sweeps[b] = it;
  }
  return 0;
}

extern "C" int jacobi_eigh_f32_host(const float* A, int batch, int n,
                                    float* w, float* V, int* sweeps) {
  using namespace small_linalg;
  if (batch < 0 || n < 1 || n > kMaxN) return 1;
  float M[kMaxN * kMaxN];
  float Vw[kMaxN * kMaxN];
  for (long long b = 0; b < batch; ++b) {
    const int it = eigh(A + b * n * n, M, Vw, 1, n, w + b * n, V + b * n * n);
    if (sweeps) sweeps[b] = it;
  }
  return 0;
}
