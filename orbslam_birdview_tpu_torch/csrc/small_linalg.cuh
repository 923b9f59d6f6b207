// Per-matrix Jacobi routines for small dense f32 matrices: a one-sided
// (Hestenes) Jacobi SVD and a cyclic two-sided Jacobi eigensolver for
// symmetric matrices. Written once for the device kernels of
// csrc/small_linalg.cu and for the host build of csrc/small_linalg_host.cpp,
// which the tests hold against the JAX package where there is no card.
//
// A matrix lives in caller-given work storage as row-major floats with a
// stride of `s` floats between consecutive elements: the kernels interleave
// the matrices of a block's threads in shared memory (s = blockDim.x, so
// neighbouring threads touch neighbouring banks); the host build uses s = 1.
// Outputs are contiguous row-major.
//
// Both routines
// - return NaN in every output of a matrix that has a non-finite entry, as
//   the JAX package's svd / eigh do;
// - scale the matrix by a power of two (exact) so that its largest entry
//   lies in [0.5, 1), and scale the singular values / eigenvalues back;
// - run at most kMaxSweeps sweeps, stopping after the first sweep that
//   rotates nothing, and return the number of sweeps made.
#pragma once

#include <float.h>
#include <math.h>

#if defined(__CUDACC__)
#define SL_FN __host__ __device__ inline
#else
#define SL_FN inline
#endif

namespace small_linalg {

constexpr int kMaxM = 16;
constexpr int kMaxN = 12;
constexpr int kMaxSweeps = 30;

SL_FN float& at(float* p, int cols, int i, int j, int s) {
  return p[(i * cols + j) * s];
}

SL_FN bool finite(float x) { return fabsf(x) <= FLT_MAX; }

SL_FN float quiet_nan() {
#if defined(__CUDA_ARCH__)
  return __int_as_float(0x7fc00000);
#else
  return NAN;
#endif
}

// 2^-e with 2^(e-1) <= amax < 2^e: the exact scale that brings amax into
// [0.5, 1). Returns 1 for amax == 0 and sets *e = 0.
SL_FN float pow2_scale(float amax, int* e) {
  *e = 0;
  if (amax > 0.f) frexpf(amax, e);
  return ldexpf(1.f, -*e);
}

// t = tan of the Jacobi angle, the root of t^2 + 2 zeta t - 1 = 0 of least
// magnitude (sign(0) = +1: equal norms rotate by 45 degrees).
SL_FN float jacobi_tan(float zeta) {
  if (fabsf(zeta) > 1e15f) return 0.5f / zeta;
  return copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
}

// Column j of the m x m matrix U (contiguous), given orthonormal columns
// 0..j-1: the cross product of the first two when m == 3 and j == 2, else
// Gram-Schmidt (twice) on the unit vector that the earlier columns
// represent least.
SL_FN void complete_column(float* U, int m, int j) {
  if (m == 3 && j == 2) {
    U[2] = U[3] * U[7] - U[6] * U[4];
    U[5] = U[6] * U[1] - U[0] * U[7];
    U[8] = U[0] * U[4] - U[3] * U[1];
    return;
  }
  int best = 0;
  float best_res = -1.f;
  for (int r = 0; r < m; ++r) {
    float proj = 0.f;
    for (int l = 0; l < j; ++l) proj += U[r * m + l] * U[r * m + l];
    if (1.f - proj > best_res) {
      best_res = 1.f - proj;
      best = r;
    }
  }
  for (int i = 0; i < m; ++i) U[i * m + j] = (i == best) ? 1.f : 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int l = 0; l < j; ++l) {
      float d = 0.f;
      for (int i = 0; i < m; ++i) d += U[i * m + l] * U[i * m + j];
      for (int i = 0; i < m; ++i) U[i * m + j] -= d * U[i * m + l];
    }
  }
  float nrm = 0.f;
  for (int i = 0; i < m; ++i) nrm += U[i * m + j] * U[i * m + j];
  nrm = 1.f / sqrtf(nrm);
  for (int i = 0; i < m; ++i) U[i * m + j] *= nrm;
}

// Reduces the m x n matrix A (row-major, contiguous), m > n, scaled by
// `scale`, to the n x n upper-triangular R of A = QR in W (stride s): the
// rows stream through Givens rotations, so only R is held. R has A's
// singular values and right singular vectors.
SL_FN void givens_qr(const float* A, float scale, float* W, int s, int m,
                     int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) at(W, n, i, j, s) = 0.f;
  }
  float row[kMaxN];
  for (int r = 0; r < m; ++r) {
    for (int j = 0; j < n; ++j) row[j] = A[r * n + j] * scale;
    for (int j = 0; j < n; ++j) {
      const float a = at(W, n, j, j, s), b = row[j];
      if (b == 0.f) continue;
      const float h = sqrtf(a * a + b * b);
      const float c = a / h, sn = b / h;
      for (int l = j; l < n; ++l) {
        const float x = at(W, n, j, l, s), y = row[l];
        at(W, n, j, l, s) = c * x + sn * y;
        row[l] = c * y - sn * x;
      }
    }
  }
}

// SVD of the m x n matrix A (row-major, contiguous), n <= kMaxN, m <=
// kMaxM, or any m when U is not asked for: A = U diag(S) Vh.
//
// One-sided Jacobi on A itself, never on A^T A (the Hartley-normalised
// 8-point system would lose its null vector if its condition number were
// squared): W = A V is rotated pair of columns by pair of columns until
// its columns are orthogonal; then S_j = |w_j|, u_j = w_j / S_j, and V is
// the product of the rotations, complete and orthogonal. A wide matrix
// (m < n, the 8x9 DLT systems) is the square one padded with zero rows,
// which add nothing to the dot products, so V's last n - m columns span
// the null space, as full_matrices=True gives.
//
// A matrix taller than kMaxM is first reduced to its n x n triangular
// factor (givens_qr), and the Jacobi runs on that.
//
// W (m x n, or n x n when m > kMaxM) and V (n x n) are work storage with
// stride s. Outputs: S[k], k = min(m, n), descending; Vh
// (n x n, V transposed) and U (m x m) unless null. A column of U whose singular value is numerically zero (at most
// FLT_EPSILON times |A|_F: E, F after its projection, a degenerate Kabsch
// H), and each column past n when m > n, is completed to an orthonormal
// basis (complete_column). Each u_j is paired with its v_j.
SL_FN int svd(const float* A, float* W, float* V, int s, int m, int n,
              float* S, float* U, float* Vh) {
  const int k = m < n ? m : n;
  float amax = 0.f;
  bool ok = true;
  for (int i = 0; i < m * n; ++i) {
    ok = ok && finite(A[i]);
    amax = fmaxf(amax, fabsf(A[i]));
  }
  if (!ok) {
    const float nan = quiet_nan();
    for (int j = 0; j < k; ++j) S[j] = nan;
    if (Vh) for (int i = 0; i < n * n; ++i) Vh[i] = nan;
    if (U) for (int i = 0; i < m * m; ++i) U[i] = nan;
    return 0;
  }
  int e;
  const float scale = pow2_scale(amax, &e);
  const int m_full = m;
  if (m > kMaxM) {
    givens_qr(A, scale, W, s, m, n);
    m = n;
  } else {
    for (int i = 0; i < m; ++i) {
      for (int j = 0; j < n; ++j) at(W, n, i, j, s) = A[i * n + j] * scale;
    }
  }
  float fro2 = 0.f;
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) fro2 += at(W, n, i, j, s) * at(W, n, i, j, s);
  }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) at(V, n, i, j, s) = (i == j) ? 1.f : 0.f;
  }
  // a column this short is numerically zero: it is left alone, and its
  // u_j is completed instead of normalised
  const float zero = FLT_EPSILON * sqrtf(fro2);
  const float zero2 = zero * zero;
  const float tol = FLT_EPSILON * sqrtf(static_cast<float>(m));
  int sweep = 0;
  while (sweep < kMaxSweeps) {
    ++sweep;
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        float a = 0.f, b = 0.f, g = 0.f;
        for (int i = 0; i < m; ++i) {
          const float wp = at(W, n, i, p, s), wq = at(W, n, i, q, s);
          a += wp * wp;
          b += wq * wq;
          g += wp * wq;
        }
        if (a <= zero2 || b <= zero2 || fabsf(g) <= tol * sqrtf(a) * sqrtf(b)) {
          continue;
        }
        rotated = true;
        const float t = jacobi_tan((b - a) / (2.f * g));
        const float c = 1.f / sqrtf(1.f + t * t);
        const float sn = c * t;
        for (int i = 0; i < m; ++i) {
          const float wp = at(W, n, i, p, s), wq = at(W, n, i, q, s);
          at(W, n, i, p, s) = c * wp - sn * wq;
          at(W, n, i, q, s) = sn * wp + c * wq;
        }
        for (int i = 0; i < n; ++i) {
          const float vp = at(V, n, i, p, s), vq = at(V, n, i, q, s);
          at(V, n, i, p, s) = c * vp - sn * vq;
          at(V, n, i, q, s) = sn * vp + c * vq;
        }
      }
    }
    if (!rotated) break;
  }
  // column norms, then a selection sort into descending order
  float sig[kMaxN];
  for (int j = 0; j < n; ++j) {
    float a = 0.f;
    for (int i = 0; i < m; ++i) a += at(W, n, i, j, s) * at(W, n, i, j, s);
    sig[j] = sqrtf(a);
  }
  for (int j = 0; j < n - 1; ++j) {
    int best = j;
    for (int l = j + 1; l < n; ++l) best = (sig[l] > sig[best]) ? l : best;
    if (best == j) continue;
    const float tmp = sig[j];
    sig[j] = sig[best];
    sig[best] = tmp;
    for (int i = 0; i < m; ++i) {
      const float w = at(W, n, i, j, s);
      at(W, n, i, j, s) = at(W, n, i, best, s);
      at(W, n, i, best, s) = w;
    }
    for (int i = 0; i < n; ++i) {
      const float v = at(V, n, i, j, s);
      at(V, n, i, j, s) = at(V, n, i, best, s);
      at(V, n, i, best, s) = v;
    }
  }
  const float unscale = ldexpf(1.f, e);
  for (int j = 0; j < k; ++j) S[j] = sig[j] * unscale;
  if (Vh) {
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) Vh[j * n + i] = at(V, n, i, j, s);
    }
  }
  if (U && m == m_full) {
    for (int j = 0; j < m; ++j) {
      if (j < n && sig[j] > zero) {
        const float inv = 1.f / sig[j];
        for (int i = 0; i < m; ++i) U[i * m + j] = at(W, n, i, j, s) * inv;
      } else {
        complete_column(U, m, j);
      }
    }
  }
  return sweep;
}

// Eigen-decomposition of the symmetric n x n matrix A (row-major,
// contiguous; its lower triangle is read, as torch.linalg.eigh reads it),
// n <= kMaxN: A = V diag(w) V^T, w ascending, the eigenvectors in V's
// columns. Cyclic two-sided Jacobi (Rutishauser's rotation): an indefinite
// matrix such as Horn's N is decomposed as it is, so the SVD is no
// substitute. A pair is rotated while |a_pq| exceeds FLT_EPSILON / 2 times
// |A|_F. M and V (n x n) are work storage with stride s; w[n] and Vout
// (n x n) the outputs.
SL_FN int eigh(const float* A, float* M, float* V, int s, int n, float* w,
               float* Vout) {
  float amax = 0.f;
  bool ok = true;
  for (int i = 0; i < n * n; ++i) {
    ok = ok && finite(A[i]);
    amax = fmaxf(amax, fabsf(A[i]));
  }
  if (!ok) {
    const float nan = quiet_nan();
    for (int j = 0; j < n; ++j) w[j] = nan;
    for (int i = 0; i < n * n; ++i) Vout[i] = nan;
    return 0;
  }
  int e;
  const float scale = pow2_scale(amax, &e);
  float fro2 = 0.f;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      const float a = A[i * n + j] * scale;
      at(M, n, i, j, s) = a;
      at(M, n, j, i, s) = a;
      fro2 += (i == j) ? a * a : 2.f * a * a;
    }
  }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) at(V, n, i, j, s) = (i == j) ? 1.f : 0.f;
  }
  const float tol = 0.5f * FLT_EPSILON * sqrtf(fro2);
  int sweep = 0;
  while (sweep < kMaxSweeps) {
    ++sweep;
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const float apq = at(M, n, p, q, s);
        if (fabsf(apq) <= tol) continue;
        rotated = true;
        const float app = at(M, n, p, p, s), aqq = at(M, n, q, q, s);
        const float t = jacobi_tan((aqq - app) / (2.f * apq));
        const float c = 1.f / sqrtf(1.f + t * t);
        const float sn = c * t;
        const float tau = sn / (1.f + c);
        at(M, n, p, p, s) = app - t * apq;
        at(M, n, q, q, s) = aqq + t * apq;
        at(M, n, p, q, s) = 0.f;
        at(M, n, q, p, s) = 0.f;
        for (int r = 0; r < n; ++r) {
          if (r == p || r == q) continue;
          const float g = at(M, n, r, p, s), h = at(M, n, r, q, s);
          const float gp = g - sn * (h + g * tau);
          const float hq = h + sn * (g - h * tau);
          at(M, n, r, p, s) = gp;
          at(M, n, p, r, s) = gp;
          at(M, n, r, q, s) = hq;
          at(M, n, q, r, s) = hq;
        }
        for (int r = 0; r < n; ++r) {
          const float g = at(V, n, r, p, s), h = at(V, n, r, q, s);
          at(V, n, r, p, s) = g - sn * (h + g * tau);
          at(V, n, r, q, s) = h + sn * (g - h * tau);
        }
      }
    }
    if (!rotated) break;
  }
  // eigenvalues from the diagonal, sorted ascending with their columns
  float d[kMaxN];
  for (int j = 0; j < n; ++j) d[j] = at(M, n, j, j, s);
  for (int j = 0; j < n - 1; ++j) {
    int best = j;
    for (int l = j + 1; l < n; ++l) best = (d[l] < d[best]) ? l : best;
    if (best == j) continue;
    const float tmp = d[j];
    d[j] = d[best];
    d[best] = tmp;
    for (int i = 0; i < n; ++i) {
      const float v = at(V, n, i, j, s);
      at(V, n, i, j, s) = at(V, n, i, best, s);
      at(V, n, i, best, s) = v;
    }
  }
  const float unscale = ldexpf(1.f, e);
  for (int j = 0; j < n; ++j) w[j] = d[j] * unscale;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) Vout[i * n + j] = at(V, n, i, j, s);
  }
  return sweep;
}

}  // namespace small_linalg
