// Per-matrix Jacobi routines for small dense f32 matrices, written for a
// lane group: a one-sided (Hestenes) Jacobi SVD and a cyclic two-sided
// Jacobi eigensolver for symmetric matrices. The device kernels of
// csrc/small_linalg.cu run them with a group of 4, 8, 16 or 32 lanes of a
// warp per matrix; the host build of csrc/small_linalg_host.cpp runs the same
// code with a group that holds every lane's value in an array, so the
// tests hold the kernels' own algorithm and summation order against the
// JAX package where there is no card (the host contracts no multiply-add
// into an FMA, so its rounding is not the card's bit for bit).
//
// The SVD keeps its matrices in registers: lane i holds row i of W (and,
// for a matrix taller than 16 rows, row i + 32 as well) and row i of V. A column operation is lane-local; a dot product over the rows is one
// butterfly over the group, after which every lane holds the same sum.
// The eigensolver
// keeps M and V in a small per-group tile, lane i at row i, and takes its
// pairs one at a time in the cyclic order.
//
// Several groups (of 4, 8 or 16 lanes) can share a warp. Their sweep
// loops, and the eigensolver's skip of a pair, are decided over the whole
// warp (any_warp), so its groups run the same instructions at one time:
// a group that has converged runs the others' extra sweeps as exact no-ops
// (a rotation by c = 1, s = 0, or none), and no group leaves the loop
// before the others.
//
// The group type `Grp` gives, for its G = Grp::kSize lanes:
//   F, I, B          a float, int and bool per lane (scalars on a device
//                    lane; arithmetic and comparisons as on scalars);
//   lane()           the lane's index, 0..G-1, as an I;
//   sel(b, x, y)     x where b, y elsewhere;
//   finite, abs, sqrt, sign (copysign(1, x)), fmax on F;
//   pow2_inv(x)      2^-k with 2^(k-1) <= x < 2^k (1 below FLT_MIN), on F;
//   sum(out, x)      out[k] = the sum of x[k] over the lanes (butterfly);
//   sum(x), max(x)   one value's sum / max over the lanes;
//   all(b), any(b)   whether b holds on every / some lane;
//   any_warp(b)      whether a uniform b holds for some group of the warp;
//   bcast(x, src)    lane src's x;
//   argmax(x)        the lowest lane holding the largest x;
//   load(p, off, ok) p[off] where ok, else 0;  store(p, off, ok, x);
//   store1(p, off, x) one lane writes the (uniform) x;  sync().
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
#define SL_FN __device__ __forceinline__
#define SL_UNROLL _Pragma("unroll")
#define SL_LOOP _Pragma("unroll 1")
#else
#define SL_FN inline
#define SL_UNROLL
#define SL_LOOP
#endif

namespace small_linalg {

constexpr int kMaxM = 16;        // rows for which the SVD gives U
constexpr int kMaxN = 12;        // columns
constexpr int kMaxTallM = 64;    // rows without U: 32 lanes of 2 rows
constexpr int kMaxSweeps = 30;
constexpr int kTileStride = kMaxM + 1;   // a row of U's work tile
constexpr int kEighStride = kMaxN + 1;   // a row of eigh's work tiles

// The group width (lanes a matrix) of the SVD of an m x n matrix: up to
// kMaxM rows, the least of 4, 8 and 16 lanes that holds a row of W and of
// V a lane (one row a lane); up to kMaxTallM rows, 32 lanes of 2 rows; 0
// above.
inline int svd_group(int m, int n) {
  const int lanes = m > n ? m : n;
  if (lanes <= kMaxM) return lanes <= 4 ? 4 : lanes <= 8 ? 8 : 16;
  return m <= kMaxTallM ? 32 : 0;
}

// The group width of the eigensolver on n x n matrices: a row a lane.
inline int eigh_group(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : 16; }

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

// The Jacobi rotation (c, s) that makes a pair orthogonal (the SVD) or
// zeroes a_pq (eigh): with e = b - a (|w_q|^2 - |w_p|^2, or a_qq - a_pp)
// and f = 2d (2 <w_p, w_q>, or 2 a_pq), the angle's tangent of least
// magnitude is t = sign(e) f / u, u = |e| + sqrt(e^2 + f^2), and
// c = u / r, s = sign(e) f / r, r = sqrt(u^2 + f^2) (sign(+0) = +1): the
// root of t^2 + 2 zeta t - 1 = 0, zeta = e / f, in two square roots and a
// division deep rather than three divisions and two roots.

// The SVD's, on each lane's (e, f), scaled first by a power of two
// (exact) so that the larger lies in [0.5, 1): a short pair of columns has
// a tiny f, whose square would lose its digits. A lane that does not
// rotate gets c = 1, s = 0.
template <class Grp>
SL_FN void svd_rotation(const Grp& g, const typename Grp::F& e0,
                        const typename Grp::F& f0,
                        const typename Grp::B& rotate, typename Grp::F& c,
                        typename Grp::F& s) {
  using F = typename Grp::F;
  const F k = g.pow2_inv(g.fmax(g.abs(e0), g.abs(f0)));
  const F e = e0 * k, f = f0 * k;
  const F u = g.abs(e) + g.sqrt(e * e + f * f);
  const F r = g.sel(rotate, g.sqrt(u * u + f * f), F(1.f));
  c = g.sel(rotate, u / r, F(1.f));
  s = g.sel(rotate, g.sign(e) * f / r, F(0.f));
}

// The eigensolver's, for Rutishauser's update: t, s and tau = s / (1 + c)
// = sign(e) f / (r + u). |a_pq| > tol keeps f^2 far from underflow; a
// pair that does not rotate gets t = s = tau = 0.
SL_FN void eigh_rotation(float e, float f0, bool rotate, float& t, float& s,
                         float& tau) {
  const float f = rotate ? f0 : 1.f;
  const float u = fabsf(e) + sqrtf(e * e + f * f);
  const float r = sqrtf(u * u + f * f);
  const float sf = copysignf(1.f, e) * f;
  t = rotate ? sf / u : 0.f;
  s = rotate ? sf / r : 0.f;
  tau = rotate ? sf / (r + u) : 0.f;
}

// The position of vals[j] among vals[0..n) sorted descending (or
// ascending), ties in index order.
SL_FN int rank_of(const float (&vals)[kMaxN], int n, int j, bool descending) {
  int rank = 0;
  SL_UNROLL
  for (int l = 0; l < kMaxN; ++l) {
    if (l >= n || l == j) continue;
    const bool before = descending ? vals[l] > vals[j] : vals[l] < vals[j];
    rank += before || (vals[l] == vals[j] && l < j);
  }
  return rank;
}

// Writes NaN to p[0..count) with the group's lanes.
template <class Grp>
SL_FN void fill_nan(const Grp& g, float* p, int count) {
  const typename Grp::I lane = g.lane();
  for (int base = 0; base < count; base += Grp::kSize) {
    g.store(p, base + lane, base + lane < count,
            typename Grp::F(quiet_nan()));
  }
}

// One round of the SVD's sweep: the K column pairs (ps[i], qs[i]), which
// are disjoint, of W (ROWS rows a lane) and V. The 3K dot products come
// from one butterfly; lane i works out pair i's rotation and the group
// takes each pair's (c, s) from its lane, so the K angles cost one angle's
// time. A pair rotates while |<w_p, w_q>| > tol |w_p| |w_q|, unless either
// column is shorter than sqrt(zero2); one that does not is given c = 1,
// s = 0, which leaves it exactly as it is, so the round has no branch.
// `rotated` collects, lane by lane, whether the lane's pair rotated.
template <int K, class Grp, int ROWS>
SL_FN void rotate_round(const Grp& g, typename Grp::F (&w)[ROWS][kMaxN],
                        typename Grp::F (&v)[kMaxN], const int (&ps)[K],
                        const int (&qs)[K], float zero2, float tol,
                        typename Grp::B& rotated) {
  using F = typename Grp::F;
  F part[3 * K];
  SL_UNROLL
  for (int i = 0; i < K; ++i) {
    F a = 0.f, b = 0.f, d = 0.f;
    SL_UNROLL
    for (int r = 0; r < ROWS; ++r) {
      const F wp = w[r][ps[i]], wq = w[r][qs[i]];
      a = a + wp * wp;
      b = b + wq * wq;
      d = d + wp * wq;
    }
    part[3 * i] = a;
    part[3 * i + 1] = b;
    part[3 * i + 2] = d;
  }
  float s[3 * K];
  g.sum(s, part);
  const typename Grp::I lane = g.lane();
  F a = 0.f, b = 0.f, d = 0.f;
  SL_UNROLL
  for (int i = 0; i < K; ++i) {
    const auto mine = lane == i;
    a = g.sel(mine, F(s[3 * i]), a);
    b = g.sel(mine, F(s[3 * i + 1]), b);
    d = g.sel(mine, F(s[3 * i + 2]), d);
  }
  const auto rotate = a > zero2 && b > zero2 &&
                      g.abs(d) > tol * g.sqrt(a) * g.sqrt(b);
  rotated = rotated || rotate;
  F c_lane, sn_lane;
  svd_rotation(g, b - a, 2.f * d, rotate, c_lane, sn_lane);
  float cs[K], sns[K];
  SL_UNROLL
  for (int i = 0; i < K; ++i) {
    cs[i] = g.bcast(c_lane, i);
    sns[i] = g.bcast(sn_lane, i);
  }
  SL_UNROLL
  for (int i = 0; i < K; ++i) {
    const float c = cs[i], sn = sns[i];
    const int p = ps[i], q = qs[i];
    SL_UNROLL
    for (int r = 0; r < ROWS; ++r) {
      const F wp = w[r][p], wq = w[r][q];
      w[r][p] = c * wp - sn * wq;
      w[r][q] = sn * wp + c * wq;
    }
    const F vp = v[p], vq = v[q];
    v[p] = c * vp - sn * vq;
    v[q] = sn * vp + c * vq;
  }
}

// One sweep of the SVD in a round-robin (circle) order on n columns
// padded to an even NP, with the pairs at fixed places. Round by round the
// columns of W and V sit in NP slots and pair up as slots (i, NP - 1 - i);
// after each round slot 0 stays and slots 1..NP-1 move one place on (slot
// 1 takes slot NP - 1's column), so in NP - 1 rounds every pair of
// columns meets once and the slots are back in order. A pad column is
// zero and never rotates. The rounds are a loop, not unrolled: its body,
// NP / 2 rotations with their butterfly, is the kernel's whole sweep, and
// the code stays small (a fully unrolled sweep ran slower). Returns
// whether a pair of the group rotated.
template <int NP, class Grp, int ROWS>
SL_FN bool svd_sweep_np(const Grp& g, typename Grp::F (&w)[ROWS][kMaxN],
                        typename Grp::F (&v)[kMaxN], float zero2, float tol) {
  using F = typename Grp::F;
  constexpr int K = NP / 2;
  int ps[K], qs[K];
  SL_UNROLL
  for (int i = 0; i < K; ++i) {
    ps[i] = i;
    qs[i] = NP - 1 - i;
  }
  typename Grp::B rotated = false;
  SL_LOOP
  for (int round = 0; round < NP - 1; ++round) {
    rotate_round<K>(g, w, v, ps, qs, zero2, tol, rotated);
    SL_UNROLL
    for (int r = 0; r < ROWS; ++r) {
      const F last = w[r][NP - 1];
      SL_UNROLL
      for (int j = NP - 1; j > 1; --j) w[r][j] = w[r][j - 1];
      w[r][1] = last;
    }
    const F last = v[NP - 1];
    SL_UNROLL
    for (int j = NP - 1; j > 1; --j) v[j] = v[j - 1];
    v[1] = last;
  }
  return g.any(rotated);
}

template <class Grp, int ROWS>
SL_FN bool svd_sweep(const Grp& g, typename Grp::F (&w)[ROWS][kMaxN],
                     typename Grp::F (&v)[kMaxN], int n, float zero2,
                     float tol) {
  // n <= G, so a group of G lanes needs at most G slots (a lane a pair)
  constexpr int C = Grp::kSize < kMaxN ? Grp::kSize : kMaxN;
  switch ((n + 1) / 2) {
    case 1: return svd_sweep_np<2>(g, w, v, zero2, tol);
    case 2: return svd_sweep_np<4>(g, w, v, zero2, tol);
    case 3: return svd_sweep_np<(6 < C ? 6 : C)>(g, w, v, zero2, tol);
    case 4: return svd_sweep_np<(8 < C ? 8 : C)>(g, w, v, zero2, tol);
    case 5: return svd_sweep_np<(10 < C ? 10 : C)>(g, w, v, zero2, tol);
    default: return svd_sweep_np<C>(g, w, v, zero2, tol);
  }
}

// Column j of the m x m matrix U held in the group's tile T (row i of U at
// T + i * kTileStride), given orthonormal columns 0..j-1: the cross
// product of the first two when m == 3 and j == 2, else Gram-Schmidt
// (twice) on the unit vector that the earlier columns represent least.
template <class Grp>
SL_FN void complete_column(const Grp& g, float* T, int m, int j) {
  using F = typename Grp::F;
  using I = typename Grp::I;
  const I lane = g.lane();
  const auto in = lane < m;
  const I row = lane * kTileStride;
  F x;
  if (m == 3 && j == 2) {
    const I a = ((lane + 1) % 3) * kTileStride;
    const I b = ((lane + 2) % 3) * kTileStride;
    x = g.load(T, a, in) * g.load(T, b + 1, in) -
        g.load(T, b, in) * g.load(T, a + 1, in);
  } else {
    F proj = 0.f;
    for (int l = 0; l < j; ++l) {
      const F t = g.load(T, row + l, in);
      proj = proj + t * t;
    }
    const int best = g.argmax(g.sel(in, 1.f - proj, F(-INFINITY)));
    x = g.sel(lane == best, F(1.f), F(0.f));
    for (int pass = 0; pass < 2; ++pass) {
      for (int l = 0; l < j; ++l) {
        const F t = g.load(T, row + l, in);
        const float d = g.sum(t * x);
        x = x - d * t;
      }
    }
    const float nrm = 1.f / sqrtf(g.sum(x * x));
    x = x * nrm;
  }
  g.store(T, row + j, in, x);
  g.sync();
}

// SVD of the m x n matrix A (row-major, contiguous), n <= kMaxN, with the
// group's ROWS rows a lane (m <= ROWS * G): A = U diag(S) Vh.
//
// One-sided Jacobi on A itself, never on A^T A (the Hartley-normalised
// 8-point system would lose its null vector if its condition number were
// squared): W = A V is rotated pair of columns by pair of columns, in the
// round-robin order (svd_sweep), until its columns are orthogonal; then S_j = |w_j|,
// u_j = w_j / S_j, and V is the product of the rotations, complete and
// orthogonal. A wide matrix (m < n, the 8x9 DLT systems) is the square one
// padded with zero rows, which add nothing to the dot products, so V's
// last n - m columns span the null space, as full_matrices=True gives. A
// tall matrix is rotated as it is, its rows spread over the lanes.
//
// A pair rotates while |<w_p, w_q>| > sqrt(m) FLT_EPSILON |w_p| |w_q|; a
// column shorter than FLT_EPSILON |A|_F is numerically zero and is left
// alone. Outputs: S[k], k = min(m, n), descending; Vh (n x n, V
// transposed); U (m x m, m <= kMaxM) unless null, built in the group's
// tile (kMaxM * kTileStride floats). A column of U whose singular value is
// numerically zero (E, F after its projection, a degenerate Kabsch H),
// and each column past n when m > n, is completed to an orthonormal basis
// (complete_column). Each u_j is paired with its v_j.
template <class Grp, int ROWS>
SL_FN int svd(const Grp& g, const float* A, int m, int n, float* S, float* U,
              float* Vh, float* tile) {
  using F = typename Grp::F;
  using I = typename Grp::I;
  using B = typename Grp::B;
  constexpr int G = Grp::kSize;
  const int k = m < n ? m : n;
  const I lane = g.lane();
  F w[ROWS][kMaxN];
  B ok = true;
  F amax = 0.f;
  SL_UNROLL
  for (int r = 0; r < ROWS; ++r) {
    const I row = lane + G * r;
    const B in = row < m;
    SL_UNROLL
    for (int j = 0; j < kMaxN; ++j) {
      w[r][j] = j < n ? g.load(A, row * n + j, in) : F(0.f);
      ok = ok && g.finite(w[r][j]);
      amax = g.fmax(amax, g.abs(w[r][j]));
    }
  }
  // a matrix with a non-finite entry gives NaN, and goes through its
  // warp's sweeps as a zero matrix, which never rotates
  const bool bad = !g.all(ok);
  if (bad) {
    fill_nan(g, S, k);
    fill_nan(g, Vh, n * n);
    if (U) fill_nan(g, U, m * m);
  }
  int e = 0;
  const float amax_all = g.max(amax);
  const float scale = bad ? 0.f : pow2_scale(amax_all, &e);
  F fro = 0.f;
  SL_UNROLL
  for (int r = 0; r < ROWS; ++r) {
    SL_UNROLL
    for (int j = 0; j < kMaxN; ++j) {
      w[r][j] = g.sel(g.finite(w[r][j]), w[r][j], F(0.f)) * scale;
      fro = fro + w[r][j] * w[r][j];
    }
  }
  const float fro2 = g.sum(fro);
  F v[kMaxN];
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) {
    v[j] = j < n ? g.sel(lane == j, F(1.f), F(0.f)) : F(0.f);
  }
  const float zero = FLT_EPSILON * sqrtf(fro2);
  const float tol = FLT_EPSILON * sqrtf(static_cast<float>(m));
  // sweeps until one rotates nothing, at most kMaxSweeps
  int sweeps = 0;
  bool going = !bad;
  for (int it = 0; it < kMaxSweeps && g.any_warp(going); ++it) {
    const bool rotated = svd_sweep(g, w, v, n, zero * zero, tol);
    sweeps += going;
    going = going && rotated;
  }
  if (bad) return 0;
  // column norms, and each column's place in descending order
  F part[kMaxN];
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) {
    part[j] = 0.f;
    SL_UNROLL
    for (int r = 0; r < ROWS; ++r) part[j] = part[j] + w[r][j] * w[r][j];
  }
  float sig[kMaxN];
  g.sum(sig, part);
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) sig[j] = sqrtf(sig[j]);
  const float unscale = ldexpf(1.f, e);
  int normalised = 0;
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) {
    if (j >= n) continue;
    const int rank = rank_of(sig, n, j, true);
    if (rank < k) g.store1(S, rank, sig[j] * unscale);
    g.store(Vh, rank * n + lane, lane < n, v[j]);
    if (U && rank < m && sig[j] > zero) {
      const float inv = 1.f / sig[j];
      g.store(tile, lane * kTileStride + rank, lane < m, w[0][j] * inv);
      ++normalised;
    }
  }
  if (U) {
    // the normalised columns come first (S descending); complete the rest
    g.sync();
    for (int j = normalised; j < m; ++j) complete_column(g, tile, m, j);
    for (int j = 0; j < m; ++j) {
      g.store(U, lane * m + j, lane < m,
              g.load(tile, lane * kTileStride + j, lane < m));
    }
  }
  return sweeps;
}

// Rutishauser's update of the pair (g, h) of a row or column: (c g - s h,
// s g + c h) with c = 1 - s tau
template <class F>
SL_FN F rot_lo(const F& g, const F& h, float sn, float tau) {
  return g - sn * (h + g * tau);
}

template <class F>
SL_FN F rot_hi(const F& g, const F& h, float sn, float tau) {
  return h + sn * (g - h * tau);
}

// The eigensolver's sweep in the cyclic order, (0,1), (0,2), ...,
// (n-2, n-1), one pair at a time: a rotation (p, q) reads a_pp, a_qq and
// a_pq from the tile; every lane r other than p and q updates M's entries
// (r, p), (r, q) and their mirrors (p, r), (q, r), every lane its row of
// V, and one lane the 2x2 block. These are the serial routine's operations
// on the same values, so M stays exactly symmetric and no row moves
// between lanes; the pair loop runs over the tile's indices, not unrolled,
// which keeps the code small. A pair that no group of the warp rotates is
// skipped; one that this group does not rotate (`going` false once it has
// converged) takes t = 0, which changes nothing. Returns whether a pair of
// this group rotated.
template <class Grp>
SL_FN bool eigh_sweep(const Grp& g, float* M, float* V, int n, float tol,
                      bool going) {
  using F = typename Grp::F;
  using I = typename Grp::I;
  using B = typename Grp::B;
  constexpr int S = kEighStride;
  const I lane = g.lane();
  const B in = lane < n;
  bool rotated = false;
  SL_LOOP
  for (int p = 0; p < n - 1; ++p) {
    SL_LOOP
    for (int q = p + 1; q < n; ++q) {
      const float apq = M[p * S + q], app = M[p * S + p];
      const float aqq = M[q * S + q];
      const bool rotate = going && fabsf(apq) > tol;
      if (!g.any_warp(rotate)) continue;
      rotated = rotated || rotate;
      float t, sn, tau;
      eigh_rotation(aqq - app, 2.f * apq, rotate, t, sn, tau);
      const B other = in && lane != p && lane != q;
      const F gr = g.load(M, lane * S + p, other);
      const F hr = g.load(M, lane * S + q, other);
      const F vg = g.load(V, lane * S + p, in);
      const F vh = g.load(V, lane * S + q, in);
      const F gp = rot_lo(gr, hr, sn, tau), hq = rot_hi(gr, hr, sn, tau);
      g.store(M, lane * S + p, other, gp);
      g.store(M, p * S + lane, other, gp);
      g.store(M, lane * S + q, other, hq);
      g.store(M, q * S + lane, other, hq);
      g.store(V, lane * S + p, in, rot_lo(vg, vh, sn, tau));
      g.store(V, lane * S + q, in, rot_hi(vg, vh, sn, tau));
      g.store1(M, p * S + p, app - t * apq);
      g.store1(M, q * S + q, aqq + t * apq);
      g.store1(M, p * S + q, rotate ? 0.f : apq);
      g.store1(M, q * S + p, rotate ? 0.f : apq);
      g.sync();
    }
  }
  return rotated;
}

// Eigen-decomposition of the symmetric n x n matrix A (row-major,
// contiguous; its lower triangle is read, as torch.linalg.eigh reads it),
// n <= kMaxN: A = V diag(w) V^T, w ascending, the eigenvectors in V's
// columns. Two-sided Jacobi (Rutishauser's rotation), its pairs in the
// cyclic order (eigh_sweep): an indefinite matrix such as Horn's N is
// decomposed as it is, so the SVD is no substitute. A pair is rotated
// while |a_pq| exceeds FLT_EPSILON / 2 times |A|_F.
//
// M and V live in the group's tile T (2 * n * kEighStride floats: M's row
// i at T + i * kEighStride, V's after M's n rows), lane i holding row i.
// Outputs w[n] and Vout (n x n).
template <class Grp>
SL_FN int eigh(const Grp& g, const float* A, int n, float* w, float* Vout,
               float* T) {
  using F = typename Grp::F;
  using I = typename Grp::I;
  using B = typename Grp::B;
  constexpr int S = kEighStride;
  float* M = T;
  float* V = T + n * S;
  const I lane = g.lane();
  const B in = lane < n;
  B ok = true;
  F amax = 0.f;
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) {
    if (j >= n) continue;
    const F x = g.load(A, lane * n + j, in);
    ok = ok && g.finite(x);
    amax = g.fmax(amax, g.abs(x));
  }
  // a matrix with a non-finite entry gives NaN, and goes through the
  // warp's sweeps as a zero matrix, which never rotates
  const bool bad = !g.all(ok);
  if (bad) {
    fill_nan(g, w, n);
    fill_nan(g, Vout, n * n);
  }
  int e = 0;
  const float amax_all = g.max(amax);
  const float scale = bad ? 0.f : pow2_scale(amax_all, &e);
  F fro = 0.f;
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) {
    if (j >= n) continue;
    const B lower = lane >= j;
    F a = g.load(A, g.sel(lower, lane * n + j, j * n + lane), in);
    a = g.sel(g.finite(a), a, F(0.f)) * scale;
    fro = fro + g.sel(lower, g.sel(lane == j, a * a, 2.f * a * a), F(0.f));
    g.store(M, lane * S + j, in, a);
    g.store(V, lane * S + j, in, g.sel(lane == j, F(1.f), F(0.f)));
  }
  const float tol = 0.5f * FLT_EPSILON * sqrtf(g.sum(fro));
  g.sync();
  // sweeps until one rotates nothing, at most kMaxSweeps
  int sweeps = 0;
  bool going = !bad;
  for (int it = 0; it < kMaxSweeps && g.any_warp(going); ++it) {
    const bool rotated = eigh_sweep(g, M, V, n, tol, going);
    sweeps += going;
    going = going && rotated;
  }
  if (bad) return 0;
  // eigenvalues from the diagonal, each with its column in ascending order
  float d[kMaxN];
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) d[j] = j < n ? M[j * S + j] : 0.f;
  const float unscale = ldexpf(1.f, e);
  SL_UNROLL
  for (int j = 0; j < kMaxN; ++j) {
    if (j >= n) continue;
    const int rank = rank_of(d, n, j, false);
    g.store1(w, rank, d[j] * unscale);
    g.store(Vout, lane * n + rank, in, g.load(V, lane * S + j, in));
  }
  return sweeps;
}

}  // namespace small_linalg
