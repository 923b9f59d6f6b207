// Host build of the lane-group Jacobi routines of small_linalg.cuh, the
// code the kernels of small_linalg.cu run: each group operation runs on
// every lane's value in turn, and every sum over the lanes takes the
// kernels' butterfly order, so the host runs the kernels' algorithm in
// their summation order, one matrix after another. It contracts no
// multiply-add into an FMA, where the card's compiler does, so the two
// round differently in the last bits. Built with the host C++ compiler; used by the
// tests, which hold it against the JAX package's svd / eigh where there is
// no card. The entry points take the kernels' arguments without the
// stream, plus `sweeps` ((batch,) int32, may be null), which receives each
// matrix's sweep count for the tests' convergence check; they return 0, or
// 1 for a size the routines do not take.
#include <string.h>

#include "small_linalg.cuh"

namespace {

// one value of type T on each of G lanes
template <class T, int G>
struct Lv {
  T v[G];

  Lv() = default;
  Lv(T s) {  // NOLINT: a scalar is the same value on every lane
    for (int l = 0; l < G; ++l) v[l] = s;
  }

#define SL_LANEWISE(op, R)                                  \
  friend Lv<R, G> operator op(const Lv& a, const Lv& b) {   \
    Lv<R, G> r;                                              \
    for (int l = 0; l < G; ++l) r.v[l] = a.v[l] op b.v[l];   \
    return r;                                                \
  }
  SL_LANEWISE(+, T)
  SL_LANEWISE(-, T)
  SL_LANEWISE(*, T)
  SL_LANEWISE(/, T)
  SL_LANEWISE(%, T)
  SL_LANEWISE(<, bool)
  SL_LANEWISE(>, bool)
  SL_LANEWISE(>=, bool)
  SL_LANEWISE(==, bool)
  SL_LANEWISE(!=, bool)
  SL_LANEWISE(&&, bool)
  SL_LANEWISE(||, bool)
#undef SL_LANEWISE
};

template <int G>
struct HostLanes {
  static constexpr int kSize = G;
  using F = Lv<float, G>;
  using I = Lv<int, G>;
  using B = Lv<bool, G>;

  I lane() const {
    I r;
    for (int l = 0; l < G; ++l) r.v[l] = l;
    return r;
  }
  template <class X>
  X sel(const B& b, const X& x, const X& y) const {
    X r;
    for (int l = 0; l < G; ++l) r.v[l] = b.v[l] ? x.v[l] : y.v[l];
    return r;
  }
  B finite(const F& x) const {
    B r;
    for (int l = 0; l < G; ++l) r.v[l] = fabsf(x.v[l]) <= FLT_MAX;
    return r;
  }
  F abs(const F& x) const {
    F r;
    for (int l = 0; l < G; ++l) r.v[l] = fabsf(x.v[l]);
    return r;
  }
  F sqrt(const F& x) const {
    F r;
    for (int l = 0; l < G; ++l) r.v[l] = sqrtf(x.v[l]);
    return r;
  }
  F sign(const F& x) const {
    F r;
    for (int l = 0; l < G; ++l) r.v[l] = copysignf(1.f, x.v[l]);
    return r;
  }
  F pow2_inv(const F& x) const {
    F r;
    for (int l = 0; l < G; ++l) {
      unsigned bits;
      memcpy(&bits, &x.v[l], sizeof bits);
      const int e = static_cast<int>((bits >> 23) & 0xff);
      const unsigned k = static_cast<unsigned>(253 - (e < 252 ? e : 252))
                         << 23;
      float kf;
      memcpy(&kf, &k, sizeof kf);
      r.v[l] = x.v[l] < FLT_MIN ? 1.f : kf;
    }
    return r;
  }
  F fmax(const F& x, const F& y) const {
    F r;
    for (int l = 0; l < G; ++l) r.v[l] = fmaxf(x.v[l], y.v[l]);
    return r;
  }

  // the kernels' butterfly: at distance o, lane l adds lane l ^ o's value
  template <int K>
  void sum(float (&out)[K], const F (&x)[K]) const {
    for (int k = 0; k < K; ++k) out[k] = sum(x[k]);
  }
  float sum(F x) const {
    for (int o = G / 2; o > 0; o >>= 1) {
      const F y = x;
      for (int l = 0; l < G; ++l) x.v[l] = y.v[l] + y.v[l ^ o];
    }
    return x.v[0];
  }
  float max(F x) const {
    for (int o = G / 2; o > 0; o >>= 1) {
      const F y = x;
      for (int l = 0; l < G; ++l) x.v[l] = fmaxf(y.v[l], y.v[l ^ o]);
    }
    return x.v[0];
  }
  int argmax(F x) const {
    I i = lane();
    for (int o = G / 2; o > 0; o >>= 1) {
      const F y = x;
      const I j = i;
      for (int l = 0; l < G; ++l) {
        const float yo = y.v[l ^ o];
        const int jo = j.v[l ^ o];
        if (yo > y.v[l] || (yo == y.v[l] && jo < j.v[l])) {
          x.v[l] = yo;
          i.v[l] = jo;
        }
      }
    }
    return i.v[0];
  }
  bool all(const B& b) const {
    for (int l = 0; l < G; ++l) {
      if (!b.v[l]) return false;
    }
    return true;
  }
  F load(const float* p, const I& off, const B& ok) const {
    F r;
    for (int l = 0; l < G; ++l) r.v[l] = ok.v[l] ? p[off.v[l]] : 0.f;
    return r;
  }
  void store(float* p, const I& off, const B& ok, const F& x) const {
    for (int l = 0; l < G; ++l) {
      if (ok.v[l]) p[off.v[l]] = x.v[l];
    }
  }
  bool any(const B& b) const {
    for (int l = 0; l < G; ++l) {
      if (b.v[l]) return true;
    }
    return false;
  }
  // one group: the warp's vote is the group's own
  bool any_warp(bool b) const { return b; }
  float bcast(const F& x, int src) const { return x.v[src]; }
  void store1(float* p, int off, float x) const { p[off] = x; }
  void sync() const {}
};

template <int G, int ROWS>
int svd_one(const float* A, int m, int n, float* S, float* U, float* Vh) {
  float tile[small_linalg::kMaxM * small_linalg::kTileStride];
  return small_linalg::svd<HostLanes<G>, ROWS>(HostLanes<G>(), A, m, n, S, U,
                                               Vh, tile);
}

}  // namespace

extern "C" int jacobi_svd_f32_host(const float* A, int batch, int m, int n,
                                   float* S, float* U, float* Vh,
                                   int* sweeps) {
  using namespace small_linalg;
  const int group = svd_group(m, n);
  if (batch < 0 || m < 1 || n < 1 || n > kMaxN || Vh == nullptr ||
      group == 0 || (U && m > kMaxM)) {
    return 1;
  }
  const long long k = m < n ? m : n;
  for (long long b = 0; b < batch; ++b) {
    const float* Ab = A + b * m * n;
    float* Sb = S + b * k;
    float* Ub = U ? U + b * m * m : nullptr;
    float* Vhb = Vh + b * n * n;
    int it;
    if (group == 4) {
      it = svd_one<4, 1>(Ab, m, n, Sb, Ub, Vhb);
    } else if (group == 8) {
      it = svd_one<8, 1>(Ab, m, n, Sb, Ub, Vhb);
    } else if (group == 16) {
      it = svd_one<16, 1>(Ab, m, n, Sb, Ub, Vhb);
    } else {
      it = svd_one<32, 2>(Ab, m, n, Sb, Ub, Vhb);
    }
    if (sweeps) sweeps[b] = it;
  }
  return 0;
}

extern "C" int jacobi_eigh_f32_host(const float* A, int batch, int n,
                                    float* w, float* V, int* sweeps) {
  using namespace small_linalg;
  if (batch < 0 || n < 1 || n > kMaxN) return 1;
  float tile[2 * kMaxN * kEighStride];
  const int group = eigh_group(n);
  for (long long b = 0; b < batch; ++b) {
    const float* Ab = A + b * n * n;
    float* wb = w + b * n;
    float* Vb = V + b * n * n;
    const int it = group == 4   ? eigh(HostLanes<4>(), Ab, n, wb, Vb, tile)
                   : group == 8 ? eigh(HostLanes<8>(), Ab, n, wb, Vb, tile)
                                : eigh(HostLanes<16>(), Ab, n, wb, Vb, tile);
    if (sweeps) sweeps[b] = it;
  }
  return 0;
}
