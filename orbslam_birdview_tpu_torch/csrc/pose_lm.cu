// The motion-only pose LM of graph/pose_opt.py::optimize_pose (the
// reference's PoseOptimizationWithBirdview) as one kernel a call: every
// round and LM iteration runs on the card, and a round's loop ends at the
// iteration where the plain version's `done` flag would freeze it.
//
// It replaces no Pallas kernel: the JAX package's LM is XLA code (its
// graph/pose_opt.py gives Mosaic's scalar 6x6 Cholesky as the reason not
// to fuse it on the TPU). Here it replaces ~12,000 small PyTorch launches a
// call: each iteration's normal-equation build, unrolled Cholesky and SE3
// update issued as ~280 elementwise and reduction kernels.
//
// What bounds it: neither bytes nor operations. The fused step's call reads
// ~213 KB of edges (6,144 mono edges of 25 B, 2,048 bird edges of 29 B:
// 0.064 us at 3.35 TB/s) and does ~100 flops an edge a build, ~54 MFLOP
// over the 66 builds of a frame's two calls. What is left is latency: up to
// 2 + 4 rounds of 1 + 10 builds, each a reduction over every edge followed
// by a 6x6 solve that the next build depends on.
//
// What the design does about that:
// - one thread-block cluster a call, its CTA count (1, 2, 4 or 8) chosen by
//   the launcher from the number of edges, ~1,024 edges a CTA; each CTA loads
//   its slice of the edges into shared memory once and keeps it for the
//   whole call, so no build reads device memory;
// - a build: each thread accumulates the 21 + 6 entries of H and g (the
//   plain version's (P*w) P^T, lower triangle) and the three cost terms
//   over its edges in registers; the warp sums its 32 slots with 31
//   shuffles (a transposing butterfly: lane j ends with slot j), the CTA
//   over its warps in shared memory, and each CTA writes its 32 sums into
//   the leader CTA's shared memory (distributed shared memory) before a
//   cluster barrier;
// - one thread of the leader sums the CTAs' slots, damps, solves the 6x6
//   system by Cholesky, applies the SE3 update, runs the accept test and
//   the lambda schedule, and writes the next pose to build at with a
//   continue flag into every CTA's shared memory; one more cluster barrier
//   and the next build starts. Two cluster barriers an iteration, no round
//   trip through device memory, no second launch;
// - at a round's end each thread reclassifies its own edges in shared
//   memory; after the last round they write the inlier masks and the
//   leader the pose, the inlier count and the last round's cost.
// The arithmetic is the plain version's, term for term (the per-edge
// formulas, Huber weights with delta taken in f32, the behind-camera
// penalty, the 1e-12 pivot clamp, the Taylor branches of the SE3 exp); its
// sums run in another order, so results agree to rounding. No fast-math.
// The kernel allocates nothing and does not synchronise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Mirrored field by field by the ctypes structure of graph/pose_opt.py.
struct PoseLMArgs {
  const float* R0;              // (3,3) start pose, row-major
  const float* t0;              // (3,)
  const float* Xw;              // (N,3) world points of the mono edges
  const float* obs;             // (N,2) observed pixels
  const float* info;            // (N,) 1/sigma^2
  const unsigned char* valid;   // (N,) bool
  const float* Xw_b;            // (Nb,3) bird landmarks
  const float* obs_b;           // (Nb,3) observed camera-frame points
  const float* info_b;          // (Nb,)
  const unsigned char* valid_b; // (Nb,) bool
  float* R;                     // (3,3) out
  float* t;                     // (3,) out
  unsigned char* inl;           // (N,) out
  unsigned char* inl_b;         // (Nb,) out; (1,) set false when Nb = 0
  int* n_inliers;               // () out: mono + bird inliers
  float* chi2;                  // () out: the last round's cost
  float fx, fy, cx, cy;
  int n, nb, rounds, iters;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 8;           // the portable cluster size
constexpr int kEdgesPerCta = 1024;    // the slice a CTA aims for
constexpr int kMaxPerCta = 7680;      // 29 B an edge: 222,720 B of slice
constexpr int kFields = 7;            // floats an edge in shared memory
constexpr int kSlots = 32;            // reduced values a build
// slots: 0-20 lower triangle of H (row i, column j <= i at i(i+1)/2 + j),
// 21-26 g, 27 mono robust cost, 28 behind-camera count, 29 bird cost
constexpr int kG = 21, kCostMono = 27, kBehind = 28, kCostBird = 29;
constexpr int kPose = 12;             // R row-major, then t
constexpr float kChi2Mono = 5.991f, kChi2Bird = 7.815f;
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float huber_weight(float chi2, float delta2,
                                              float delta) {
  return chi2 <= delta2 ? 1.0f : delta / sqrtf(clamp_min(chi2, 1e-12f));
}

__device__ __forceinline__ float huber_rho(float chi2, float delta2,
                                           float delta) {
  return chi2 <= delta2 ? chi2
                        : (2.0f * delta) * sqrtf(clamp_min(chi2, 0.0f)) -
                              delta2;
}

// acc += (p w) p^T over the lower triangle of the 6x6 block and the
// g column: one residual row p = [J(6) | e] of weight w
__device__ __forceinline__ void add_row(float (&acc)[kSlots],
                                        const float (&p)[7], float w) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float pw = p[i] * w;
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[i * (i + 1) / 2 + j] += pw * p[j];
    acc[kG + i] += pw * p[6];
  }
}

__device__ __forceinline__ void transform(const float* P, float X0, float X1,
                                          float X2, float& x, float& y,
                                          float& z) {
  x = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[9];
  y = P[3] * X0 + P[4] * X1 + P[5] * X2 + P[10];
  z = P[6] * X0 + P[7] * X1 + P[8] * X2 + P[11];
}

// An edge slice in shared memory: field k of local edge l at f[k*per + l];
// mono edges first (Xw, obs, info), then bird (Xw_b, obs_b, info_b).
// flag bit 0: valid, bit 1: active (an inlier of the last reclassification)
struct Slice {
  float* f;
  unsigned char* flag;
  int per, n_local, n_mono;
  __device__ float at(int k, int l) const { return f[k * per + l]; }
};

struct Camera {
  float fx, fy, cx, cy;
};

// the mono edge's camera point, pixel residual and chi^2
struct MonoEval {
  float x, y, z, zi, eu, ev, chi2;
  bool ok;
};

__device__ __forceinline__ MonoEval eval_mono(const Slice& s, int l,
                                              const float* P,
                                              const Camera& c) {
  MonoEval m;
  transform(P, s.at(0, l), s.at(1, l), s.at(2, l), m.x, m.y, m.z);
  m.zi = 1.0f / clamp_min(m.z, 1e-9f);
  m.ok = m.z > 1e-6f;
  m.eu = s.at(3, l) - (c.fx * m.x * m.zi + c.cx);
  m.ev = s.at(4, l) - (c.fy * m.y * m.zi + c.cy);
  m.chi2 = (m.eu * m.eu + m.ev * m.ev) * s.at(5, l);
  return m;
}

struct BirdEval {
  float x, y, z, e0, e1, e2, chi2;
};

__device__ __forceinline__ BirdEval eval_bird(const Slice& s, int l,
                                              const float* P) {
  BirdEval b;
  transform(P, s.at(0, l), s.at(1, l), s.at(2, l), b.x, b.y, b.z);
  b.e0 = s.at(3, l) - b.x;
  b.e1 = s.at(4, l) - b.y;
  b.e2 = s.at(5, l) - b.z;
  b.chi2 = (b.e0 * b.e0 + b.e1 * b.e1 + b.e2 * b.e2) * s.at(6, l);
  return b;
}

// One thread's share of a normal-equation build at pose P (_build_normal_eq)
__device__ void build_edges(const Slice& s, const float* P, const Camera& c,
                            bool huber, float delta_m, float delta_b,
                            float (&acc)[kSlots]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
  for (int l = threadIdx.x; l < s.n_local; l += kThreads) {
    const bool active = s.flag[l] & 2;
    if (l < s.n_mono) {
      const MonoEval m = eval_mono(s, l, P, c);
      float w = huber ? huber_weight(m.chi2, kChi2Mono, delta_m) : 1.0f;
      w = w * s.at(5, l) * (active ? 1.0f : 0.0f) * (m.ok ? 1.0f : 0.0f);
      if (active && m.ok) {
        acc[kCostMono] += huber ? huber_rho(m.chi2, kChi2Mono, delta_m)
                                : m.chi2;
      }
      if (active && !m.ok) acc[kBehind] += 1.0f;
      // J = -Jp [I | -hat(Xc)], the rows of u and v
      const float xz = m.x * m.zi, yz = m.y * m.zi;
      const float pu[7] = {-c.fx * m.zi, 0.0f, c.fx * xz * m.zi,
                           c.fx * xz * yz, -c.fx * (1.0f + xz * xz),
                           c.fx * yz, m.eu};
      const float pv[7] = {0.0f, -c.fy * m.zi, c.fy * yz * m.zi,
                           c.fy * (1.0f + yz * yz), -c.fy * xz * yz,
                           -c.fy * xz, m.ev};
      add_row(acc, pu, w);
      add_row(acc, pv, w);
    } else {
      const BirdEval b = eval_bird(s, l, P);
      float w = huber ? huber_weight(b.chi2, kChi2Bird, delta_b) : 1.0f;
      w = w * s.at(6, l) * (active ? 1.0f : 0.0f);
      if (active) {
        acc[kCostBird] += huber ? huber_rho(b.chi2, kChi2Bird, delta_b)
                                : b.chi2;
      }
      // J_b = -[I | -hat(Xc)]
      const float r0[7] = {-1.0f, 0.0f, 0.0f, 0.0f, -b.z, b.y, b.e0};
      const float r1[7] = {0.0f, -1.0f, 0.0f, b.z, 0.0f, -b.x, b.e1};
      const float r2[7] = {0.0f, 0.0f, -1.0f, -b.y, b.x, 0.0f, b.e2};
      add_row(acc, r0, w);
      add_row(acc, r1, w);
      add_row(acc, r2, w);
    }
  }
}

// The warp's sums of the 32 slots, slot j ending in lane j: each halving
// step sends one half of the remaining slots to the partner lane.
__device__ __forceinline__ float warp_sum_slots(float (&v)[kSlots],
                                                int lane) {
#pragma unroll
  for (int h = kSlots / 2; h >= 1; h >>= 1) {
    const bool upper = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// Every thread's slots summed over the CTA and written to row `rank` of
// the leader's `part`; the caller's cluster barrier publishes them.
__device__ void push_sums(cg::cluster_group& cluster, float (&acc)[kSlots],
                          float (*warp_part)[kSlots], float* part,
                          unsigned rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_part[warp][lane] = warp_sum_slots(acc, lane);
  __syncthreads();
  if (threadIdx.x < kSlots) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    cluster.map_shared_rank(part, 0)[rank * kSlots + threadIdx.x] = s;
  }
}

// The leader's state, touched by its solver thread alone.
struct Solver {
  float R[9], t[3];   // the accepted pose
  float H[21], g[6];  // lower triangle of H, g at the accepted pose
  float cost, lam;
  float dx[6];
  float trial[kPose];
  int it;
};

// (H, g, cost) from the CTAs' summed slots
__device__ void take_sums(const float* sum, float* H, float* g, float& cost) {
  for (int k = 0; k < 21; ++k) H[k] = sum[k];
  for (int i = 0; i < 6; ++i) g[i] = sum[kG + i];
  cost = (sum[kCostMono] + 59.91f * sum[kBehind]) + sum[kCostBird];
}

// dx = -(H + lam diag(H) + 1e-10 I)^-1 g: linalg.solve_psd_small's
// Cholesky with the pivots clamped to 1e-12 and its two triangular solves
__device__ void solve_step(const float* H, const float* g, float lam,
                           float* dx) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i * (i + 1) / 2 + j];
      if (i == j) s = (s + lam * s) + 1e-10f;
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(clamp_min(s, 1e-12f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  float x[6];
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  for (int i = 0; i < 6; ++i) dx[i] = -x[i];
}

// (R, t) <- exp(dx) (R, t): lie.se3_update_left with _sinc_terms' closed
// forms and Taylor branch; dx = [rho, phi]
__device__ void se3_update_left(const float* R, const float* t,
                                const float* dx, float* out) {
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(clamp_min(theta2, 1e-14f));
  const bool small = theta2 < 1e-8f;
  const float safe = small ? 1.0f : theta;
  const float A = small ? 1.0f - theta2 / 6.0f : sinf(safe) / safe;
  const float B = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(safe)) / (safe * safe);
  const float C = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (safe - sinf(safe)) / (safe * safe * safe);
  const float W[9] = {0.0f, -p2, p1, p2, 0.0f, -p0, -p1, p0, 0.0f};
  float WW[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      WW[i * 3 + j] = W[i * 3] * W[j] + W[i * 3 + 1] * W[3 + j] +
                      W[i * 3 + 2] * W[6 + j];
    }
  }
  float dR[9], V[9];
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    dR[k] = eye + A * W[k] + B * WW[k];
    V[k] = eye + B * W[k] + C * WW[k];
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      out[i * 3 + j] = dR[i * 3] * R[j] + dR[i * 3 + 1] * R[3 + j] +
                       dR[i * 3 + 2] * R[6 + j];
    }
    const float dt = V[i * 3] * dx[0] + V[i * 3 + 1] * dx[1] +
                     V[i * 3 + 2] * dx[2];
    out[9 + i] = dR[i * 3] * t[0] + dR[i * 3 + 1] * t[1] +
                 dR[i * 3 + 2] * t[2] + dt;
  }
}

// Solve at the accepted state and set the trial pose (false once the
// round's iterations are spent).
__device__ bool solver_propose(Solver& st, int iters) {
  if (st.it >= iters) return false;
  solve_step(st.H, st.g, st.lam, st.dx);
  se3_update_left(st.R, st.t, st.dx, st.trial);
  return true;
}

// The accept test and lambda schedule of one iteration, given the trial's
// build; ends the round when the plain version's `stop` fires.
__device__ void solver_judge(Solver& st, const float* sum, int iters) {
  float Hn[21], gn[6], cost1;
  take_sums(sum, Hn, gn, cost1);
  bool finite = true;
  float dmax = 0.0f;
  for (int i = 0; i < 6; ++i) {
    finite = finite && isfinite(st.dx[i]);
    dmax = fmaxf(dmax, fabsf(st.dx[i]));
  }
  const bool accept = cost1 < st.cost && finite;
  if (accept) {
    for (int k = 0; k < 9; ++k) st.R[k] = st.trial[k];
    for (int k = 0; k < 3; ++k) st.t[k] = st.trial[9 + k];
    for (int k = 0; k < 21; ++k) st.H[k] = Hn[k];
    for (int k = 0; k < 6; ++k) st.g[k] = gn[k];
    st.cost = cost1;
  }
  const float lam = fminf(fmaxf(accept ? st.lam * 0.5f : st.lam * 4.0f,
                                1e-9f), 1e6f);
  const bool stop = (accept && dmax < 1e-6f) || lam > 1e5f;
  st.lam = lam;
  st.it = stop ? iters : st.it + 1;
}

// chi^2 gates of the round's end (_chi2_only): a behind-camera mono edge
// counts as chi^2 = inf
__device__ void reclassify(const Slice& s, const float* P, const Camera& c) {
  for (int l = threadIdx.x; l < s.n_local; l += kThreads) {
    bool in;
    if (l < s.n_mono) {
      const MonoEval m = eval_mono(s, l, P, c);
      in = m.ok && m.chi2 <= kChi2Mono;
    } else {
      in = eval_bird(s, l, P).chi2 <= kChi2Bird;
    }
    const unsigned char f = s.flag[l];
    s.flag[l] = (f & 1) | (((f & 1) && in) ? 2 : 0);
  }
}

// kCtas CTAs, one cluster: the cluster size is a template parameter
// (__cluster_dims__) so that the launch is a plain <<<>>> one
// (cudaLaunchKernel), which the profiler links to the host range that
// issued it; a launch through cudaLaunchKernelEx was traced but not linked.
template <int kCtas>
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
    pose_lm_kernel(const PoseLMArgs a, int per) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  constexpr unsigned n_ctas = kCtas;
  const bool leader = rank == 0;
  const bool solver = leader && threadIdx.x == 0;

  extern __shared__ float slice_mem[];
  __shared__ float warp_part[kWarps][kSlots];
  __shared__ float part[kCtas * kSlots];      // the leader's: a row a CTA
  __shared__ float sum[kSlots];              // the leader's: CTAs summed
  __shared__ float cmd[kPose + 1];           // pose to build at, continue
  __shared__ float out[kPose + 1];           // the leader's next cmd
  __shared__ Solver st;                      // the leader's

  const int E = a.n + a.nb;
  const int e0 = min(E, static_cast<int>(rank) * per);
  const int e1 = min(E, e0 + per);
  Slice s;
  s.f = slice_mem;
  s.flag = reinterpret_cast<unsigned char*>(slice_mem + kFields * per);
  s.per = per;
  s.n_local = e1 - e0;
  s.n_mono = max(0, min(e1, a.n) - e0);
  for (int l = threadIdx.x; l < s.n_local; l += kThreads) {
    const int e = e0 + l;
    unsigned char v;
    if (l < s.n_mono) {
      for (int k = 0; k < 3; ++k) s.f[k * per + l] = a.Xw[3 * e + k];
      s.f[3 * per + l] = a.obs[2 * e];
      s.f[4 * per + l] = a.obs[2 * e + 1];
      s.f[5 * per + l] = a.info[e];
      v = a.valid[e] != 0;
    } else {
      const int b = e - a.n;
      for (int k = 0; k < 3; ++k) {
        s.f[k * per + l] = a.Xw_b[3 * b + k];
        s.f[(3 + k) * per + l] = a.obs_b[3 * b + k];
      }
      s.f[6 * per + l] = a.info_b[b];
      v = a.valid_b[b] != 0;
    }
    s.flag[l] = v ? 3 : 0;
  }
  if (threadIdx.x <= kPose) {   // the start pose; cmd[kPose] = 0: a
    cmd[threadIdx.x] = threadIdx.x < 9 ? a.R0[threadIdx.x]   // round starts
                       : threadIdx.x < kPose ? a.t0[threadIdx.x - 9] : 0.0f;
  }
  const Camera cam{a.fx, a.fy, a.cx, a.cy};
  // sqrt of the thresholds in f32, as robust._sqrt_in takes them
  const float delta_m = sqrtf(kChi2Mono), delta_b = sqrtf(kChi2Bird);
  float acc[kSlots];
  float last_cost = 0.0f;
  // every CTA of the cluster runs and holds its slice before any remote
  // shared-memory access
  cluster.sync();

  for (int rnd = 0; rnd < a.rounds; ++rnd) {
    const bool huber = rnd < 2;
    build_edges(s, cmd, cam, huber, delta_m, delta_b, acc);
    push_sums(cluster, acc, warp_part, part, rank);
    cluster.sync();
    for (;;) {
      if (leader && threadIdx.x < 32) {
        if (threadIdx.x < kSlots) {
          float v = 0.0f;
          for (unsigned r = 0; r < n_ctas; ++r) v += part[r * kSlots +
                                                          threadIdx.x];
          sum[threadIdx.x] = v;
        }
        __syncwarp();
        if (solver) {
          if (cmd[kPose] == 0.0f) {   // the round's first build
            for (int k = 0; k < 9; ++k) st.R[k] = cmd[k];
            for (int k = 0; k < 3; ++k) st.t[k] = cmd[9 + k];
            take_sums(sum, st.H, st.g, st.cost);
            st.lam = 1e-4f;
            st.it = 0;
          } else {
            solver_judge(st, sum, a.iters);
          }
          const bool go = solver_propose(st, a.iters);
          for (int k = 0; k < kPose; ++k) {
            out[k] = go ? st.trial[k] : (k < 9 ? st.R[k] : st.t[k - 9]);
          }
          out[kPose] = go ? 1.0f : 0.0f;
          last_cost = st.cost;
        }
        __syncwarp();
        for (unsigned i = threadIdx.x; i < n_ctas * (kPose + 1); i += 32) {
          const unsigned r = i / (kPose + 1), k = i % (kPose + 1);
          cluster.map_shared_rank(cmd, r)[k] = out[k];
        }
      }
      cluster.sync();
      if (cmd[kPose] == 0.0f) break;   // cmd holds the accepted pose
      build_edges(s, cmd, cam, huber, delta_m, delta_b, acc);
      push_sums(cluster, acc, warp_part, part, rank);
      cluster.sync();
    }
    reclassify(s, cmd, cam);
  }

  // the inlier masks, and their count summed like a build's slots
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
  for (int l = threadIdx.x; l < s.n_local; l += kThreads) {
    const int e = e0 + l;
    const bool in = s.flag[l] & 2;
    if (l < s.n_mono) {
      a.inl[e] = in;
    } else {
      a.inl_b[e - a.n] = in;
    }
    acc[0] += in ? 1.0f : 0.0f;
  }
  push_sums(cluster, acc, warp_part, part, rank);
  cluster.sync();
  if (solver) {
    float n_in = 0.0f;
    for (unsigned r = 0; r < n_ctas; ++r) n_in += part[r * kSlots];
    *a.n_inliers = static_cast<int>(n_in);
    *a.chi2 = last_cost;
    for (int k = 0; k < 9; ++k) a.R[k] = cmd[k];
    for (int k = 0; k < 3; ++k) a.t[k] = cmd[9 + k];
    if (a.nb == 0 && a.inl_b != nullptr) a.inl_b[0] = 0;
  }
}

template <int kCtas>
cudaError_t launch(const PoseLMArgs& a, int per, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_lm_kernel<kCtas>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pose_lm_kernel<kCtas><<<kCtas, kThreads, smem, stream>>>(a, per);
  return cudaGetLastError();
}

}  // namespace

// The CTAs a call takes for `edges` edges (mono + bird): 1, 2, 4 or 8, the
// fewest that give each at most kEdgesPerCta; and the edges each holds.
// 0 CTAs when the slices would not fit in shared memory.
static int cluster_ctas(int edges, int* per) {
  int ctas = 1;
  while (ctas < kMaxCtas && ctas * kEdgesPerCta < edges) ctas *= 2;
  *per = (edges + ctas - 1) / ctas;
  return *per > kMaxPerCta ? 0 : ctas;
}

// One launch: every round and iteration of the pose LM for one problem.
extern "C" int pose_lm_f32(const PoseLMArgs* a, void* stream) {
  int per = 0;
  const int ctas = cluster_ctas(a->n + a->nb, &per);
  if (a->n < 0 || a->nb < 0 || a->rounds < 0 || a->iters < 0 || ctas == 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(per) * (kFields * sizeof(float) + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ctas) {
    case 1: return launch<1>(*a, per, smem, s);
    case 2: return launch<2>(*a, per, smem, s);
    case 4: return launch<4>(*a, per, smem, s);
    default: return launch<8>(*a, per, smem, s);
  }
}
