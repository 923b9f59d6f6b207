// Design variants of the multi-level patch gather, behind one C entry point,
// for tools/patch_gather_variants.py to check and time side by side on the
// card. The kernel the port ships is csrc/patch_gather.cu (variant "A1
// streaming" here); this file records what it was chosen against:
//   A1  one block a patch, threads (size/4, 16), four 4-byte loads and one
//       16-byte store a thread and row; with streaming or plain stores, and
//       with the size fixed at compile time and the rows unrolled;
//   A2  the same with two aligned 16-byte loads and a select per store;
//   A3  coalesced 4-byte loads into shared memory, 16-byte stores out of it;
//   B   persistent blocks, a ring of patches in shared memory, each sent out
//       by one thread as a bulk asynchronous store (cp.async.bulk);
//   S   one float a thread and iteration with a division, as the first port
//       of the kernel did per level, here in one launch.
// The level table is that of csrc/patch_gather.cu.
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int kMaxLevels = 16;
constexpr int S = 48;          // A2, A3, B and the unrolled A1 fix the side
constexpr int N = S * S;
struct PatchLevel { const float* img; const int* ys; const int* xs; int H, W, k_begin; };
struct PatchLevelTable { PatchLevel level[kMaxLevels]; int n_levels; int k_total; };

__device__ __forceinline__ const float* window(const PatchLevelTable& tab, int k, int size, int* pitch, const float** img = nullptr, int* numel = nullptr) {
  int l = 0;
  for (int i = 1; i < tab.n_levels; ++i) l = (k >= tab.level[i].k_begin) ? i : l;
  const PatchLevel& lv = tab.level[l];
  const int j = k - lv.k_begin;
  const int y = min(max(__ldg(lv.ys + j), 0), lv.H - size);
  const int x = min(max(__ldg(lv.xs + j), 0), lv.W - size);
  *pitch = lv.W;
  if (img) *img = lv.img;
  if (numel) *numel = lv.H * lv.W;
  return lv.img + static_cast<long long>(y) * lv.W + x;
}

// 0, 1: A1 with the size at run time; STREAM selects __stcs
template <bool STREAM>
__global__ void a1(__grid_constant__ const PatchLevelTable tab, int size, float* __restrict__ out) {
  const int q = size >> 2;
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x) {
    int pitch;
    const float* src = window(tab, k, size, &pitch) + 4 * threadIdx.x;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(k) * size * size) + threadIdx.x;
    for (int r = threadIdx.y; r < size; r += 16) {
      const float* p = src + static_cast<long long>(r) * pitch;
      const float4 v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      if (STREAM) __stcs(dst + r * q, v); else dst[r * q] = v;
    }
  }
}

// 7: A1 with compile-time size, fully unrolled: 12 loads in flight per thread
__global__ void a1_unrolled(__grid_constant__ const PatchLevelTable tab, float* __restrict__ out) {
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x) {
    int pitch;
    const float* src = window(tab, k, S, &pitch) + 4 * threadIdx.x;
    src += static_cast<long long>(threadIdx.y) * pitch;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(k) * N) + threadIdx.y * (S / 4) + threadIdx.x;
    float4 v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* p = src + static_cast<long long>(16 * i) * pitch;
      v[i] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) __stcs(dst + 16 * i * (S / 4), v[i]);
  }
}

// 3: A2 two aligned 16-byte loads and a select
__global__ void a2(__grid_constant__ const PatchLevelTable tab, float* __restrict__ out) {
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x) {
    int pitch, numel; const float* img;
    const float* src = window(tab, k, S, &pitch, &img, &numel) + 4 * threadIdx.x;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(k) * N) + threadIdx.x;
    const long long base = src - img;
    for (int r = threadIdx.y; r < S; r += 16) {
      const long long a = base + static_cast<long long>(r) * pitch;
      const int s = static_cast<int>(a & 3);
      const long long a0 = a - s;
      float4 v;
      if (a0 + 8 <= numel) {
        const float4 A = __ldg(reinterpret_cast<const float4*>(img + a0));
        const float4 B = __ldg(reinterpret_cast<const float4*>(img + a0 + 4));
        v = s == 0 ? A : s == 1 ? make_float4(A.y, A.z, A.w, B.x) : s == 2 ? make_float4(A.z, A.w, B.x, B.y) : make_float4(A.w, B.x, B.y, B.z);
      } else {
        const float* p = img + a;
        v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      }
      __stcs(dst + r * (S / 4), v);
    }
  }
}

// 4: A3 coalesced scalar loads -> shared -> float4 streaming stores; 256 threads
__global__ void a3(__grid_constant__ const PatchLevelTable tab, float* __restrict__ out) {
  __shared__ __align__(16) float buf[N];
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x) {
    int pitch;
    const float* src = window(tab, k, S, &pitch);
#pragma unroll
    for (int i = threadIdx.x; i < N; i += 256) {
      const int r = i / S, c = i - r * S;
      buf[i] = __ldg(src + static_cast<long long>(r) * pitch + c);
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(k) * N);
    for (int i = threadIdx.x; i < N / 4; i += 256) __stcs(dst + i, reinterpret_cast<const float4*>(buf)[i]);
    __syncthreads();
  }
}

// 5: B persistent blocks, ring of STAGES patches in shared memory, bulk async stores
template <int STAGES>
__global__ void bulk(__grid_constant__ const PatchLevelTable tab, float* __restrict__ out) {
  extern __shared__ __align__(128) float ring[];
  int it = 0;
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x, ++it) {
    float* buf = ring + (it % STAGES) * N;
    if (it >= STAGES) {
      if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(STAGES - 1) : "memory");
      __syncthreads();
    }
    int pitch;
    const float* src = window(tab, k, S, &pitch);
#pragma unroll
    for (int i = threadIdx.x; i < N; i += 256) {
      const int r = i / S, c = i - r * S;
      buf[i] = __ldg(src + static_cast<long long>(r) * pitch + c);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint64_t g = static_cast<uint64_t>(__cvta_generic_to_global(out + static_cast<long long>(k) * N));
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(g), "r"(s), "r"(N * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// 6: the per-level kernel of before, one launch: scalar, division in the loop
__global__ void old_scalar(__grid_constant__ const PatchLevelTable tab, int size, float* __restrict__ out) {
  const int n = size * size;
  const int k = blockIdx.x;
  int pitch;
  const float* src = window(tab, k, size, &pitch);
  float* dst = out + static_cast<long long>(k) * n;
  for (int i = threadIdx.x; i < n; i += 256) {
    const int r = i / size, c = i - r * size;
    dst[i] = src[static_cast<long long>(r) * pitch + c];
  }
}

extern "C" int gather_variant(const PatchLevelTable* tab, int size, float* out, void* stream, int variant, int grid) {
  const int K = tab->k_total;
  if (K == 0) return 0;
  if (grid <= 0 || grid > K) grid = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 b2(size / 4, 16);
  switch (variant) {
    case 0: a1<true><<<grid, b2, 0, s>>>(*tab, size, out); break;
    case 1: a1<false><<<grid, b2, 0, s>>>(*tab, size, out); break;
    case 3: a2<<<grid, b2, 0, s>>>(*tab, out); break;
    case 4: a3<<<grid, 256, 0, s>>>(*tab, out); break;
    case 5: bulk<3><<<grid, 256, 3 * N * 4, s>>>(*tab, out); break;
    case 8: bulk<2><<<grid, 256, 2 * N * 4, s>>>(*tab, out); break;
    case 6: old_scalar<<<K, 256, 0, s>>>(*tab, size, out); break;
    case 7: a1_unrolled<<<grid, b2, 0, s>>>(*tab, out); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
