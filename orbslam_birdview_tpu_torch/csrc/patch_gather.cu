// Patch gather for the ORB front end: for each keypoint k, the size x size
// window whose top-left corner is (ys[k], xs[k]) in its edge-padded pyramid
// level, with the corner clamped to [0, H-size] x [0, W-size] of that level
// (the clamp of jax.lax.dynamic_slice for starts past the far edge, and a
// clamp to 0 for negative starts, as the TPU kernel does).
//
// Replaces orbslam_birdview_tpu/frontend/patch_kernel.py::_window_kernel
// (reached through gather_patches). The TPU kernel DMAs aligned (64,128)
// bf16 windows from a stacked pair of shifted images and shifts them into
// place with one-hot matmuls; all of that exists for Mosaic's tiling and
// none of it is needed here.
//
// What bounds it: bytes. A frame at the full budget gathers 4000 windows of
// 48x48 f32, 36.9 MB written. The windows overlap and all padded levels of
// a frame are ~8 MB, far inside the 50 MB L2, so the reads are L2 hits and
// the floor is ~45 MB a frame (~13 us at 3.35 TB/s: each input read once,
// each output written once). A launch of a few hundred blocks per pyramid
// level spends more time starting and draining than moving its 1-6 MB.
//
// What the design does about that:
// - one launch serves every level of an extraction. The levels come as a
//   table passed by value in the kernel's parameters (image, coordinates,
//   shape, index of the level's first patch); a block finds its level with
//   at most 16 compares and writes patch k at out + k*size*size, so the
//   output is the concatenated (K_total, size, size) buffer and no copy
//   joins the levels afterwards;
// - a patch's output is one contiguous run that starts on a 16-byte boundary
//   when size is a multiple of 4, so each thread stores 16 bytes (float4).
//   The threads of a block are laid out (size/4, 16): thread (c, r) owns
//   columns 4c..4c+3 of rows r, r+16, ..., which makes consecutive threads
//   write consecutive float4s and needs no division anywhere;
// - loads stay 4 bytes wide: a window's row starts at an arbitrary pixel and
//   has no more alignment than that. They go through the read-only path;
// - stores are streaming (st.global.cs): the output is written once and
//   read by later kernels, and should not evict the levels from L2.
// A size that is not a multiple of 4 takes the scalar kernel below.
// The kernels allocate nothing and do not synchronise.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kRowsPerPass = 16;    // blockDim.y of the float4 kernel
constexpr int kScalarThreads = 256;

}  // namespace

// Mirrored field by field by the ctypes structures of the Python wrapper.
struct PatchLevel {
  const float* img;  // (H, W) f32, row-major, contiguous
  const int* ys;     // (K_l,) top-left rows of the level's patches
  const int* xs;     // (K_l,) top-left columns
  int H;
  int W;
  int k_begin;       // index of the level's first patch in the output
};

struct PatchLevelTable {
  PatchLevel level[kMaxLevels];
  int n_levels;
  int k_total;
};

namespace {

// The window of patch k: its first pixel and its level's row pitch.
__device__ __forceinline__ const float* window(const PatchLevelTable& tab,
                                               int k, int size, int* pitch) {
  int l = 0;
  for (int i = 1; i < tab.n_levels; ++i) {
    l = (k >= tab.level[i].k_begin) ? i : l;
  }
  const PatchLevel& lv = tab.level[l];
  const int j = k - lv.k_begin;
  const int y = min(max(__ldg(lv.ys + j), 0), lv.H - size);
  const int x = min(max(__ldg(lv.xs + j), 0), lv.W - size);
  *pitch = lv.W;
  return lv.img + static_cast<long long>(y) * lv.W + x;
}

// blockDim = (size/4, kRowsPerPass); one patch per block and grid step.
__global__ void patch_gather_vec4(__grid_constant__ const PatchLevelTable tab,
                                  int size, float* __restrict__ out) {
  const int q = size >> 2;
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x) {
    int pitch;
    const float* src = window(tab, k, size, &pitch) + 4 * threadIdx.x;
    float4* dst = reinterpret_cast<float4*>(
                      out + static_cast<long long>(k) * size * size) +
                  threadIdx.x;
    for (int r = threadIdx.y; r < size; r += kRowsPerPass) {
      const float* p = src + static_cast<long long>(r) * pitch;
      const float4 v =
          make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      __stcs(dst + r * q, v);
    }
  }
}

// Any size: one float per thread and iteration.
__global__ void patch_gather_scalar(
    __grid_constant__ const PatchLevelTable tab, int size,
    float* __restrict__ out) {
  const int n = size * size;
  for (int k = blockIdx.x; k < tab.k_total; k += gridDim.x) {
    int pitch;
    const float* src = window(tab, k, size, &pitch);
    float* dst = out + static_cast<long long>(k) * n;
    for (int i = threadIdx.x; i < n; i += kScalarThreads) {
      const int r = i / size;
      const int c = i - r * size;
      dst[i] = __ldg(src + static_cast<long long>(r) * pitch + c);
    }
  }
}

}  // namespace

// tab: the levels of one extraction (host memory; copied into the kernel's
// parameters); out: (tab->k_total, size, size) f32, 16-byte aligned. The
// caller checks 1 <= n_levels <= 16, H >= size, W >= size and size <= 64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int patch_gather_levels_f32(const PatchLevelTable* tab, int size,
                                       float* out, void* stream) {
  const int K = tab->k_total;
  if (K > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (size % 4 == 0) {
      patch_gather_vec4<<<K, dim3(size / 4, kRowsPerPass), 0, s>>>(*tab, size,
                                                                  out);
    } else {
      patch_gather_scalar<<<K, kScalarThreads, 0, s>>>(*tab, size, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
