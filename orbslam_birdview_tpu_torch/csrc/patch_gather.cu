// Patch gather for the ORB front end: for each keypoint k, the size x size
// window whose top-left corner is (ys[k], xs[k]) in one edge-padded pyramid
// level, with the corner clamped to [0, H-size] x [0, W-size] (the clamp of
// jax.lax.dynamic_slice for starts past the far edge, and a clamp to 0 for
// negative starts, as the TPU kernel does).
//
// Replaces orbslam_birdview_tpu/frontend/patch_kernel.py::_window_kernel
// (reached through gather_patches). The TPU kernel DMAs aligned (64,128)
// bf16 windows from a stacked pair of shifted images and shifts them into
// place with one-hot matmuls; all of that exists for Mosaic's tiling and
// none of it is needed here.
//
// What bounds it: bytes. A frame at the full budget gathers 4000 windows of
// 48x48 f32, 36.9 MB written. Read window by window that is another 36.9 MB
// (~74 MB in all, ~22 us at 3.35 TB/s); but the windows overlap, and the
// padded levels themselves are ~8 MB, so with L2 catching the re-reads the
// floor is ~45 MB (~13 us: each input read once, each output written once).
// The design is
// the simple one: one block per keypoint, whose threads walk the window in
// row-major order so that neighbouring threads read neighbouring columns of
// a row (coalesced 192-byte row segments) and write neighbouring outputs
// (the block's output is one contiguous 9216-byte run). One launch per
// pyramid level; the kernel allocates nothing and does not synchronise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void patch_gather_kernel(const float* __restrict__ img, int H,
                                    int W, const int* __restrict__ ys,
                                    const int* __restrict__ xs, int size,
                                    float* __restrict__ out) {
  const int k = blockIdx.x;
  const int y = min(max(ys[k], 0), H - size);
  const int x = min(max(xs[k], 0), W - size);
  const float* src = img + static_cast<long long>(y) * W + x;
  float* dst = out + static_cast<long long>(k) * size * size;
  const int n = size * size;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / size;
    const int c = i - r * size;
    dst[i] = src[static_cast<long long>(r) * W + c];
  }
}

}  // namespace

// img: (H, W) f32, row-major, contiguous; ys, xs: (K,) i32; out: (K, size,
// size) f32. The caller checks H >= size, W >= size and size <= 64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int patch_gather_f32(const float* img, int H, int W, const int* ys,
                                const int* xs, int K, int size, float* out,
                                void* stream) {
  if (K > 0) {
    patch_gather_kernel<<<K, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        img, H, W, ys, xs, size, out);
  }
  return static_cast<int>(cudaGetLastError());
}
