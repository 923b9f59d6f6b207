// ORB detection for frontend/orb.py::detect_levels: for every pyramid level
// of one extraction, the level image, FAST-9/16 at the minimum threshold
// with the border and footprint masks, 3x3 non-max suppression, the per-cell
// top-k, the sub-pixel fit and the level's rank-penalised pick, slot for slot
// and bit for bit as the plain version orb.py::detect_levels_plain computes
// them. The stages are in csrc/orb_detect.cuh, shared with the host build
// that the CPU tests run (csrc/orb_detect_host.cpp).
//
// It replaces no Pallas kernel: these are integer-exact stages that the JAX
// package wrote as XLA code. Here they replace ~200 small PyTorch launches a
// level (~2,400 a bird frame of 12 levels): the 16 FAST taps and 16 arc
// tests, the resizes, the per-cell argmax rounds, the sort.
//
// What bounds it: latency. A bird frame's levels hold ~0.6 M pixels; the
// kernels read each level once and write it once with its edge padding
// (16.6 MB a bird frame, ~5 us at 3.35 TB/s) and do a few hundred
// operations a pixel. What is left is the chain of levels, each resized
// from the last, and the pick's sort.
//
// What the design does about that:
// - one launch a level, one CTA a `cell` x `cell` cell. The CTA resizes its
//   haloed tile of level pixels (cell + 10 a side: the sub-pixel fit reads
//   the response 2 past the cell, FAST 3 past that) from the previous level
//   into shared memory, and runs FAST, the masks, the suppression, the
//   cell's top-k and the sub-pixel fit there; no response map is written.
//   It writes its cell of the level, edge-padded as the patch gather reads
//   it, which the next level's launch resizes from;
// - one launch for the pick of every level, a CTA a level: a bitonic sort of
//   the level's candidates in shared memory, keyed on (penalised response
//   descending, candidate index ascending), which is the plain version's
//   stable descending sort;
// - the host issues the n_levels + 1 launches from one C call.
// The kernels allocate nothing and do not synchronise.
#include <cuda_runtime.h>

#include "orb_detect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPickThreads = 1024;

// One CTA a cell of level l: the cell's per_cell candidates into the
// scratch.
__global__ void __launch_bounds__(kThreads)
    orb_detect_level(const __grid_constant__ OrbDetectArgs a, int l) {
  __shared__ orb_detect::CellState s;
  const int tid = threadIdx.x, nt = blockDim.x, cell = blockIdx.x;
  if (tid == 0) s.n_pos = 0;
  orb_detect::cell_tile(a, l, cell, s, tid, nt);
  __syncthreads();
  orb_detect::cell_response(a, l, cell, s, tid, nt);
  __syncthreads();
  orb_detect::cell_suppress(a, l, cell, s, tid, nt);
  __syncthreads();
  orb_detect::cell_rank(a, s, tid, nt);
  __syncthreads();
  orb_detect::cell_fit(a, l, cell, s, tid, nt);
}

// One CTA a level: the level's pick, its keys in dynamic shared memory.
__global__ void __launch_bounds__(kPickThreads)
    orb_pick(const __grid_constant__ OrbDetectArgs a) {
  extern __shared__ unsigned long long keys[];
  orb_detect::pick_level(a, blockIdx.x, keys, threadIdx.x, blockDim.x);
}

}  // namespace

// a: one extraction's levels and buffers (host memory; copied into each
// kernel's parameters). The caller checks the limits: 1 <= n_levels <= 16,
// cell <= 32, per_cell <= 8 and <= cell * cell, every level's candidates
// <= pick_keys <= 16384 and >= its k. Returns the first CUDA error of the
// launches (0 on success).
extern "C" int orb_detect_levels_f32(const OrbDetectArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < a->n_levels; ++l) {
    orb_detect_level<<<a->level[l].ncx * a->level[l].ncy, kThreads, 0, s>>>(
        *a, l);
  }
  const int smem = a->pick_keys * static_cast<int>(sizeof(unsigned long long));
  const cudaError_t err = cudaFuncSetAttribute(
      orb_pick, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  orb_pick<<<a->n_levels, kPickThreads, smem, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
