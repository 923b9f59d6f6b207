"""Patch gather: per-keypoint square windows out of one pyramid level.

`gather_patches` launches the hand-written CUDA kernel in
`csrc/patch_gather.cu` for CUDA tensors and raises on anything the kernel
does not take; for CPU tensors it runs `gather_patches_plain`, the plain
PyTorch version of the same function. There is no fallback from the one to
the other.

The kernel replaces the JAX package's Pallas kernel
`frontend/patch_kernel.py::_window_kernel` (reached through
`gather_patches`). Contract: the output is bit-equal to slicing each
(size, size) window at its start, with starts clamped to
[0, Hp−size] × [0, Wp−size]. That is the clamp of `jax.lax.dynamic_slice`
for starts past the far edge; for NEGATIVE starts it is the TPU kernel's
clamp to 0, which the reference's CPU path does not share (there
`vmap(dynamic_slice)` wraps −s to Hp−s first). On the extractor's path the
starts are keypoint coordinates, always ≥ 0, so the two never meet there.

What bounds the kernel is bytes: the full-budget frame writes 4000
windows of 48×48 f32 (36.9 MB) and reads the padded levels once. See the
note at the head of the CUDA source for what the simple design does.
"""
from __future__ import annotations

import ctypes

import torch

MAX_SIZE = 64

# launches of the CUDA kernel, counted where it is launched
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ..utils import build

        lib = build.load_library("patch_gather", ["patch_gather.cu"])
        fn = lib.patch_gather_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def clamp_starts(padded, ys, xs, size: int):
    Hp, Wp = padded.shape
    return ys.clamp(0, Hp - size), xs.clamp(0, Wp - size)


def gather_patches_plain(padded, ys, xs, size: int):
    """(Hp,Wp), (K,) int top-left starts -> (K,size,size): the kernel's
    addressing written out as one advanced-indexing gather."""
    ys, xs = clamp_starts(padded, ys.long(), xs.long(), size)
    ar = torch.arange(size, device=padded.device)
    rows = ys[:, None, None] + ar[None, :, None]
    cols = xs[:, None, None] + ar[None, None, :]
    return padded[rows, cols]


def gather_patches(padded, ys, xs, size: int):
    """(Hp,Wp) f32 edge-padded level, (K,) int32 top-left starts ->
    (K,size,size) f32. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    global LAUNCHES
    if padded.device.type == "cpu":
        return gather_patches_plain(padded, ys, xs, size)
    if padded.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {padded.device}")
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise ValueError("gather_patches: image must be a 2-D float32 tensor")
    if ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise ValueError("gather_patches: ys and xs must be int32")
    if ys.dim() != 1 or ys.shape != xs.shape:
        raise ValueError("gather_patches: ys and xs must be equal-length 1-D")
    if ys.device != padded.device or xs.device != padded.device:
        raise ValueError("gather_patches: all tensors must be on one device")
    if not (padded.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("gather_patches: inputs must be contiguous")
    Hp, Wp = padded.shape
    if not 0 < size <= MAX_SIZE or Hp < size or Wp < size:
        raise ValueError(f"gather_patches: size {size} does not fit "
                         f"1..{MAX_SIZE} and the image {Hp}x{Wp}")
    K = ys.shape[0]
    out = torch.empty((K, size, size), dtype=torch.float32,
                      device=padded.device)
    if K == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = fn(padded.data_ptr(), Hp, Wp, ys.data_ptr(), xs.data_ptr(), K,
                 size, out.data_ptr(), stream)
    LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"patch_gather kernel launch failed: CUDA error {err}")
    return out
