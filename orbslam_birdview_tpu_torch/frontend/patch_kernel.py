"""Patch gather: per-keypoint square windows out of the pyramid levels.

`gather_patches_levels` cuts the windows of all levels of one extraction
and returns them concatenated, level 0 first. For CUDA tensors it launches
the hand-written CUDA kernel in `csrc/patch_gather.cu`, once, and raises on
anything the kernel does not take; for CPU tensors it runs
`gather_patches_levels_plain`, the plain PyTorch version of the same
function. There is no fallback from the one to the other.
`gather_patches` is the one-level case.

The kernel replaces the JAX package's Pallas kernel
`frontend/patch_kernel.py::_window_kernel` (reached through
`gather_patches`). Contract: the output is bit-equal to slicing each
(size, size) window at its start, with starts clamped to
[0, Hp−size] × [0, Wp−size] of the window's level. That is the clamp of
`jax.lax.dynamic_slice` for starts past the far edge; for NEGATIVE starts
it is the TPU kernel's clamp to 0, which the reference's CPU path does not
share (there `vmap(dynamic_slice)` wraps −s to Hp−s first). On the
extractor's path the starts are keypoint coordinates, always ≥ 0, so the
two never meet there.

What bounds the kernel is bytes: the full-budget frame writes 4000
windows of 48×48 f32 (36.9 MB) and reads the padded levels once. See the
note at the head of the CUDA source for what the design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import build

MAX_SIZE = 64
MAX_LEVELS = 16


class _Level(ctypes.Structure):
    """`PatchLevel` of csrc/patch_gather.cu."""
    _fields_ = [("img", ctypes.c_void_p), ("ys", ctypes.c_void_p),
                ("xs", ctypes.c_void_p), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("k_begin", ctypes.c_int)]


class _LevelTable(ctypes.Structure):
    """`PatchLevelTable` of csrc/patch_gather.cu."""
    _fields_ = [("level", _Level * MAX_LEVELS), ("n_levels", ctypes.c_int),
                ("k_total", ctypes.c_int)]


# the library's name, sources and headers in csrc/, for utils/build.py
LIBRARY = ("patch_gather", ["patch_gather.cu"], [])
GATHER = build.EntryPoint(LIBRARY, "patch_gather_levels_f32", (
    ctypes.POINTER(_LevelTable), ctypes.c_int, ctypes.c_void_p))


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


def gather_patches_levels_plain(padded_levels, ys_levels, xs_levels,
                                size: int):
    """The per-level plain gathers, concatenated level 0 first."""
    return torch.cat([gather_patches_plain(p, ys, xs, size) for p, ys, xs
                      in zip(padded_levels, ys_levels, xs_levels)], 0)


def _level_table(padded_levels, ys_levels, xs_levels, size: int, dev):
    """Check every tensor against what the kernel takes (no device sync:
    only metadata is read) and fill the kernel's level table."""
    table = _LevelTable()
    k = 0
    for lv, padded, ys, xs in zip(table.level, padded_levels, ys_levels,
                                  xs_levels):
        if padded.dtype != torch.float32 or padded.dim() != 2:
            raise ValueError("gather_patches: a level must be a 2-D float32 "
                             "tensor")
        if ys.dtype != torch.int32 or xs.dtype != torch.int32:
            raise ValueError("gather_patches: ys and xs must be int32")
        if ys.dim() != 1 or ys.shape != xs.shape:
            raise ValueError("gather_patches: ys and xs must be equal-length "
                             "1-D")
        if not padded.device == ys.device == xs.device == dev:
            raise ValueError("gather_patches: all tensors must be on one "
                             "device")
        if not (padded.is_contiguous() and ys.is_contiguous()
                and xs.is_contiguous()):
            raise ValueError("gather_patches: inputs must be contiguous")
        Hp, Wp = padded.shape
        if Hp < size or Wp < size:
            raise ValueError(f"gather_patches: size {size} does not fit the "
                             f"level {Hp}x{Wp}")
        lv.img, lv.ys, lv.xs = padded.data_ptr(), ys.data_ptr(), xs.data_ptr()
        lv.H, lv.W, lv.k_begin = Hp, Wp, k
        k += ys.shape[0]
    table.n_levels = len(padded_levels)
    table.k_total = k
    return table


def gather_patches_levels(padded_levels, ys_levels, xs_levels, size: int):
    """Lists, one entry per pyramid level, of (Hp,Wp) f32 edge-padded
    images and (K_l,) int32 top-left starts -> (ΣK_l, size, size) f32, the
    levels' patches in list order. CUDA tensors launch the kernel once for
    all levels; CPU tensors take the plain version. A size that is not a
    multiple of 4 runs the kernel's scalar path (its float4 stores need
    every patch to start on a 16-byte boundary)."""
    n = len(padded_levels)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"gather_patches: {n} levels, the kernel takes "
                         f"1..{MAX_LEVELS}")
    if len(ys_levels) != n or len(xs_levels) != n:
        raise ValueError("gather_patches: one ys and one xs per level")
    dev = padded_levels[0].device
    if dev.type == "cpu":
        return gather_patches_levels_plain(padded_levels, ys_levels,
                                           xs_levels, size)
    if dev.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {dev}")
    if not 0 < size <= MAX_SIZE:
        raise ValueError(f"gather_patches: size {size} not in 1..{MAX_SIZE}")
    table = _level_table(padded_levels, ys_levels, xs_levels, size, dev)
    out = torch.empty((table.k_total, size, size), dtype=torch.float32,
                      device=dev)
    if table.k_total == 0:
        return out
    build.launch(GATHER, dev, ctypes.byref(table), size, out.data_ptr())
    return out


def gather_patches(padded, ys, xs, size: int):
    """(Hp,Wp) f32 edge-padded level, (K,) int32 top-left starts ->
    (K,size,size) f32: `gather_patches_levels` for one level."""
    return gather_patches_levels([padded], [ys], [xs], size)
