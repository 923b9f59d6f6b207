"""ORB detection on the card: the levels, FAST, suppression, per-cell top-k,
sub-pixel fit and pick of one extraction, from one C call.

`detect` launches the hand-written CUDA kernels of `csrc/orb_detect.cu`
(one launch a pyramid level and one for the pick of every level) and
returns what `orb.detect_levels_plain` returns, bit for bit. `Plan` holds
what does not change from one call to the next at one image size and
configuration: the level table, the resize taps on the device, and the
limits the kernels take, checked once when the plan is made. `orb.py` makes
the plans and takes the plain version for CPU tensors; there is no fallback
from the one to the other.

The kernels replace no Pallas kernel: the JAX package's detection is XLA
code. What bounds them is latency, not bytes or operations; see the note at
the head of the CUDA source.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build

MAX_LEVELS = 16
MAX_CELL = 32
MAX_PER_CELL = 8
MAX_CANDIDATES = 16384   # a level's cells × per_cell: the pick's sort


class _Level(ctypes.Structure):
    """`OrbLevel` of csrc/orb_detect.cuh."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "H", "W", "ncx", "ncy", "k", "out_begin", "cand_begin",
        "padded_begin", "row_taps", "col_taps", "mask_row_taps",
        "mask_col_taps")] + [("scale", ctypes.c_float)]


class _Args(ctypes.Structure):
    """`OrbDetectArgs` of csrc/orb_detect.cuh."""
    _fields_ = [("level", _Level * MAX_LEVELS)] + \
        [(name, ctypes.c_void_p) for name in (
            "img", "mask", "taps", "padded", "cand", "yx", "xy", "response",
            "octave", "valid")] + \
        [(name, ctypes.c_int) for name in (
            "W0", "Wm", "n_levels", "cell", "per_cell", "pad", "edge",
            "n_cand", "k_total", "capacity", "pick_keys")] + \
        [("threshold", ctypes.c_float)]


# the library's name, sources and headers in csrc/, for utils/build.py
LIBRARY = ("orb_detect", ["orb_detect.cu"], ["orb_detect.cuh"])
# one C call launches every level's kernel and the pick
DETECT = build.EntryPoint(LIBRARY, "orb_detect_levels_f32",
                          (ctypes.POINTER(_Args),))


class Plan:
    """One extraction's fixed layout at an image size and configuration.

    `sizes`: (h, w) a level; `slots`: output slots a level (its budget, at
    least 1); `scales`: a level's scale (rounded to float32 by the kernel's
    table); `taps`: a level's (rows, columns, mask rows, mask columns)
    resize taps as `orb._resize_taps_np` gives them, None where there are
    none; `mask_shape`: the mask's (Hm, Wm) or None. Raises ValueError on
    anything the kernels do not take."""

    def __init__(self, image_shape, sizes, slots, scales, cell: int,
                 per_cell: int, threshold: float, edge: int, pad: int,
                 capacity: int, taps, mask_shape, device):
        n = len(sizes)
        if not 1 <= n <= MAX_LEVELS:
            raise ValueError(f"detect: {n} levels, the kernel takes "
                             f"1..{MAX_LEVELS}")
        if not 1 <= cell <= MAX_CELL:
            raise ValueError(f"detect: cell {cell} not in 1..{MAX_CELL}")
        if not 1 <= per_cell <= min(MAX_PER_CELL, cell * cell):
            raise ValueError(f"detect: per_cell {per_cell} not in "
                             f"1..{min(MAX_PER_CELL, cell * cell)}")
        if min(min(s) for s in sizes) < 1:
            raise ValueError(f"detect: an empty level in {sizes}")
        self.image_shape = tuple(image_shape)
        self.mask_shape = None if mask_shape is None else tuple(mask_shape)
        self.sizes = list(sizes)
        self.slots = list(slots)
        self.pad = pad
        self.capacity = capacity
        self.device = device
        table, words = [], 0

        def put(t) -> int:
            nonlocal words
            if t is None:
                return -1
            i0, i1, w0, w1 = t
            block = np.concatenate([i0.astype(np.int32), i1.astype(np.int32),
                                    w0.astype(np.float32).view(np.int32),
                                    w1.astype(np.float32).view(np.int32)])
            table.append(block)
            words += block.size
            return words - block.size

        tmpl = _Args()
        out = cand = padded = 0
        self.padded_shapes = []
        keys = 1
        for lv, (h, w), k, s, t in zip(tmpl.level, sizes, slots, scales,
                                       taps):
            ncy, ncx = -(-h // cell), -(-w // cell)
            n_cand = ncy * ncx * per_cell
            if n_cand > MAX_CANDIDATES:
                raise ValueError(f"detect: a {h}x{w} level has {n_cand} "
                                 f"candidates, the pick takes at most "
                                 f"{MAX_CANDIDATES}")
            if k > n_cand:
                raise ValueError(f"detect: {k} slots for a {h}x{w} level of "
                                 f"{n_cand} candidates")
            while keys < n_cand:
                keys *= 2
            lv.H, lv.W, lv.ncx, lv.ncy, lv.k = h, w, ncx, ncy, k
            lv.out_begin, lv.cand_begin, lv.padded_begin = out, cand, padded
            lv.row_taps, lv.col_taps, lv.mask_row_taps, lv.mask_col_taps = \
                map(put, t)
            lv.scale = float(np.float32(s))
            self.padded_shapes.append((h + 2 * pad, w + 2 * pad))
            out += k
            cand += n_cand
            padded += (h + 2 * pad) * (w + 2 * pad)
        if out > capacity:
            raise ValueError(f"detect: {out} slots exceed the capacity "
                             f"{capacity}")
        self.k_total, self.n_cand, self.n_padded = out, cand, padded
        self.taps = (torch.from_numpy(np.concatenate(table)).to(device)
                     if table else torch.zeros(1, dtype=torch.int32,
                                               device=device))
        tmpl.taps = self.taps.data_ptr()
        tmpl.W0 = image_shape[1]
        tmpl.Wm = 0 if mask_shape is None else mask_shape[1]
        tmpl.n_levels, tmpl.cell, tmpl.per_cell = n, cell, per_cell
        tmpl.pad, tmpl.edge, tmpl.n_cand = pad, edge, cand
        tmpl.k_total, tmpl.capacity, tmpl.pick_keys = out, capacity, keys
        tmpl.threshold = threshold
        self._template = bytes(tmpl)

    def args(self, img, mask, padded, cand, yx, xy, response, octave,
             valid) -> _Args:
        """The kernels' argument block for one call's tensors."""
        a = _Args.from_buffer_copy(self._template)
        a.img, a.padded, a.cand, a.yx = (img.data_ptr(), padded.data_ptr(),
                                         cand.data_ptr(), yx.data_ptr())
        a.xy, a.response = xy.data_ptr(), response.data_ptr()
        a.octave, a.valid = octave.data_ptr(), valid.data_ptr()
        a.mask = None if mask is None else mask.data_ptr()
        return a


def _check(name, x, shape, dev):
    """Raise on a tensor the kernels do not take: metadata only, no sync."""
    if x.device != dev:
        raise ValueError(f"detect: {name} on {x.device}, the plan on {dev}")
    if x.dtype != torch.float32:
        raise ValueError(f"detect: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"detect: {name} of shape {tuple(x.shape)}, the "
                         f"plan's is {shape}")
    if not x.is_contiguous():
        raise ValueError(f"detect: {name} must be contiguous")


def detect(img, mask, plan: Plan):
    """(H0,W0) f32 image and (Hm,Wm) f32 mask or None, contiguous, on the
    plan's CUDA device -> (padded levels, ys, xs, xy, response, octave,
    valid) as `orb.detect_levels_plain` returns them. One C call launches
    every level's kernel and the pick."""
    dev = plan.device
    if dev.type != "cuda":
        raise ValueError(f"detect: unsupported device {dev}")
    _check("img", img, plan.image_shape, dev)
    if (mask is None) != (plan.mask_shape is None):
        raise ValueError("detect: the mask does not match the plan")
    if mask is not None:
        _check("mask", mask, plan.mask_shape, dev)
    cap = plan.capacity
    padded = torch.empty(plan.n_padded, dtype=torch.float32, device=dev)
    cand = torch.empty((5, plan.n_cand), dtype=torch.int32, device=dev)
    yx = torch.empty((2, plan.k_total), dtype=torch.int32, device=dev)
    xy = torch.empty((cap, 2), dtype=torch.float32, device=dev)
    response = torch.empty(cap, dtype=torch.float32, device=dev)
    octave = torch.empty(cap, dtype=torch.int32, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    args = plan.args(img, mask, padded, cand, yx, xy, response, octave, valid)
    build.launch(DETECT, dev, ctypes.byref(args))
    levels = [p.view(shape) for p, shape in zip(
        padded.split([h * w for h, w in plan.padded_shapes]),
        plan.padded_shapes)]
    return levels, yx[0], yx[1], xy, response, octave, valid
