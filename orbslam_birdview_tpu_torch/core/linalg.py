"""Small dense linear algebra.

The reference's `f32_matmul` scope has no counterpart here: the package
turns TF32 off for every matmul when it is imported (see `__init__.py`).

`svd_small` and `eigh_small` decompose the solvers' small matrices (at
most 12 columns, batched over the RANSAC hypotheses). For CUDA tensors they
launch the hand-written kernels of `csrc/small_linalg.cu` (a one-sided
Jacobi SVD and a cyclic Jacobi eigh, a lane group of a warp per matrix;
the per-matrix routines are `csrc/small_linalg.cuh`), once per call, with
no host sync and no cuSOLVER, and raise on anything the kernels do not
take; for CPU tensors they run the plain versions, `torch.linalg.svd` /
`eigh` behind `finite_or` / `poison`. There is no fallback from the one to
the other. Both give NaN in every output of a matrix with a non-finite
entry, as the JAX package's `jnp.linalg.svd` / `eigh` do, where torch's
would refuse it.

`det_small` is the 2×2 / 3×3 determinant of `twoview.py` and `icp.py`:
`torch.linalg.det` for CPU tensors, a closed form for CUDA tensors (the
library's first call in a process costs about a second on the card, on
the first map's path). `epnp.py` and `pnp.py` call the closed form,
`det_closed`, on both devices. Each solver keeps on the CPU the
determinant with which its results were first held against the JAX
package, so those CPU results stay bit for bit as they were.

Singular and eigenvectors are defined up to sign, and inside a repeated
value only as a subspace; the kernels and the libraries choose
differently, and every caller is invariant to that choice. Compare
values, reconstructions and projectors, never columns.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils import build

MAX_N = 12      # columns
MAX_M = 16      # rows for which the SVD gives U; taller ones give S and Vh
MAX_TALL_M = 64  # rows the SVD takes without U


def solve_psd_small(A, b, eps: float = 1e-12):
    """Solve A x = b for symmetric positive-(semi)definite A of small static
    size n, batched over leading dimensions: an unrolled Cholesky with the
    pivots clamped to `eps`, then two triangular solves. No pivoting, no
    host sync, and the same operation order as the reference."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def finite_or(x, fill):
    """(x with every non-finite matrix of the batch replaced by `fill`, the
    mask of the finite ones). torch's `svd` / `eigh` refuse non-finite
    input where the reference's return NaN; `poison` puts the NaN back."""
    ok = torch.isfinite(x).all(-1).all(-1)
    return torch.where(ok[..., None, None], x, fill), ok


def poison(x, ok):
    """x where ok, NaN elsewhere (ok over x's batch dimensions)."""
    while ok.dim() < x.dim():
        ok = ok[..., None]
    return torch.where(ok, x, torch.nan)


def svd_small_plain(A, full_matrices: bool = False):
    """`torch.linalg.svd` with NaN for a non-finite matrix and U None for
    more than MAX_M rows, as `svd_small`."""
    A, ok = finite_or(A, 0.0)
    U, S, Vh = torch.linalg.svd(A, full_matrices=full_matrices)
    U = poison(U, ok) if A.shape[-2] <= MAX_M else None
    return U, poison(S, ok), poison(Vh, ok)


def eigh_small_plain(S):
    """`torch.linalg.eigh` with NaN for a non-finite matrix."""
    S, ok = finite_or(S, 0.0)
    w, V = torch.linalg.eigh(S)
    return poison(w, ok), poison(V, ok)


# the library's name, sources and headers in csrc/, for utils/build.py
LIBRARY = ("small_linalg", ["small_linalg.cu"], ["small_linalg.cuh"])
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
SVD = build.EntryPoint(LIBRARY, "jacobi_svd_f32",
                       (_PTR, _I32, _I32, _I32, _PTR, _PTR, _PTR))
EIGH = build.EntryPoint(LIBRARY, "jacobi_eigh_f32",
                        (_PTR, _I32, _I32, _PTR, _PTR))
# an empty kernel of one block: the launch floor for timing
EMPTY = build.EntryPoint(LIBRARY, "small_linalg_empty", ())


def _check(name, X):
    """Raise on what the kernels do not take (metadata only: no sync)."""
    if X.dtype != torch.float32:
        raise ValueError(f"{name}: float32 only, got {X.dtype}")
    if X.dim() < 2:
        raise ValueError(f"{name}: needs (…, m, n), got {tuple(X.shape)}")
    m, n = X.shape[-2:]
    if not (1 <= m <= MAX_TALL_M and 1 <= n <= MAX_N):
        raise ValueError(f"{name}: {m}x{n} matrices, the kernel takes at "
                         f"most {MAX_N} columns and {MAX_TALL_M} rows")
    if not X.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {X.device}")


def svd_launch(A):
    """Launch `jacobi_svd_f32` on the contiguous CUDA batch A (B,m,n), B ≥ 1:
    U (B,m,m) (None for m > MAX_M), S (B,min(m,n)) descending, Vh
    (B,n,n)."""
    B, m, n = A.shape
    dev = A.device
    S = torch.empty((B, min(m, n)), dtype=A.dtype, device=dev)
    U = (torch.empty((B, m, m), dtype=A.dtype, device=dev)
         if m <= MAX_M else None)
    Vh = torch.empty((B, n, n), dtype=A.dtype, device=dev)
    build.launch(SVD, dev, A.data_ptr(), B, m, n, S.data_ptr(),
                 None if U is None else U.data_ptr(), Vh.data_ptr())
    return U, S, Vh


def eigh_launch(S):
    """Launch `jacobi_eigh_f32` on the contiguous CUDA batch S (B,n,n),
    B ≥ 1: w (B,n) ascending, V (B,n,n) with the eigenvectors in its
    columns."""
    B, n, _ = S.shape
    dev = S.device
    w = torch.empty((B, n), dtype=S.dtype, device=dev)
    V = torch.empty((B, n, n), dtype=S.dtype, device=dev)
    build.launch(EIGH, dev, S.data_ptr(), B, n, w.data_ptr(), V.data_ptr())
    return w, V


def svd_small(A, full_matrices: bool = False):
    """SVD of (…,m,n) f32 matrices, n ≤ 12, m ≤ MAX_TALL_M, as
    `torch.linalg.svd`: (U, S, Vh) with S descending; U is None for more
    than MAX_M rows (the kernel keeps no U there). CUDA tensors launch
    `jacobi_svd_f32` once; CPU tensors take the plain version."""
    _check("svd_small", A)
    if A.device.type == "cpu":
        return svd_small_plain(A, full_matrices)
    *batch, m, n = A.shape
    k = min(m, n)
    B = math.prod(batch)
    if B == 0:
        U = A.new_empty((*batch, m, m if full_matrices else k))
        return (U if m <= MAX_M else None, A.new_empty((*batch, k)),
                A.new_empty((*batch, n if full_matrices else k, n)))
    U, S, Vh = svd_launch(A.reshape(B, m, n))
    S = S.reshape(*batch, k)
    Vh = Vh.reshape(*batch, n, n)
    if U is not None:
        U = U.reshape(*batch, m, m)
    if not full_matrices:
        Vh = Vh[..., :k, :]
        U = None if U is None else U[..., :, :k]
    return U, S, Vh


def eigh_small(S):
    """Eigen-decomposition of symmetric (…,n,n) f32 matrices, n ≤ 12, as
    `torch.linalg.eigh` (lower triangle read): (w ascending, V with the
    eigenvectors in its columns). CUDA tensors launch `jacobi_eigh_f32`
    once; CPU tensors take the plain version."""
    _check("eigh_small", S)
    *batch, m, n = S.shape
    if m != n:
        raise ValueError(f"eigh_small: square matrices only, got {m}x{n}")
    if S.device.type == "cpu":
        return eigh_small_plain(S)
    B = math.prod(batch)
    if B == 0:
        return S.new_empty((*batch, n)), S.new_empty((*batch, n, n))
    w, V = eigh_launch(S.reshape(B, n, n))
    return w.reshape(*batch, n), V.reshape(*batch, n, n)


def det_closed(X):
    """The determinant of (…,2,2) or (…,3,3) matrices in closed form (the
    3×3 one by the first row's cofactors): elementwise, no library call,
    no host sync."""
    if X.shape[-1] == 2:
        return X[..., 0, 0] * X[..., 1, 1] - X[..., 0, 1] * X[..., 1, 0]
    return (X[..., 0, 0] * (X[..., 1, 1] * X[..., 2, 2]
                            - X[..., 1, 2] * X[..., 2, 1])
            - X[..., 0, 1] * (X[..., 1, 0] * X[..., 2, 2]
                              - X[..., 1, 2] * X[..., 2, 0])
            + X[..., 0, 2] * (X[..., 1, 0] * X[..., 2, 1]
                              - X[..., 1, 1] * X[..., 2, 0]))


def det_small(X):
    """Determinant of (…,n,n) matrices, n ∈ {2, 3}: `torch.linalg.det` for
    CPU tensors, so the CPU results are the library's; `det_closed` for
    CUDA tensors. The solvers take only its sign, or multiply by ±1.
    `epnp.py` and `pnp.py` call `det_closed` directly, on both devices
    (see the module's docstring)."""
    if X.dim() < 2 or X.shape[-1] != X.shape[-2] or X.shape[-1] not in (2, 3):
        raise ValueError(f"det_small: 2×2 or 3×3 matrices, got "
                         f"{tuple(X.shape)}")
    if X.device.type == "cpu":
        return torch.linalg.det(X)
    return det_closed(X)
