"""The solvers' small SVD and eigh (`core/linalg.py`) against JAX.

At every decomposition site of the solvers, at the shape it sees on its
path (`small_linalg_cases.SVD_SITES` / `EIGH_SITES`), with rank-deficient
E, F and Kabsch matrices, repeated eigenvalues and batch entries with NaN
or ±inf:
- the port's wrappers on CPU tensors (their plain versions,
  `torch.linalg.svd` / `eigh` behind `finite_or` / `poison`) against
  `jnp.linalg.svd` / `eigh`;
- the host build of the per-matrix Jacobi routines that the CUDA kernels
  run (`csrc/small_linalg.cuh` through `csrc/small_linalg_host.cpp`,
  compiled with the host C++ compiler at first use) against the same,
  so the kernels' algorithm is tested where there is no card.
Values, reconstructions, orthogonality and cluster projectors are held to
the tolerances stated in `small_linalg_cases`; NaN must come out in
exactly the entries whose input is not finite.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu_torch.core import linalg
from orbslam_birdview_tpu_torch.utils import build

import small_linalg_cases as cases

PORT = Path(linalg.__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def host_jacobi():
    """The Jacobi routines built for the host: (svd, eigh) over numpy."""
    lib = build.load_library("small_linalg_host", ["small_linalg_host.cpp"],
                             ["small_linalg.cuh"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.jacobi_svd_f32_host.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr,
                                        ptr]
    lib.jacobi_eigh_f32_host.argtypes = [ptr, i32, i32, ptr, ptr, ptr]

    def svd(A):
        A = np.ascontiguousarray(A, np.float32)
        *batch, m, n = A.shape
        B = int(np.prod(batch))
        S = np.empty((B, min(m, n)), np.float32)
        U = np.empty((B, m, m), np.float32) if m <= linalg.MAX_M else None
        Vh = np.empty((B, n, n), np.float32)
        sweeps = np.empty(B, np.int32)
        assert lib.jacobi_svd_f32_host(
            A.ctypes.data, B, m, n, S.ctypes.data,
            None if U is None else U.ctypes.data, Vh.ctypes.data,
            sweeps.ctypes.data) == 0
        return U, S, Vh, sweeps

    def eigh(A):
        A = np.ascontiguousarray(A, np.float32)
        *batch, n, _ = A.shape
        B = int(np.prod(batch))
        w = np.empty((B, n), np.float32)
        V = np.empty((B, n, n), np.float32)
        sweeps = np.empty(B, np.int32)
        assert lib.jacobi_eigh_f32_host(A.ctypes.data, B, n, w.ctypes.data,
                                        V.ctypes.data,
                                        sweeps.ctypes.data) == 0
        return w, V, sweeps

    return svd, eigh


def _jax_svd(A, full_matrices):
    """JAX's svd; ±inf entries go in as NaN: on the CPU its LAPACK call
    does not return on an infinite entry, and it answers NaN with NaN."""
    A = np.where(np.isinf(A), np.nan, A)
    U, S, Vh = jnp.linalg.svd(jnp.asarray(A), full_matrices=full_matrices)
    return np.asarray(U), np.asarray(S), np.asarray(Vh)


def _jax_eigh(A):
    w, V = jnp.linalg.eigh(jnp.asarray(A))
    return np.asarray(w), np.asarray(V)


def _ids(sites):
    return [s.name for s in sites]


@pytest.mark.parametrize("site", cases.SVD_SITES, ids=_ids(cases.SVD_SITES))
def test_svd_small_plain_matches_jax(site):
    A = cases.make_input(site)
    U, S, Vh = linalg.svd_small(torch.from_numpy(A), site.full_matrices)
    assert S.shape[:-1] == Vh.shape[:-2] == site.batch
    assert (U is None) == (site.m > linalg.MAX_M)
    cases.check_svd(A, None if U is None else U.numpy(), S.numpy(),
                    Vh.numpy(), _jax_svd(A, site.full_matrices), site.name)


@pytest.mark.parametrize("site", cases.SVD_SITES, ids=_ids(cases.SVD_SITES))
def test_svd_host_jacobi_matches_jax(site, host_jacobi):
    A = cases.make_input(site)
    U, S, Vh, sweeps = host_jacobi[0](A)
    k = min(site.m, site.n)
    assert (U is None) == (site.m > linalg.MAX_M)
    if not site.full_matrices:
        U, Vh = U[..., :, :k], Vh[..., :k, :]
    cases.check_svd(A, U, S, Vh, _jax_svd(A, site.full_matrices), site.name)
    ok = cases.finite_entries(A)
    assert (sweeps[ok] < cases.MAX_SWEEPS).all(), "a matrix did not converge"
    assert (sweeps[~ok] == 0).all()


@pytest.mark.parametrize("site", cases.EIGH_SITES,
                         ids=_ids(cases.EIGH_SITES))
def test_eigh_small_plain_matches_jax(site):
    A = cases.make_input(site)
    w, V = linalg.eigh_small(torch.from_numpy(A))
    assert w.shape[:-1] == V.shape[:-2] == site.batch
    cases.check_eigh(A, w.numpy(), V.numpy(), _jax_eigh(A), site.name)


@pytest.mark.parametrize("site", cases.EIGH_SITES,
                         ids=_ids(cases.EIGH_SITES))
def test_eigh_host_jacobi_matches_jax(site, host_jacobi):
    A = cases.make_input(site)
    w, V, sweeps = host_jacobi[1](A)
    cases.check_eigh(A, w, V, _jax_eigh(A), site.name)
    ok = cases.finite_entries(A)
    assert (sweeps[ok] < cases.MAX_SWEEPS).all(), "a matrix did not converge"
    assert (sweeps[~ok] == 0).all()


def test_host_jacobi_completes_rank_deficient_u(host_jacobi):
    """E of rank 2 and a rank-1 Kabsch H: the completed columns of U make
    it orthogonal, with the 3×3 one's last column u₁ × u₂."""
    rng = np.random.default_rng(5)
    E = cases._essential(rng).astype(np.float32)[None]
    U, S, Vh, _ = host_jacobi[0](E)
    assert S[0, 2] <= 1e-6 * S[0, 0]
    np.testing.assert_allclose(U[0][:, 2], np.cross(U[0][:, 0], U[0][:, 1]),
                               atol=1e-6)
    H = cases._centred_cross(rng, 2, 2).astype(np.float32)[None]
    U, S, _, _ = host_jacobi[0](H)
    np.testing.assert_allclose(U[0].T @ U[0], np.eye(2), atol=1e-6)
    for Z in (np.zeros((1, 3, 3), np.float32), np.zeros((1, 4, 4),
                                                        np.float32)):
        U, S, Vh, sweeps = host_jacobi[0](Z)
        assert (S == 0).all() and sweeps[0] == 1
        np.testing.assert_array_equal(U[0], np.eye(Z.shape[-1]))


@pytest.mark.parametrize("fn", [linalg.svd_small, linalg.eigh_small],
                         ids=["svd_small", "eigh_small"])
def test_wrappers_reject_what_the_kernels_do_not_take(fn):
    """The same checks on both paths, so a CPU run finds a call site the
    kernels would refuse."""
    ok = torch.zeros((4, 3, 3))
    for bad in (ok.double(), torch.zeros(3), torch.zeros((2, 13, 13)),
                torch.zeros((2, 3, 3)).transpose(-1, -2)[:, :2]
                .transpose(-1, -2), torch.zeros((17, 12)).t()):
        with pytest.raises(ValueError):
            fn(bad)
    fn(ok)


def test_eigh_small_rejects_non_square():
    with pytest.raises(ValueError):
        linalg.eigh_small(torch.zeros((2, 3, 4)))


def test_svd_small_shapes_as_torch():
    A = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 5, 8, 9)).astype(np.float32))
    for full in (False, True):
        got = linalg.svd_small(A, full_matrices=full)
        want = torch.linalg.svd(A, full_matrices=full)
        assert [g.shape for g in got] == [w.shape for w in want]
    empty = torch.zeros((0, 3, 3))
    assert [x.shape for x in linalg.svd_small(empty)] == [(0, 3, 3), (0, 3),
                                                          (0, 3, 3)]


def test_no_module_calls_the_library_decompositions():
    """Outside the plain versions in core/linalg.py, no module of the port
    calls torch.linalg's svd / eigh, so a CUDA tensor can only reach the
    kernels."""
    pattern = re.compile(r"torch\.linalg\.(svd|svdvals|eigh|eigvalsh)\(")
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                found.append(f"{path.relative_to(PORT)}:{i}")
    assert found and all(f.startswith("core/linalg.py:") for f in found), \
        found


def test_host_jacobi_null_space_of_rank_deficient_dlt(host_jacobi):
    """8×9 DLT systems with repeated correspondences (rank 7 or 6): the
    last 9 − rank rows of Vh span A's null space, as JAX's do, and the
    completed columns of U make it orthogonal."""
    site = next(s for s in cases.SVD_SITES
                if s.name == "twoview_null_F_rank_deficient")
    A = cases.make_input(site)
    U, S, Vh, sweeps = host_jacobi[0](A)
    _, _, Vh_ref = _jax_svd(A, True)
    for b in range(len(A)):
        null = 2 + b % 2
        scale = float(S[b, 0])
        N = Vh[b, -null:].astype(np.float64)
        assert np.abs(A[b] @ N.T).max() <= cases.VALUE_TOL * scale
        P_ref = Vh_ref[b, -null:].T @ Vh_ref[b, -null:]
        assert np.abs(N.T @ N - P_ref).max() <= 1e-4
        assert S[b, 8 - null + 1:].max() <= 1e-6 * scale
        np.testing.assert_allclose(U[b].T @ U[b], np.eye(8), atol=1e-5)
    assert (sweeps < cases.MAX_SWEEPS).all()


@pytest.mark.parametrize("m", [16, 17, 31, 32, 33, 48, 63, 64])
def test_host_jacobi_group_boundaries(m, host_jacobi):
    """At each change of the kernel's group (16 lanes up to 16 rows, then
    32 lanes of 2 rows, lane i holding rows i and i + 32) the values and
    V are the library's."""
    A = np.random.default_rng(m).standard_normal((2, m, 12)) \
        .astype(np.float32)
    U, S, Vh, sweeps = host_jacobi[0](A)
    assert (U is None) == (m > linalg.MAX_M)
    cases.check_svd(A, U, S, Vh, _jax_svd(A, True), f"{m}x12")
    assert (sweeps < cases.MAX_SWEEPS).all()


def test_svd_small_rejects_more_rows_than_the_kernel_takes(host_jacobi):
    A = torch.zeros((2, linalg.MAX_TALL_M + 1, 12))
    with pytest.raises(ValueError):
        linalg.svd_small(A)
    linalg.svd_small(A[:, :-1].contiguous())
    with pytest.raises(AssertionError):
        host_jacobi[0](A.numpy())


def test_det_closed_agrees_in_sign_with_the_library():
    """The closed form that CUDA tensors take gives the library's sign on
    every matrix of the solvers' det sites (both signs occur)."""
    signs = set()
    for name, X in cases.det_inputs().items():
        X = torch.from_numpy(X)
        want = torch.sign(torch.linalg.det(X))
        got = torch.sign(linalg.det_closed(X))
        assert torch.equal(got, want), name
        torch.testing.assert_close(linalg.det_closed(X), torch.linalg.det(X),
                                   atol=1e-5, rtol=0)
        signs.update(want.tolist())
    assert signs == {-1.0, 1.0}


def test_det_small_is_the_library_on_the_cpu():
    """On CPU tensors det_small is torch.linalg.det, bit for bit, so every
    CPU result of the solvers stays as it was."""
    rng = np.random.default_rng(3)
    for n in (2, 3):
        X = torch.from_numpy(rng.standard_normal((64, n, n))
                             .astype(np.float32))
        assert torch.equal(linalg.det_small(X), torch.linalg.det(X))
    for bad in (torch.zeros((2, 4, 4)), torch.zeros((2, 3, 2)),
                torch.zeros(3)):
        with pytest.raises(ValueError):
            linalg.det_small(bad)


def test_no_module_calls_the_library_det():
    """Outside core/linalg.py no module of the port calls
    torch.linalg.det, so a CUDA tensor takes the closed form."""
    pattern = re.compile(r"torch\.linalg\.det\(")
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                found.append(f"{path.relative_to(PORT)}:{i}")
    assert found and all(f.startswith("core/linalg.py:") for f in found), \
        found
