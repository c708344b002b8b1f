"""Seeded randomized (property-style) tests.

The reference has no property/fuzz testing (SURVEY §4); these sweeps pin
down invariants across random shapes/sparsity/dtypes: IO round-trips are
exact, SpMV agrees across all storage formats, solver results satisfy
their defining residuals, and QR modes agree with numpy oracles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _seeds(n, fast=2):
    """First ``fast`` seeds run by default; the rest are marked slow."""
    return [pytest.param(i, marks=[] if i < fast else [pytest.mark.slow])
            for i in range(n)]

from pcsc_eigenvalue_solver_project_tpu import (
    DenseMatrix, QROptions, SolverOptions, SparseCSR, power_method,
    qr_eigenvalues, read_matrix_from_file, solve_shifted, write_matrix_to_file)
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
from tests.test_qr import spectrum_distance


@pytest.mark.parametrize("seed", _seeds(8))
def test_io_roundtrip_random(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n, m = rng.integers(1, 12, 2)
    if seed % 2:
        a = rng.standard_normal((n, m)) * 10.0 ** float(rng.integers(-8, 8))
        src = DenseMatrix.from_array(a)
    else:
        density = rng.uniform(0.1, 0.9)
        a = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
        if not a.any():
            a[0, 0] = 1.0
        src = SparseCSR.from_dense(a)
    p = str(tmp_path / f"m{seed}.txt")
    write_matrix_to_file(p, src)
    back = read_matrix_from_file(p, np.float64)
    np.testing.assert_array_equal(np.asarray(back.to_dense()),
                                  np.asarray(src.to_dense()))


@pytest.mark.parametrize("seed", _seeds(6))
def test_formats_agree_on_matvec(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(4, 40))
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.4)
    a[np.arange(n), np.arange(n)] += 1.0
    x = rng.standard_normal(n)
    dense = DenseMatrix.from_array(a)
    csr = SparseCSR.from_dense(a)
    ell = csr.to_ell()
    dia = SparseDIA.from_csr(csr)
    ref = a @ x
    for m in (dense, csr, ell, dia):
        np.testing.assert_allclose(np.asarray(m.matvec(jnp.asarray(x))), ref,
                                   rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("seed", _seeds(5))
def test_power_satisfies_eigen_residual(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(3, 20))
    a = rng.standard_normal((n, n))
    a = a + a.T + n * np.eye(n)  # symmetric, dominant eig separated-ish
    res = power_method(DenseMatrix.from_array(a),
                       SolverOptions(tolerance=1e-12, max_iterations=50000),
                       key=jax.random.key(seed))
    if bool(res.converged):
        lam = complex(res.eigenvalue).real
        v = np.asarray(res.eigenvector)
        assert np.linalg.norm(a @ v - lam * v) < 1e-4 * max(abs(lam), 1)


@pytest.mark.parametrize("seed", _seeds(5))
def test_solve_shifted_residual(seed):
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(2, 30))
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    shift = float(rng.standard_normal())
    x = np.asarray(solve_shifted(DenseMatrix.from_array(a), shift, b))
    assert np.linalg.norm((a - shift * np.eye(n)) @ x - b) < 1e-8


@pytest.mark.parametrize("seed", _seeds(4))
def test_qr_modes_agree(seed):
    rng = np.random.default_rng(400 + seed)
    n = int(rng.integers(3, 12))
    a = rng.standard_normal((n, n))
    exact = np.linalg.eigvals(a)
    acc = qr_eigenvalues(DenseMatrix.from_array(a),
                         QROptions(mode="accelerated", tolerance=1e-12,
                                   max_iterations=5000))
    assert spectrum_distance(np.asarray(acc.eigenvalues), exact) < 1e-7


@pytest.mark.parametrize("seed", _seeds(6))
def test_interleaved_matvec_agrees_with_xla(seed):
    """Random band structure / size / row alignment: the interleaved SpMV
    == a float64 NumPy evaluation of the band."""
    from pcsc_eigenvalue_solver_project_tpu.ops.dia import (
        deinterleave_vec, dia_matvec_il, il_rows, interleave_dia_vals,
        interleave_vec)
    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(1500, 40000))
    n_off = int(rng.integers(1, 9))
    offsets = tuple(sorted(rng.choice(np.arange(-150, 151), size=n_off,
                                      replace=False).tolist()))
    tile_s = int(rng.choice([8, 16, 64]))
    k = len(offsets)
    vals = np.zeros((k, n), np.float32)
    for d, off in enumerate(offsets):
        vals[d] = rng.standard_normal(n)
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    x = rng.standard_normal(n).astype(np.float32)
    y_ref = np.zeros(n)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        y_ref[lo:hi] += vals[d, lo:hi].astype(np.float64) * x[lo + off:hi + off]
    R = il_rows(n, tile_s)
    y = np.asarray(deinterleave_vec(
        dia_matvec_il(interleave_dia_vals(jnp.asarray(vals), R), offsets,
                      interleave_vec(jnp.asarray(x), R)), n))
    scale = max(np.max(np.abs(y_ref)), 1e-6)
    np.testing.assert_allclose(y / scale, y_ref / scale, atol=2e-6)


@pytest.mark.parametrize("seed", _seeds(4))
def test_splitc_bicgstab_residual_on_dominant_systems(seed):
    """Random diagonally-dominant complex banded system: the plane
    BiCGStab must reach the requested residual."""
    from pcsc_eigenvalue_solver_project_tpu.matrix.split_complex import (
        SplitComplexDIA)
    from pcsc_eigenvalue_solver_project_tpu.ops.split_complex import from_planes
    from pcsc_eigenvalue_solver_project_tpu.ops.split_krylov import (
        solve_shifted_splitc)
    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(100, 800))
    offsets = (-2, -1, 0, 1, 2)
    planes = np.zeros((2, 5, n))
    for d, off in enumerate(offsets):
        planes[0, d] = 0.2 * rng.standard_normal(n)
        planes[1, d] = 0.2 * rng.standard_normal(n)
        if off > 0:
            planes[:, d, n - off:] = 0
        elif off < 0:
            planes[:, d, :-off] = 0
    planes[0, 2] += 4.0
    sc = SplitComplexDIA(planes=jnp.asarray(planes), offsets=offsets,
                         shape=(n, n))
    b = rng.standard_normal((2, n))
    sh = complex(rng.uniform(-1, 1), rng.uniform(-1, 1))
    y = solve_shifted_splitc(sc.matvec, jnp.asarray([sh.real, sh.imag]),
                             jnp.asarray(b), diag=sc.diagonal_planes(),
                             tol=1e-11, maxiter=600)
    A = sc.to_complex_dense() - sh * np.eye(n)
    bc = b[0] + 1j * b[1]
    res = np.linalg.norm(A @ from_planes(np.asarray(y)) - bc) / np.linalg.norm(bc)
    assert res < 1e-8, res
