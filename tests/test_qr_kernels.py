"""Dense QR stack (solvers/hessenberg.py, qr.py, qr_eigenvalues.py) at
small sizes, against NumPy oracles.

Oracles: a host Householder Hessenberg reduction written here in NumPy
(to_hessenberg.hpp:23-80 semantics) and ``numpy.linalg.eigvals`` with
assignment matching (conjugate-pair ordering is not stable across
implementations).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import pcsc_eigenvalue_solver_project_tpu as es
from pcsc_eigenvalue_solver_project_tpu.solvers.hessenberg import (
    hessenberg_dense)
from pcsc_eigenvalue_solver_project_tpu.solvers.qr_eigenvalues import (
    _qr_eigenvalues_accel, triangular_eigenvectors)


def _match_err(expected, got):
    from scipy.optimize import linear_sum_assignment
    C = np.abs(np.asarray(expected)[:, None] - np.asarray(got)[None, :])
    r, c = linear_sum_assignment(C)
    return C[r, c].max() / max(np.abs(expected).max(), 1.0)


def hessenberg_numpy(a):
    """Host Householder reduction, the reference's algorithm in NumPy."""
    H = np.array(a)
    n = H.shape[0]
    for k in range(n - 2):
        x = H[k + 1:, k].copy()
        if np.linalg.norm(x[1:]) == 0:
            continue
        x0 = x[0]
        sign = x0 / abs(x0) if x0 != 0 else 1.0
        v = x
        v[0] += sign * np.linalg.norm(x)
        vn = np.linalg.norm(v)
        if vn == 0:
            continue
        v = v / vn
        H[k + 1:, k:] -= 2.0 * np.outer(v, np.conj(v) @ H[k + 1:, k:])
        H[:, k + 1:] -= 2.0 * np.outer(H[:, k + 1:] @ v, np.conj(v))
    return H


def _accel(a, tol=1e-6, max_it=None, **kw):
    n = a.shape[0]
    return es.qr_eigenvalues(
        es.DenseMatrix.from_array(a),
        es.QROptions(mode="accelerated", tolerance=tol,
                     max_iterations=max_it or 60 * max(n, 1), **kw))


class TestHessenbergKernel:
    @pytest.mark.parametrize("n", [2, 5, 16, 33])
    def test_matches_xla_real(self, n):
        rng = np.random.default_rng(n)
        a = rng.standard_normal((n, n)).astype(np.float32)
        ref = hessenberg_numpy(a.astype(np.float64))
        got = np.asarray(hessenberg_dense(jnp.asarray(a)))
        np.testing.assert_allclose(got, ref, atol=5e-5 * max(n, 1))

    @pytest.mark.parametrize("n", [5, 16])
    def test_matches_xla_complex(self, n):
        rng = np.random.default_rng(n)
        a = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))).astype(np.complex64)
        ref = hessenberg_numpy(a.astype(np.complex128))
        got = np.asarray(hessenberg_dense(jnp.asarray(a)))
        np.testing.assert_allclose(got, ref, atol=5e-5 * max(n, 1))

    def test_backend_helper_roundtrip(self):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((9, 9)).astype(np.float32)
        h = np.asarray(es.to_hessenberg(es.DenseMatrix.from_array(a)))
        assert h.dtype == np.float32
        assert np.abs(np.tril(h, -2)).max() < 1e-5
        err = _match_err(np.linalg.eigvals(a.astype(np.complex128)),
                         np.linalg.eigvals(h.astype(np.complex128)))
        assert err < 1e-5

    def test_skips_already_hessenberg(self):
        # an already-Hessenberg matrix passes through unchanged (the
        # tail-zero skip, to_hessenberg.hpp:46-48)
        rng = np.random.default_rng(1)
        a = np.triu(rng.standard_normal((8, 8)), -1).astype(np.float32)
        got = np.asarray(hessenberg_dense(jnp.asarray(a)))
        np.testing.assert_allclose(got, a, atol=1e-6)


class TestQREigKernel:
    @pytest.mark.parametrize("n", [2, 5, 16])
    def test_real_spectrum(self, n):
        rng = np.random.default_rng(n)
        a = rng.standard_normal((n, n)).astype(np.float32)
        r = _accel(a)
        assert bool(r.converged)
        assert _match_err(np.linalg.eigvals(a.astype(np.complex128)),
                          np.asarray(r.eigenvalues)) < 5e-5

    @pytest.mark.parametrize("n", [5, 16])
    def test_complex_spectrum(self, n):
        rng = np.random.default_rng(100 + n)
        a = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))).astype(np.complex64)
        r = _accel(a)
        assert bool(r.converged)
        assert _match_err(np.linalg.eigvals(a.astype(np.complex128)),
                          np.asarray(r.eigenvalues)) < 5e-5

    def test_symmetric_exact(self):
        # symmetric: all-real spectrum, tight agreement
        rng = np.random.default_rng(7)
        b = rng.standard_normal((12, 12)).astype(np.float32)
        a = (b + b.T) / 2
        r = _accel(a, max_it=600)
        assert bool(r.converged)
        eigs = np.asarray(r.eigenvalues)
        assert np.abs(eigs.imag).max() < 1e-4
        got = np.sort(eigs.real)
        want = np.sort(np.linalg.eigvalsh(a.astype(np.float64)))
        np.testing.assert_allclose(got, want, atol=2e-5 * 12)

    def test_hessenberg_input_direct(self):
        # feed an already-Hessenberg matrix straight to the sweep engine
        rng = np.random.default_rng(3)
        h = np.triu(rng.standard_normal((10, 10)), -1).astype(np.complex64)
        r = _qr_eigenvalues_accel(jnp.asarray(h), jnp.asarray(600),
                                  jnp.asarray(1e-6, jnp.float32))
        assert bool(r.converged)
        assert _match_err(np.linalg.eigvals(h.astype(np.complex128)),
                          np.asarray(r.eigenvalues)) < 5e-5

    def test_respects_max_sweeps(self):
        rng = np.random.default_rng(5)
        a = rng.standard_normal((8, 8)).astype(np.float32)
        r = _accel(a, tol=1e-12, max_it=2)
        assert int(r.iterations) == 2
        assert not bool(r.converged)


class TestQRDecomposeKernel:
    def test_real_qr(self):
        rng = np.random.default_rng(0)
        n = 10
        a = rng.standard_normal((n, n)).astype(np.float32)
        Q, R = es.qr_decompose(es.DenseMatrix.from_array(a))
        Q, R = np.asarray(Q), np.asarray(R)
        np.testing.assert_allclose(Q @ R, a, atol=5e-6 * n)
        np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=5e-6 * n)
        assert np.abs(np.tril(R, -1)).max() < 5e-6 * n

    def test_complex_qr(self):
        rng = np.random.default_rng(1)
        n = 8
        a = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))).astype(np.complex64)
        Q, R = es.qr_decompose(es.DenseMatrix.from_array(a))
        Qc, Rc = np.asarray(Q), np.asarray(R)
        np.testing.assert_allclose(Qc @ Rc, a, atol=5e-6 * n)
        np.testing.assert_allclose(Qc.conj().T @ Qc, np.eye(n), atol=5e-6 * n)


class TestQRParityKernel:
    def _parity(self, a, max_it, tol):
        return es.qr_eigenvalues(es.DenseMatrix.from_array(a),
                                 es.QROptions(mode="parity", tolerance=tol,
                                              max_iterations=max_it))

    def test_symmetric_converges(self):
        rng = np.random.default_rng(0)
        d = 0.8 ** np.arange(8)
        Qo, _ = np.linalg.qr(rng.standard_normal((8, 8)))
        sym = ((Qo * d) @ Qo.T).astype(np.float32)
        r = self._parity(sym, 2000, 1e-5)
        assert bool(r.converged)
        np.testing.assert_allclose(np.sort(np.asarray(r.eigenvalues).real),
                                   np.sort(d), atol=1e-4)

    def test_nonconvergence_reports_max_plus_one(self):
        # reference quirk: iterations == max_iterations + 1 on
        # non-convergence (qr_eigenvalues.hpp:69,104)
        rng = np.random.default_rng(2)
        a = rng.standard_normal((6, 6)).astype(np.float32)
        r = self._parity(a, 3, 1e-12)
        assert not bool(r.converged)
        assert int(r.iterations) == 4

    def test_complex_planes(self):
        rng = np.random.default_rng(3)
        n = 6
        a = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))).astype(np.complex64)
        r = self._parity(a, 4000, 1e-5)
        assert bool(r.converged)
        assert _match_err(np.linalg.eigvals(a.astype(np.complex128)),
                          np.asarray(r.eigenvalues)) < 1e-3


class TestEigenvectors:
    """compute_vectors superset: Schur accumulation + back-substitution."""

    @pytest.mark.parametrize("make", ["real", "cplx"])
    def test_xla_path_residual(self, make):
        rng = np.random.default_rng(3)
        n = 30
        a = rng.standard_normal((n, n))
        if make == "cplx":
            a = a + 1j * rng.standard_normal((n, n))
        M = es.DenseMatrix.from_array(a)
        r = es.qr_eigenvalues(M, es.QROptions(
            mode="accelerated", compute_vectors=True, tolerance=1e-10,
            max_iterations=3000))
        assert bool(r.converged)
        V = np.asarray(r.eigenvectors)
        lam = np.asarray(r.eigenvalues)
        res = np.abs(a.astype(np.complex128) @ V - V * lam[None, :]).max()
        assert res < 1e-8
        # columns normalized
        np.testing.assert_allclose(np.linalg.norm(V, axis=0), 1.0, rtol=1e-6)

    def test_float32_eigenpairs_residual(self):
        rng = np.random.default_rng(4)
        n = 18
        a = rng.standard_normal((n, n)).astype(np.float32)
        r = _accel(a, max_it=2000, compute_vectors=True)
        assert bool(r.converged)
        V = np.asarray(r.eigenvectors).astype(np.complex128)
        eigs = np.asarray(r.eigenvalues)
        res = np.abs(a.astype(np.complex128) @ V - V * eigs[None, :]).max()
        assert res < 5e-5

    def test_triangular_backsub_repeated_eigenvalue(self):
        # repeated diagonal: the perturbed-pivot path must stay finite
        T = np.array([[2.0, 1.0, 0.5],
                      [0.0, 2.0, 1.0],
                      [0.0, 0.0, 3.0]], np.complex128)
        V = np.asarray(triangular_eigenvectors(jnp.asarray(T), 1e-15))
        assert np.all(np.isfinite(V))
        # the well-separated eigenvalue's vector is exact
        v3 = V[:, 2] / np.linalg.norm(V[:, 2])
        r = T @ v3 - 3.0 * v3
        assert np.abs(r).max() < 1e-12

    def test_parity_mode_rejects_vectors(self):
        with pytest.raises(ValueError, match="compute_vectors"):
            es.QROptions(mode="parity", compute_vectors=True)
