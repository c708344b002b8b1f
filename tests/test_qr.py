"""QR-stack tests: Hessenberg, QR decomposition, QR eigenvalues.

Mirrors /root/reference/test/qr_algorithms_test.cpp: Hessenberg structure
and spectrum preservation (cross-checked against numpy's eig, the
Eigen::EigenSolver analogue), rectangular QR properties, unitarity,
error paths, and the symmetric 2x2 -> {3,1} eigenvalue case with iteration
bounds. Adds accelerated-mode (Wilkinson shift + deflation) coverage the
reference lacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu import (
    DenseMatrix, QROptions, SolverOptions, SparseCSR, qr_decompose,
    qr_eigenvalues, to_hessenberg)


def spectrum_distance(got, expected):
    """Max distance under greedy nearest matching (conjugate-pair-order safe)."""
    got, expected = list(np.asarray(got)), list(np.asarray(expected))
    worst = 0.0
    for e in expected:
        j = int(np.argmin([abs(g - e) for g in got]))
        worst = max(worst, abs(got[j] - e))
        got.pop(j)
    return worst


class TestHessenberg:
    def test_structure_real(self):
        # qr_algorithms_test.cpp:32-55: zeros below the subdiagonal
        rng = np.random.default_rng(0)
        a = rng.random((6, 6))
        H = np.asarray(to_hessenberg(DenseMatrix.from_array(a)))
        assert np.abs(np.tril(H, -2)).max() < 1e-12

    def test_structure_complex(self):
        # qr_algorithms_test.cpp:57-81
        rng = np.random.default_rng(1)
        a = rng.random((5, 5)) + 1j * rng.random((5, 5))
        H = np.asarray(to_hessenberg(DenseMatrix.from_array(a, dtype=np.complex128)))
        assert np.abs(np.tril(H, -2)).max() < 1e-12

    def test_spectrum_preserved(self):
        # qr_algorithms_test.cpp:94-136 (Eigen::EigenSolver cross-check)
        rng = np.random.default_rng(2)
        a = rng.random((7, 7))
        H = np.asarray(to_hessenberg(DenseMatrix.from_array(a)))
        assert spectrum_distance(np.linalg.eigvals(H), np.linalg.eigvals(a)) < 1e-8

    def test_non_square(self):
        # qr_algorithms_test.cpp:83-92
        with pytest.raises(ValueError, match="must be square"):
            to_hessenberg(DenseMatrix.from_array(np.ones((2, 3))))

    def test_sparse_rejected(self):
        # to_hessenberg.hpp:104-106
        m = SparseCSR.from_coo([0], [0], [1.0], (2, 2))
        with pytest.raises(ValueError, match="only dense"):
            to_hessenberg(m)

    def test_small_matrices_unchanged(self):
        for n in (1, 2):
            a = np.arange(n * n, dtype=float).reshape(n, n) + np.eye(n)
            H = np.asarray(to_hessenberg(DenseMatrix.from_array(a)))
            np.testing.assert_allclose(H, a)


class TestQRDecompose:
    def test_rectangular_3x2(self):
        # qr_algorithms_test.cpp:140-180
        a = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        Q, R = map(np.asarray, qr_decompose(DenseMatrix.from_array(a)))
        assert Q.shape == (3, 3) and R.shape == (3, 2)
        np.testing.assert_allclose(Q @ R, a, atol=1e-12)
        assert np.abs(np.tril(R, -1)).max() < 1e-12
        np.testing.assert_allclose(Q.conj().T @ Q, np.eye(3), atol=1e-12)

    def test_complex_unitarity(self):
        # qr_algorithms_test.cpp:182-223
        a = np.array([[1 + 1j, 2.0], [0 + 1j, 1 - 1j]])
        Q, R = map(np.asarray, qr_decompose(
            DenseMatrix.from_array(a, dtype=np.complex128)))
        np.testing.assert_allclose(Q @ R, a, atol=1e-12)
        np.testing.assert_allclose(Q.conj().T @ Q, np.eye(2), atol=1e-12)

    def test_empty_raises(self):
        # qr_decompose.hpp:38-40 (qr_algorithms_test.cpp:225-233)
        with pytest.raises(ValueError, match="empty matrix"):
            qr_decompose(DenseMatrix.from_array(np.zeros((0, 0))))

    def test_sparse_rejected(self):
        m = SparseCSR.from_coo([0], [0], [1.0], (2, 2))
        with pytest.raises(ValueError, match="only dense"):
            qr_decompose(m)


class TestQREigenvaluesParity:
    def test_symmetric_2x2(self):
        # qr_algorithms_test.cpp:237-285: eigenvalues {3, 1} within 1e-8
        a = np.array([[2.0, 1.0], [1.0, 2.0]])
        r = qr_eigenvalues(DenseMatrix.from_array(a))
        got = np.sort(np.asarray(r.eigenvalues).real)
        np.testing.assert_allclose(got, [1.0, 3.0], atol=1e-8)
        assert bool(r.converged)
        assert 1 <= int(r.iterations) <= 1000

    def test_symmetric_2x2_complex_dtype(self):
        # qr_algorithms_test.cpp:287-333: same matrix as complex scalars
        a = np.array([[2.0, 1.0], [1.0, 2.0]], dtype=np.complex128)
        r = qr_eigenvalues(DenseMatrix.from_array(a, dtype=np.complex128))
        got = np.sort(np.asarray(r.eigenvalues).real)
        np.testing.assert_allclose(got, [1.0, 3.0], atol=1e-8)

    def test_complex_triangular(self):
        # demo matrix family: complex upper-triangular converges fast
        a = np.array([[1 + 3j, 3 + 5j, 1 + 4j],
                      [0, 2 + 4j, 3 + 2j],
                      [0, 0, 5 - 1j]])
        r = qr_eigenvalues(DenseMatrix.from_array(a, dtype=np.complex128))
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 [1 + 3j, 2 + 4j, 5 - 1j]) < 1e-8

    def test_non_square(self):
        # qr_algorithms_test.cpp:335-348
        with pytest.raises(ValueError, match="must be square"):
            qr_eigenvalues(DenseMatrix.from_array(np.ones((2, 3))))

    def test_sparse_rejected(self):
        m = SparseCSR.from_coo([0], [0], [1.0], (2, 2))
        with pytest.raises(ValueError, match="only dense"):
            qr_eigenvalues(m)

    def test_scalar_type_mismatch(self):
        with pytest.raises(TypeError, match="scalar type mismatch"):
            qr_eigenvalues(DenseMatrix.from_array(np.eye(2)), dtype=np.complex128)

    def test_zero_size(self):
        # qr_eigenvalues.hpp:55-57: n==0 -> empty, converged, 0 iterations
        r = qr_eigenvalues(DenseMatrix.from_array(np.zeros((0, 0))))
        assert np.asarray(r.eigenvalues).shape == (0,)
        assert bool(r.converged) and int(r.iterations) == 0

    def test_nonconvergence_iteration_count(self):
        # iterations == max_iterations + 1 on non-convergence
        # (qr_eigenvalues.hpp:69,104). Rotation matrix: real unshifted QR
        # cannot converge for a complex pair.
        th = 1.0
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        r = qr_eigenvalues(DenseMatrix.from_array(rot),
                           SolverOptions(max_iterations=20))
        assert not bool(r.converged)
        assert int(r.iterations) == 21

    def test_max_iterations_zero(self):
        a = np.array([[2.0, 1.0], [1.0, 2.0]])
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           SolverOptions(max_iterations=0))
        assert not bool(r.converged)
        assert int(r.iterations) == 1  # for-loop quirk: iter stays 0 -> 0+1


class TestQREigenvaluesAccelerated:
    def test_real_with_complex_pairs(self):
        rng = np.random.default_rng(3)
        a = rng.random((8, 8))
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated", tolerance=1e-12))
        assert bool(r.converged)
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 np.linalg.eigvals(a)) < 1e-9

    def test_complex_matrix(self):
        rng = np.random.default_rng(4)
        a = rng.random((12, 12)) + 1j * rng.random((12, 12))
        r = qr_eigenvalues(DenseMatrix.from_array(a, dtype=np.complex128),
                           QROptions(mode="accelerated", tolerance=1e-13))
        assert bool(r.converged)
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 np.linalg.eigvals(a)) < 1e-9

    def test_symmetric(self):
        rng = np.random.default_rng(5)
        s = rng.random((16, 16))
        s = s + s.T
        r = qr_eigenvalues(DenseMatrix.from_array(s),
                           QROptions(mode="accelerated", tolerance=1e-12))
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 np.linalg.eigvalsh(s)) < 1e-9

    def test_faster_than_parity_in_sweeps(self):
        # deflation + shifts should converge in O(n) sweeps
        rng = np.random.default_rng(6)
        a = rng.random((16, 16))
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated", tolerance=1e-10))
        assert bool(r.converged)
        assert int(r.iterations) <= 6 * 16

    def test_diagonal_instant(self):
        a = np.diag([3.0, 1.0, 2.0])
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated"))
        assert bool(r.converged)
        assert spectrum_distance(np.asarray(r.eigenvalues), [1, 2, 3]) < 1e-12


class TestParityNoSizeCliff:
    def test_parity_complex_beyond_old_cap_runs_on_device(self, recwarn):
        """Parity mode has no size cliff and no host fallback at any size
        (the reference iteration, qr_eigenvalues.hpp:40-108, has none)."""
        n = 385
        a = (np.triu(np.ones((n, n))) + 1j * np.eye(n)).astype(np.complex64)
        r = qr_eigenvalues(DenseMatrix.from_array(a, dtype=np.complex64),
                           QROptions(mode="parity", max_iterations=1))
        assert r.eigenvalues.shape == (n,)
        assert r.eigenvalues.devices() == {jax.devices()[0]}
        assert not recwarn.list

    def test_parity_within_cap_does_not_warn(self, monkeypatch, recwarn):
        from pcsc_eigenvalue_solver_project_tpu.solvers import (
            qr_eigenvalues as qe)
        a = np.diag(np.arange(1.0, 5.0)).astype(np.float32)
        qe.qr_eigenvalues(DenseMatrix.from_array(a, dtype=np.float32),
                          QROptions(mode="parity", max_iterations=5))
        assert not [w for w in recwarn.list
                    if "parity kernel" in str(w.message)]


class TestDeviceResidentEntry:
    """Public QR entries must not round-trip device-resident matrices
    through host numpy."""

    @pytest.mark.parametrize("dtype,opts", [
        (jnp.float32, QROptions(mode="accelerated")),
        (jnp.complex64, QROptions(mode="accelerated")),
        (jnp.float32, QROptions(mode="accelerated", compute_vectors=True)),
        (jnp.float32, QROptions(mode="parity")),
    ])
    def test_no_device_to_host_transfer(self, dtype, opts):
        a = jnp.diag(jnp.arange(1.0, 9.0)).astype(dtype)
        M = DenseMatrix.from_array(a)
        with jax.transfer_guard_device_to_host("disallow"):
            r = qr_eigenvalues(M, opts)
        assert isinstance(r.eigenvalues, jax.Array)
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 np.arange(1.0, 9.0)) < 1e-4

    def test_hessenberg_and_qr_entries_stay_on_device(self):
        from pcsc_eigenvalue_solver_project_tpu import qr_decompose, to_hessenberg
        a = jnp.asarray(np.random.default_rng(0).standard_normal((12, 12)),
                        jnp.float32)
        M = DenseMatrix.from_array(a)
        with jax.transfer_guard_device_to_host("disallow"):
            H = to_hessenberg(M)
            Q, R = qr_decompose(M)
        assert isinstance(H, jax.Array) and isinstance(Q, jax.Array)
