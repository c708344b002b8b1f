"""Shifted-inverse-power tests.

Mirrors /root/reference/test/shifted_inverse_power_method_test.cpp: the
shift selects the nearest eigenvalue (sigma=1.9 -> 2 and sigma=4.9 -> 5 on
diag(2,5); sparse diag(1,3,10) with sigma=2.9 -> 3), error paths, and the
tiny-maxIterations iteration-count contract. Adds the Krylov
(BiCGStab) inner-solve path this library uses where the reference used
SparseLU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu import (
    DenseMatrix, ShiftedSolverOptions, SparseCSR, shifted_inverse_power_method)


class TestShiftSelectsNearest:
    def test_dense_low_shift(self, key):
        # shifted_inverse_power_method_test.cpp:38-60
        M = DenseMatrix.from_array(np.diag([2.0, 5.0]))
        res = shifted_inverse_power_method(M, ShiftedSolverOptions(shift=1.9), key=key)
        assert bool(res.converged)
        np.testing.assert_allclose(complex(res.eigenvalue), 2.0, rtol=1e-8)

    def test_dense_high_shift(self, key):
        # shifted_inverse_power_method_test.cpp:62-83
        M = DenseMatrix.from_array(np.diag([2.0, 5.0]))
        res = shifted_inverse_power_method(M, ShiftedSolverOptions(shift=4.9), key=key)
        assert bool(res.converged)
        np.testing.assert_allclose(complex(res.eigenvalue), 5.0, rtol=1e-8)

    def test_sparse(self, key):
        # shifted_inverse_power_method_test.cpp:88-110: diag(1,3,10), sigma=2.9
        M = SparseCSR.from_coo([0, 1, 2], [0, 1, 2], [1.0, 3.0, 10.0], (3, 3))
        res = shifted_inverse_power_method(M, ShiftedSolverOptions(shift=2.9), key=key)
        assert bool(res.converged)
        np.testing.assert_allclose(complex(res.eigenvalue), 3.0, rtol=1e-8)

    def test_sparse_bicgstab_path(self, key):
        M = SparseCSR.from_coo([0, 1, 2], [0, 1, 2], [1.0, 3.0, 10.0], (3, 3))
        res = shifted_inverse_power_method(
            M, ShiftedSolverOptions(shift=2.9, inner_method="bicgstab"), key=key)
        assert bool(res.converged)
        np.testing.assert_allclose(complex(res.eigenvalue), 3.0, rtol=1e-8)

    def test_complex_shift(self, key):
        # demo parity: main.cpp runs complex shifts 3.1 and 2.3
        a = np.diag([1 + 3j, 2 + 4j, 5 - 1j])
        M = DenseMatrix.from_array(a, dtype=np.complex128)
        res = shifted_inverse_power_method(
            M, ShiftedSolverOptions(shift=2.3 + 4j, tolerance=1e-12), key=key)
        assert bool(res.converged)
        np.testing.assert_allclose(complex(res.eigenvalue), 2 + 4j, rtol=1e-8)

    def test_nonsymmetric_interior(self, key):
        rng = np.random.default_rng(7)
        a = rng.random((8, 8))
        eigs = np.linalg.eigvals(a)
        # pick a real target eigenvalue region: shift toward the eigenvalue
        # of smallest magnitude
        target = min(eigs, key=lambda z: abs(z.imag) * 1e6 + abs(z))
        if abs(target.imag) < 1e-9:
            M = DenseMatrix.from_array(a)
            res = shifted_inverse_power_method(
                M, ShiftedSolverOptions(shift=float(target.real) + 0.05,
                                        tolerance=1e-12), key=key)
            np.testing.assert_allclose(complex(res.eigenvalue), target, rtol=1e-6)


class TestErrorPaths:
    def test_non_square(self):
        # shifted_inverse_power_method_test.cpp:115-133
        M = DenseMatrix.from_array(np.ones((2, 3)))
        with pytest.raises(ValueError, match="matrix must be square"):
            shifted_inverse_power_method(M)

    def test_zero_size(self):
        M = DenseMatrix.from_array(np.zeros((0, 0)))
        with pytest.raises(ValueError, match="zero size"):
            shifted_inverse_power_method(M)

    def test_scalar_type_mismatch(self):
        M = DenseMatrix.from_array(np.eye(2))
        with pytest.raises(TypeError, match="scalar type mismatch"):
            shifted_inverse_power_method(M, dtype=np.complex128)


class TestRayleighQuotientIteration:
    def test_cubic_convergence(self, key):
        from pcsc_eigenvalue_solver_project_tpu import rayleigh_quotient_iteration
        rng = np.random.default_rng(0)
        a = rng.random((12, 12))
        a = a + a.T
        M = DenseMatrix.from_array(a)
        r = rayleigh_quotient_iteration(
            M, ShiftedSolverOptions(shift=3.0, tolerance=1e-13), key=key)
        assert bool(r.converged)
        assert int(r.iterations) <= 10  # cubic: far faster than fixed shift
        eigs = np.linalg.eigvalsh(a)
        lam = complex(r.eigenvalue).real
        assert min(abs(eigs - lam)) < 1e-10

    def test_guards(self):
        from pcsc_eigenvalue_solver_project_tpu import rayleigh_quotient_iteration
        with pytest.raises(ValueError, match="square"):
            rayleigh_quotient_iteration(DenseMatrix.from_array(np.ones((2, 3))))


class TestIterationSemantics:
    def test_tiny_max_iterations(self, key):
        # shifted_inverse_power_method_test.cpp:153-170
        M = DenseMatrix.from_array(np.diag([2.0, 5.0]))
        res = shifted_inverse_power_method(
            M, ShiftedSolverOptions(shift=1.9, max_iterations=1), key=key)
        assert int(res.iterations) == 1
        assert not bool(res.converged)


class TestKrylovInnerVariants:
    """GMRES inner solve, interleaved operators, and non-finite honesty."""

    @staticmethod
    def _sym_banded(n, bw, seed, boost_head):
        from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
        rng = np.random.default_rng(seed)
        offs = tuple(range(-bw, bw + 1))
        data = np.zeros((len(offs), n), np.float32)
        for d, off in enumerate(offs):
            if off < 0:
                continue
            v = rng.uniform(-0.5, 0.5, n).astype(np.float32)
            if off > 0:
                v[n - off:] = 0
            data[d] = v
            if off > 0:
                data[offs.index(-off), off:] = v[:n - off]
        boost = np.zeros(n, np.float32)
        boost[:len(boost_head)] = boost_head
        data[bw] += boost
        return SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))

    @pytest.mark.parametrize("method", ["bicgstab", "gmres"])
    def test_symmetric_interior_shifts(self, method, key):
        A = self._sym_banded(3000, 3, 0, [30, 25, 21, 18])
        ev = np.linalg.eigvalsh(np.asarray(A.to_dense()))
        il = A.interleaved()
        for shift in (24.0, 17.0):
            target = ev[np.argmin(np.abs(ev - shift))]
            opts = ShiftedSolverOptions(shift=shift, max_iterations=100,
                                        tolerance=1e-6, inner_method=method,
                                        inner_tolerance=1e-10)
            for M in (A, il):
                r = shifted_inverse_power_method(M, opts, key=key)
                assert bool(r.converged)
                np.testing.assert_allclose(
                    float(np.real(np.asarray(r.eigenvalue))), target,
                    rtol=1e-5)

    def test_never_returns_nan(self, key):
        # nonsymmetric operator, shift in a complex-pair region: real
        # inverse iteration cannot converge there — it must report
        # converged=False with a FINITE eigenvalue, never NaN
        from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
        dia = banded_full(3000, bandwidth=3, dtype=np.float32, seed=7,
                          diag_boost=4.0)
        for method in ("bicgstab", "gmres"):
            opts = ShiftedSolverOptions(shift=4.5, max_iterations=30,
                                        tolerance=1e-8, inner_method=method,
                                        inner_tolerance=1e-10)
            r = shifted_inverse_power_method(dia, opts, key=key)
            assert np.all(np.isfinite(np.asarray(r.eigenvalue)))
            assert np.all(np.isfinite(np.asarray(r.eigenvector)))

    def test_unknown_inner_method_raises(self):
        from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
        dia = banded_full(100, bandwidth=2, dtype=np.float64, seed=0)
        with pytest.raises(ValueError, match="unknown inner method"):
            shifted_inverse_power_method(
                dia, ShiftedSolverOptions(shift=1.0, inner_method="qr"))
