"""Block (subspace) iteration + block SpMM tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pcsc_eigenvalue_solver_project_tpu as es
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random
from pcsc_eigenvalue_solver_project_tpu.ops.dia import dia_matmat
from pcsc_eigenvalue_solver_project_tpu.solvers.subspace import (
    _cholqr2, subspace_iteration)


class TestBlockKernel:
    def test_matches_dense_oracle(self):
        rng = np.random.default_rng(0)
        n, k, b = 20000, 9, 6
        offsets = tuple(range(-4, 5))
        vals = np.zeros((k, n), np.float32)
        for d, off in enumerate(offsets):
            vals[d] = rng.random(n)
            if off > 0:
                vals[d, n - off:] = 0
            elif off < 0:
                vals[d, :-off] = 0
        vals = jnp.asarray(vals)
        xs = jnp.asarray(rng.random((b, n)).astype(np.float32))
        v64, x64 = np.asarray(vals, np.float64), np.asarray(xs, np.float64)
        y_ref = np.zeros((b, n))
        for d, off in enumerate(offsets):
            lo, hi = max(0, -off), min(n, n - off)
            y_ref[:, lo:hi] += v64[d, lo:hi] * x64[:, lo + off:hi + off]
        y = dia_matmat(vals, offsets, xs)
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-5, atol=2e-5)

    def test_block_consistent_with_single(self):
        m = banded_random(300, bandwidth=3, nnz_per_row=4, seed=1)
        dia = SparseDIA.from_csr(m)
        rng = np.random.default_rng(2)
        xs = jnp.asarray(rng.random((4, 300)))
        ys = np.asarray(dia_matmat(dia.data, dia.offsets, xs))
        for i in range(4):
            np.testing.assert_allclose(ys[i], np.asarray(dia.matvec(xs[i])),
                                       rtol=1e-12)


class TestCholQR2:
    def test_orthonormalises(self):
        rng = np.random.default_rng(3)
        X = jnp.asarray(rng.random((200, 8)))
        Q = np.asarray(_cholqr2(X))
        np.testing.assert_allclose(Q.T @ Q, np.eye(8), atol=1e-10)
        # same column space
        resid = Q - np.asarray(X) @ np.linalg.lstsq(np.asarray(X), Q, rcond=None)[0]
        assert np.abs(resid).max() < 1e-8


class TestSubspaceIteration:
    def test_separated_diagonal(self, key):
        d = np.concatenate([[40.0, 30.0, 22.0, 15.0], np.linspace(0.1, 2.0, 60)])
        M = es.DenseMatrix.from_array(np.diag(d))
        r = subspace_iteration(M, k=4, opts=es.SolverOptions(tolerance=1e-10,
                                                             max_iterations=2000),
                               key=key)
        assert bool(r.converged)
        np.testing.assert_allclose(np.sort(np.asarray(r.eigenvalues).real)[::-1],
                                   [40, 30, 22, 15], rtol=1e-8)

    def test_banded_with_complex_pair(self, key):
        m = banded_random(400, bandwidth=4, nnz_per_row=5, seed=2)
        dia = SparseDIA.from_csr(m)
        r = subspace_iteration(dia, k=3, opts=es.SolverOptions(tolerance=1e-9,
                                                               max_iterations=3000),
                               key=key)
        assert bool(r.converged)
        exact = np.linalg.eigvals(np.asarray(m.to_dense()))
        exact = exact[np.argsort(-np.abs(exact))][:3]
        got = np.asarray(r.eigenvalues)
        for e in exact:
            assert min(abs(got - e)) < 1e-5

    def test_errors(self):
        M = es.DenseMatrix.from_array(np.ones((2, 3)))
        with pytest.raises(ValueError, match="square"):
            subspace_iteration(M)
        M2 = es.DenseMatrix.from_array(np.eye(6))
        with pytest.raises(ValueError, match="block .2. must be >= k"):
            subspace_iteration(M2, k=3, block=2)

    @pytest.mark.slow
    def test_interleaved_rows_mode_matches_natural(self, key):
        # InterleavedDIA routes through the row-domain CholeskyQR2 chunk
        from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
        dia = banded_full(3000, bandwidth=4, dtype=np.float32, seed=9,
                          diag_boost=1.0)
        il = dia.interleaved()
        opts = es.SolverOptions(max_iterations=3000, tolerance=1e-7)
        r1 = subspace_iteration(dia, k=4, opts=opts, key=key)
        r2 = subspace_iteration(il, k=4, opts=opts, key=key)
        assert bool(r1.converged) and bool(r2.converged)
        np.testing.assert_allclose(
            np.sort(np.asarray(r2.eigenvalues).real),
            np.sort(np.asarray(r1.eigenvalues).real), rtol=1e-4)


class TestDistributedSubspace:
    def test_matches_single_chip_and_oracle(self, key):
        import os
        from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
        from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
        from pcsc_eigenvalue_solver_project_tpu.parallel.dia import partition_dia_il
        from pcsc_eigenvalue_solver_project_tpu.parallel.subspace import (
            distributed_subspace_iteration)
        mesh = make_row_mesh(8)
        dia = banded_full(768, bandwidth=4, dtype=np.float32, seed=9,
                          diag_boost=4.0)
        A = partition_dia_il(dia, mesh)
        opts = es.SolverOptions(max_iterations=1500, tolerance=1e-6)
        r = distributed_subspace_iteration(A, mesh, k=4, opts=opts, key=key)
        assert bool(r.converged)
        exact = np.linalg.eigvals(np.asarray(dia.to_dense()))
        top = np.sort_complex(exact[np.argsort(-np.abs(exact))][:4])
        np.testing.assert_allclose(
            np.sort_complex(np.asarray(r.eigenvalues)), top, rtol=1e-3)

    def test_errors(self, key):
        from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
        from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
        from pcsc_eigenvalue_solver_project_tpu.parallel.dia import partition_dia_il
        from pcsc_eigenvalue_solver_project_tpu.parallel.subspace import (
            distributed_subspace_iteration)
        mesh = make_row_mesh(8)
        A = partition_dia_il(banded_full(600, bandwidth=2, dtype=np.float32,
                                         seed=0), mesh)
        with pytest.raises(ValueError, match="k must be >= 1"):
            distributed_subspace_iteration(A, mesh, k=0, key=key)
        with pytest.raises(ValueError, match="block .2. must be >= k"):
            distributed_subspace_iteration(A, mesh, k=3, block=2, key=key)


class TestChebyshevSubspace:
    def test_separated_top_exact(self, key):
        from pcsc_eigenvalue_solver_project_tpu.solvers.subspace import (
            chebyshev_subspace_iteration)
        from tests.test_lanczos import sym_banded
        boost = np.zeros(2000)
        boost[:4] = [8, 7, 6.5, 6]
        A = sym_banded(2000, 3, 0, boost)
        exact = np.sort(np.linalg.eigvalsh(np.asarray(A.to_dense())))[::-1][:4]
        r = chebyshev_subspace_iteration(
            A, k=4, degree=10, key=key,
            opts=es.SolverOptions(max_iterations=1000, tolerance=1e-9))
        assert bool(r.converged)
        np.testing.assert_allclose(np.asarray(r.eigenvalues), exact,
                                   rtol=1e-7)

    def test_clustered_top_beats_plain_iteration(self, key):
        # laplacian top cluster (1e-5 gaps): the filter resolves it where
        # plain block iteration stalls
        from pcsc_eigenvalue_solver_project_tpu.models.generators import (
            laplacian_1d)
        from pcsc_eigenvalue_solver_project_tpu.solvers.subspace import (
            chebyshev_subspace_iteration)
        L = SparseDIA.from_csr(laplacian_1d(1000))
        exact = np.sort(2 - 2 * np.cos(np.arange(1, 1001) * np.pi / 1001))[::-1][:3]
        r = chebyshev_subspace_iteration(
            L, k=3, degree=20, key=key,
            opts=es.SolverOptions(max_iterations=400, tolerance=1e-10))
        assert bool(r.converged)
        np.testing.assert_allclose(np.asarray(r.eigenvalues), exact,
                                   atol=1e-7)

    def test_interleaved_rows_mode(self, key):
        from pcsc_eigenvalue_solver_project_tpu.solvers.subspace import (
            chebyshev_subspace_iteration)
        from tests.test_lanczos import sym_banded
        boost = np.zeros(2000, np.float32)
        boost[:4] = [8, 7, 6.5, 6]
        A = sym_banded(2000, 3, 0, boost, dtype=np.float32)
        exact = np.sort(np.linalg.eigvalsh(
            np.asarray(A.to_dense()).astype(np.float64)))[::-1][:4]
        il = A.interleaved()
        r = chebyshev_subspace_iteration(
            il, k=4, degree=10, key=key,
            opts=es.SolverOptions(max_iterations=1000, tolerance=1e-5))
        np.testing.assert_allclose(np.asarray(r.eigenvalues), exact,
                                   rtol=1e-3)

    def test_errors(self, key):
        from pcsc_eigenvalue_solver_project_tpu.solvers.subspace import (
            chebyshev_subspace_iteration)
        M = es.DenseMatrix.from_array(np.ones((2, 3)))
        with pytest.raises(ValueError, match="square"):
            chebyshev_subspace_iteration(M)
        M2 = es.DenseMatrix.from_array(np.eye(8))
        with pytest.raises(ValueError, match="degree"):
            chebyshev_subspace_iteration(M2, k=2, degree=0)
