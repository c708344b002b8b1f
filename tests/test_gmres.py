"""GMRES tests (single-chip and distributed-reduction injection)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu import SparseCSR, solve_shifted
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random
from pcsc_eigenvalue_solver_project_tpu.parallel.arnoldi import (
    distributed_arnoldi_eigenvalues)
from pcsc_eigenvalue_solver_project_tpu.parallel.dia import partition_dia
from pcsc_eigenvalue_solver_project_tpu.parallel.krylov import gmres
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA


class TestGmres:
    def test_solves_nonsymmetric(self):
        rng = np.random.default_rng(0)
        n = 60
        a = np.diag(rng.random(n) + 2.0) + 0.3 * rng.random((n, n))
        b = rng.random(n)
        x, rn, restarts = gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                                vdot=jnp.vdot, norm=jnp.linalg.norm,
                                m=20, tol=1e-12)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                                   rtol=1e-7, atol=1e-9)
        assert float(rn) <= 1e-10 * np.linalg.norm(b) + 1e-12

    def test_preconditioned(self):
        rng = np.random.default_rng(1)
        n = 40
        d = rng.random(n) * 50 + 1
        a = np.diag(d) + 0.05 * rng.random((n, n))
        b = rng.random(n)
        x, rn, k_pre = gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                             vdot=jnp.vdot, norm=jnp.linalg.norm,
                             precond=lambda v: v / jnp.asarray(d),
                             m=10, tol=1e-12)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                                   rtol=1e-6, atol=1e-8)

    def test_complex(self):
        rng = np.random.default_rng(2)
        n = 24
        a = np.diag(rng.random(n) + 2 + 1j) + 0.05 * (
            rng.random((n, n)) + 1j * rng.random((n, n)))
        b = rng.random(n) + 1j * rng.random(n)
        x, rn, _ = gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                         vdot=jnp.vdot, norm=jnp.linalg.norm, m=24, tol=1e-12)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                                   rtol=1e-7, atol=1e-9)

    def test_via_solve_shifted(self):
        rng = np.random.default_rng(3)
        n = 30
        m = banded_random(n, bandwidth=3, nnz_per_row=4, seed=7, diag_boost=5.0)
        b = rng.random(n)
        x = np.asarray(solve_shifted(m, 0.4, b, method="gmres"))
        a = np.asarray(m.to_dense())
        np.testing.assert_allclose(x, np.linalg.solve(a - 0.4 * np.eye(n), b),
                                   rtol=1e-6, atol=1e-8)


class TestDistributedDiaArnoldi:
    def test_matches_oracle(self, key):
        mesh = make_row_mesh(8)
        n = 120
        m = SparseDIA.from_csr(banded_random(n, bandwidth=3, nnz_per_row=4,
                                             seed=21).as_csr())
        A = partition_dia(m, mesh)
        res = distributed_arnoldi_eigenvalues(A, mesh, k=2, m=50, key=key)
        exact = np.linalg.eigvals(np.asarray(m.to_dense()))
        exact = exact[np.argsort(-np.abs(exact))][:2]
        got = np.asarray(res.eigenvalues)
        for e in exact:
            assert min(abs(got - e)) < 1e-6


class TestSplitPlaneGmres:
    """Restarted GMRES on (2, n) re/im planes (ops/split_krylov.py), the
    inner solve of split-complex shift-invert. Reference solve being
    replaced: solve_shifted.hpp:104-115."""

    @staticmethod
    def _system(n, seed):
        rng = np.random.default_rng(seed)
        A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
             + 20 * np.eye(n))
        xstar = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        Ar = jnp.asarray(np.stack([A.real, A.imag]))

        def mv(v):
            return jnp.stack([Ar[0] @ v[0] - Ar[1] @ v[1],
                              Ar[0] @ v[1] + Ar[1] @ v[0]])

        b = A @ xstar
        return A, xstar, mv, jnp.asarray(np.stack([b.real, b.imag]))

    @pytest.mark.parametrize("m", [16, 20])
    def test_gmres_planes_solve(self, m):
        from pcsc_eigenvalue_solver_project_tpu.ops.split_krylov import (
            splitc_gmres)
        A, xstar, mv, bp = self._system(60, 1)
        x = np.asarray(splitc_gmres(mv, bp, tol=1e-10, m=m))
        xc = x[0] + 1j * x[1]
        assert np.abs(xc - xstar).max() / np.abs(xstar).max() < 1e-6

    def test_shifted_gmres_with_jacobi(self):
        from pcsc_eigenvalue_solver_project_tpu.ops.split_krylov import (
            solve_shifted_splitc_gmres)
        A, xstar, mv, bp = self._system(40, 2)
        shift = 0.5 + 0.25j
        d = np.diagonal(A)
        x = np.asarray(solve_shifted_splitc_gmres(
            mv, jnp.asarray([shift.real, shift.imag]), bp,
            diag=jnp.asarray(np.stack([d.real, d.imag])), tol=1e-10, m=16))
        xc = x[0] + 1j * x[1]
        want = np.linalg.solve(A - shift * np.eye(40), A @ xstar)
        assert np.abs(xc - want).max() / np.abs(want).max() < 1e-6
