"""Real-arithmetic (Francis double-shift) accelerated QR tests.

This is the path real matrices take in accelerated mode. Conjugate pairs
come out of
analytic 2x2 deflation; the bulge must start at the top of the trailing
unreduced block (the `lo` scan) or shifts die at interior negligible
subdiagonals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu import DenseMatrix, QROptions, qr_eigenvalues
from pcsc_eigenvalue_solver_project_tpu.solvers.hessenberg import hessenberg_dense
from pcsc_eigenvalue_solver_project_tpu.solvers.qr_eigenvalues import _francis_sweep
from tests.test_qr import spectrum_distance


class TestFrancisSweep:
    def test_similarity_and_structure(self):
        rng = np.random.default_rng(0)
        a = rng.random((16, 16))
        H = np.asarray(hessenberg_dense(jnp.asarray(a)))
        H1 = np.asarray(_francis_sweep(jnp.asarray(H),
                                       jnp.asarray(0, jnp.int32),
                                       jnp.asarray(16, jnp.int32)))
        assert spectrum_distance(np.linalg.eigvals(H1), np.linalg.eigvals(a)) < 1e-10
        assert np.abs(np.tril(H1, -2)).max() < 1e-10

    def test_windowed_sweep_preserves_deflated_part(self):
        rng = np.random.default_rng(1)
        a = rng.random((12, 12))
        H = np.array(hessenberg_dense(jnp.asarray(a)))
        H[10, 9] = 0.0  # decoupled trailing 2x2
        H1 = np.asarray(_francis_sweep(jnp.asarray(H),
                                       jnp.asarray(0, jnp.int32),
                                       jnp.asarray(10, jnp.int32)))
        # trailing rows untouched from the left; spectra of both blocks kept
        assert spectrum_distance(np.linalg.eigvals(H1[:10, :10]),
                                 np.linalg.eigvals(H[:10, :10])) < 1e-10
        np.testing.assert_allclose(H1[10:, 10:], H[10:, 10:])


class TestFrancisSolver:
    @pytest.mark.parametrize("n", [2, 3, 5, 16, 96])
    def test_random_real(self, n):
        rng = np.random.default_rng(n)
        a = rng.random((n, n))
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated", tolerance=1e-12,
                                     max_iterations=5000))
        assert bool(r.converged)
        assert np.asarray(r.eigenvalues).dtype.kind == "c"
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 np.linalg.eigvals(a)) < 1e-8

    def test_sweeps_scale_linearly(self):
        # ~2 sweeps per eigenvalue is the Francis signature; a stalled
        # bulge (the lo bug) shows up as O(10n) sweeps
        rng = np.random.default_rng(42)
        a = rng.random((128, 128))
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated", tolerance=1e-12,
                                     max_iterations=5000))
        assert bool(r.converged)
        assert int(r.iterations) < 4 * 128

    def test_defective_jordan_block(self):
        # J(0.5, 4): defective; QR still converges to the eigenvalue with
        # reduced accuracy (eigenvalue condition ~ eps^{1/4})
        n = 4
        a = 0.5 * np.eye(n) + np.diag(np.ones(n - 1), 1)
        a[n - 1, 0] = 1e-8  # perturb to avoid exact breakdown
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated", tolerance=1e-12,
                                     max_iterations=10000))
        got = np.asarray(r.eigenvalues)
        exact = np.linalg.eigvals(a)
        assert spectrum_distance(got, exact) < 1e-4

    def test_multiple_real_eigenvalues(self):
        a = np.diag([2.0, 2.0, 2.0, 1.0])
        a[0, 1] = a[1, 2] = 0.3
        r = qr_eigenvalues(DenseMatrix.from_array(a),
                           QROptions(mode="accelerated", tolerance=1e-12))
        assert spectrum_distance(np.asarray(r.eigenvalues),
                                 [2, 2, 2, 1]) < 1e-8
