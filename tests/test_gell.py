"""Packed gather-ELL (general unstructured sparse) pack + matrix tests.

The pack is evaluated eagerly and under ``jax.jit`` (the pack is a pytree
with static geometry) against a float64 dense oracle. Reference hot op:
reference src/power_method/power_method.hpp:69 with an arbitrary
Eigen::SparseMatrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu import (SolverOptions, SparseCSR,
                                                SparseGELL, power_method)
from pcsc_eigenvalue_solver_project_tpu.ops.gell import (
    auto_tile_rows, gell_matvec, pack_gell)


def _matvec(pack, x, mode):
    if mode == "jit":
        return jax.jit(gell_matvec)(pack, x)
    return gell_matvec(pack, x)


def _random_coo(rng, n_rows, n_cols, nnz, dtype):
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_cols, nnz)
    v = rng.standard_normal(nnz)
    if np.dtype(dtype).kind == "c":
        v = (v + 1j * rng.standard_normal(nnz)).astype(dtype)
    else:
        v = v.astype(dtype)
    return r, c, v


def _dense_of(r, c, v, shape):
    wide = np.complex128 if np.dtype(v.dtype).kind == "c" else np.float64
    a = np.zeros(shape, wide)
    np.add.at(a, (r, c), v)
    return a


class TestPackAndMatvec:
    @pytest.mark.parametrize("mode", ["eager", "jit"])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                       np.complex128])
    def test_matches_dense_random(self, mode, dtype):
        rng = np.random.default_rng(0)
        r, c, v = _random_coo(rng, 500, 700, 9000, dtype)
        pack = pack_gell(r, c, v, (500, 700), tile_rows=128)
        x = rng.standard_normal(700)
        if np.dtype(dtype).kind == "c":
            x = (x + 1j * rng.standard_normal(700)).astype(dtype)
        else:
            x = x.astype(dtype)
        ref = _dense_of(r, c, v, (500, 700)) @ x.astype(np.complex128 if
                                                        np.dtype(dtype).kind == "c"
                                                        else np.float64)
        y = np.asarray(_matvec(pack, jnp.asarray(x), mode))
        rel = np.max(np.abs(y - ref)) / np.max(np.abs(ref))
        tol = 1e-5 if np.dtype(dtype).itemsize <= 8 else 1e-12
        assert rel < tol

    @pytest.mark.parametrize("mode", ["eager", "jit"])
    def test_duplicates_sum(self, mode):
        # duplicate (row, col) entries become scan-run members and sum
        r = np.array([3, 3, 3, 3, 7, 7])
        c = np.array([5, 5, 5, 5, 5, 5])
        v = np.array([1.0, 2.0, 3.0, 4.0, 10.0, 20.0], np.float32)
        pack = pack_gell(r, c, v, (10, 10), tile_rows=128)
        x = np.zeros(10, np.float32)
        x[5] = 2.0
        y = np.asarray(_matvec(pack, jnp.asarray(x), mode))
        np.testing.assert_allclose(y[3], 20.0, rtol=1e-6)
        np.testing.assert_allclose(y[7], 60.0, rtol=1e-6)

    @pytest.mark.parametrize("mode", ["eager", "jit"])
    def test_spill_paths(self, mode):
        # tiny dup-dense matrix: bucket overflow (slot >= 128) and deep runs
        # (rank >= 8) both exercise the COO spill tail
        rng = np.random.default_rng(1)
        r, c, v = _random_coo(rng, 8, 8, 2000, np.float32)
        pack = pack_gell(r, c, v, (8, 8), tile_rows=128)
        assert pack.n_spill > 0
        x = rng.standard_normal(8).astype(np.float32)
        ref = _dense_of(r, c, v, (8, 8)) @ x.astype(np.float64)
        y = np.asarray(_matvec(pack, jnp.asarray(x), mode))
        assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 2e-5

    def test_empty_matrix(self):
        pack = pack_gell(np.zeros(0, int), np.zeros(0, int),
                         np.zeros(0, np.float32), (64, 64))
        y = gell_matvec(pack, jnp.ones(64, jnp.float32))
        np.testing.assert_array_equal(np.asarray(y), np.zeros(64))

    def test_multi_tile_and_wide_columns(self):
        # several row tiles and a column span of many 128-wide segments
        rng = np.random.default_rng(2)
        n_rows, n_cols = 700, 40_000   # 40K cols -> 313 segments -> 3 chunks
        r, c, v = _random_coo(rng, n_rows, n_cols, 15_000, np.float32)
        pack = pack_gell(r, c, v, (n_rows, n_cols), tile_rows=256)
        assert pack.n_chunks == 3 and pack.n_tiles == 3
        x = rng.standard_normal(n_cols).astype(np.float32)
        ref = _dense_of(r, c, v, (n_rows, n_cols)) @ x.astype(np.float64)
        for mode in ("eager", "jit"):
            y = np.asarray(_matvec(pack, jnp.asarray(x), mode))
            assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5

    def test_bf16_values(self):
        rng = np.random.default_rng(5)
        r, c, v = _random_coo(rng, 400, 400, 6000, np.float32)
        pack = pack_gell(r, c, v, (400, 400)).with_values_dtype(jnp.bfloat16)
        x = rng.standard_normal(400).astype(np.float32)
        v16 = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float64)
        ref = _dense_of(r, c, v16, (400, 400)) @ x.astype(np.float64)
        y = np.asarray(gell_matvec(pack, jnp.asarray(x)))
        assert y.dtype == np.float32
        assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5

    def test_auto_tile_rows(self):
        assert auto_tile_rows(100_000, 33 * 100_000) == 384
        assert auto_tile_rows(1000, 1000) == 1024        # clamped high
        assert auto_tile_rows(100, 100 * 500) == 128     # clamped low
        assert pack_gell(np.array([0]), np.array([0]),
                         np.array([1.0], np.float32), (4, 4)).tile_rows % 128 == 0

    def test_bad_tile_rows_rejected(self):
        with pytest.raises(ValueError, match="multiple of 128"):
            pack_gell(np.array([0]), np.array([0]), np.array([1.0], np.float32),
                      (4, 4), tile_rows=100)


class TestSparseGELLMatrix:
    def test_from_csr_matches_csr(self):
        rng = np.random.default_rng(3)
        r, c, v = _random_coo(rng, 300, 300, 4000, np.float64)
        csr = SparseCSR.from_coo(r, c, v, (300, 300))
        g = csr.to_gell()
        assert g.shape == (300, 300) and not g.is_dense
        assert g.dtype == np.dtype(np.float64)
        x = jnp.asarray(rng.standard_normal(300))
        np.testing.assert_allclose(np.asarray(g.matvec(x)),
                                   np.asarray(csr.matvec(x)), rtol=1e-10)

    def test_diagonal(self):
        r = np.array([0, 1, 2, 0, 2, 2])
        c = np.array([0, 1, 2, 2, 0, 2])
        v = np.array([1.0, 2.0, 3.0, 9.0, 8.0, 4.0])
        g = SparseGELL.from_coo(r, c, v, (3, 3))
        np.testing.assert_allclose(np.asarray(g.diagonal()), [1.0, 2.0, 7.0])

    def test_index_out_of_range(self):
        with pytest.raises(ValueError, match="out of range"):
            SparseGELL.from_coo([0], [5], [1.0], (3, 3))

    def test_power_method_on_gell(self, key):
        # protocol compatibility: the solver runs unchanged on SparseGELL
        rng = np.random.default_rng(4)
        n = 200
        a = rng.standard_normal((n, n)) * 0.1
        a[np.diag_indices(n)] += np.linspace(1.0, 3.0, n)
        a = (a + a.T) / 2
        csr = SparseCSR.from_dense(a)
        res = power_method(csr.to_gell(),
                           SolverOptions(tolerance=1e-12, max_iterations=5000),
                           key=key)
        lam = np.max(np.linalg.eigvalsh(a))
        assert bool(res.converged)
        np.testing.assert_allclose(float(np.real(res.eigenvalue)), lam, rtol=1e-6)
