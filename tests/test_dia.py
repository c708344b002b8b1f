"""SparseDIA format + banded SpMV (ops/dia.py) tests.

Every layout — natural, interleaved, block, pre-built halo window, bf16
values — is checked against a float64 NumPy evaluation of the band
(``_band_oracle``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu import SolverOptions, SparseCSR, power_method
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full, laplacian_1d
from pcsc_eigenvalue_solver_project_tpu.ops.dia import (
    deinterleave_vec, dia_matmat_il, dia_matmat_il_window, dia_matvec,
    dia_matvec_il, dia_matvec_il_window, il_rows, il_window_halo,
    interleave_dia_vals, interleave_vec)


def _band_oracle(vals, offsets, x):
    """y[i] = sum_d vals[d, i] * x[i + off_d] in float64 NumPy."""
    vals = np.asarray(vals, np.float64)
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    y = np.zeros(x.shape)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        y[..., lo:hi] += vals[d, lo:hi] * x[..., lo + off:hi + off]
    return y


def _band_vals(n, offsets, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    vals = np.zeros((len(offsets), n), dtype)
    for d, off in enumerate(offsets):
        vals[d] = rng.random(n)
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    return vals


class TestSparseDIAFormat:
    def test_from_csr_roundtrip(self):
        rng = np.random.default_rng(0)
        a = np.zeros((10, 10))
        for off in (-2, 0, 3):
            idx = np.arange(max(0, -off), min(10, 10 - off))
            a[idx, idx + off] = rng.random(len(idx))
        dia = SparseDIA.from_csr(SparseCSR.from_dense(a))
        assert dia.offsets == (-2, 0, 3)
        np.testing.assert_allclose(np.asarray(dia.to_dense()), a, rtol=1e-12)

    def test_matvec_vs_dense(self):
        rng = np.random.default_rng(1)
        m = laplacian_1d(50)
        dia = SparseDIA.from_csr(m)
        x = jnp.asarray(rng.random(50))
        np.testing.assert_allclose(np.asarray(dia.matvec(x)),
                                   np.asarray(m.matvec(x)), rtol=1e-12)

    def test_rmatvec(self):
        rng = np.random.default_rng(2)
        a = np.diag(rng.random(8)) + np.diag(rng.random(6), 2)
        dia = SparseDIA.from_csr(SparseCSR.from_dense(a))
        x = jnp.asarray(rng.random(8))
        np.testing.assert_allclose(np.asarray(dia.rmatvec(x)), a.T @ x, rtol=1e-12)

    def test_diagonal_and_bandwidth(self):
        dia = SparseDIA.from_csr(laplacian_1d(6))
        np.testing.assert_allclose(np.asarray(dia.diagonal()), np.full(6, 2.0))
        assert dia.bandwidth == 1

    def test_non_square_rejected(self):
        m = SparseCSR.from_coo([0], [1], [1.0], (2, 3))
        with pytest.raises(ValueError, match="square"):
            SparseDIA.from_csr(m)

    def test_power_method_on_dia(self, key):
        # SparseDIA satisfies the matrix protocol -> solvers work unchanged
        dia = SparseDIA.from_csr(laplacian_1d(32))
        res = power_method(dia, SolverOptions(tolerance=1e-12, max_iterations=20000),
                           key=key)
        lam_max = 2 - 2 * np.cos(32 * np.pi / 33)
        assert bool(res.converged)
        np.testing.assert_allclose(float(np.real(res.eigenvalue)), lam_max, rtol=1e-8)

    def test_banded_full_generator(self):
        dia = banded_full(64, bandwidth=3, seed=1, diag_boost=2.0)
        assert dia.offsets == tuple(range(-3, 4))
        d = np.asarray(dia.to_dense())
        assert np.abs(np.tril(d, -4)).max() == 0
        assert np.abs(np.triu(d, 4)).max() == 0


class TestPlainBandedSpMV:
    """Natural-layout banded SpMV against the float64 oracle."""

    @pytest.mark.parametrize("n,offsets", [
        (16384, (-1, 0, 1)),
        (16500, (-16, -3, 0, 7, 16)),        # non-multiple n
        (20000, tuple(range(-16, 17))),      # full band
        (16384, (-130, 0, 129)),             # |off| > 128
    ])
    def test_matches_dense_oracle(self, n, offsets):
        vals = _band_vals(n, offsets, 42)
        x = np.random.default_rng(42).random(n).astype(np.float32)
        y = dia_matvec(jnp.asarray(vals), offsets, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y),
                                   _band_oracle(vals, offsets, x),
                                   rtol=1e-5, atol=1e-5)

    def test_bf16_values_accumulate_in_f32(self):
        offsets = (-2, -1, 0, 1, 2)
        vals = _band_vals(20000, offsets, 0)
        x = np.ones(20000, np.float32)
        y = dia_matvec(jnp.asarray(vals, jnp.bfloat16), offsets, jnp.asarray(x))
        assert y.dtype == jnp.float32
        ref = _band_oracle(np.asarray(jnp.asarray(vals, jnp.bfloat16),
                                      np.float32), offsets, x)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-6, atol=1e-6)


class TestInterleavedDIA:
    """Lane-major interleaved layout against the float64 oracle, layout
    codec roundtrip, operator-protocol integration."""

    @pytest.mark.parametrize("n,offsets,tile_s", [
        (20000, tuple(range(-16, 17)), 64),   # full band
        (16500, (-16, -3, 0, 7, 16), 64),     # non-multiple n
        (20000, (-100, -3, 0, 5, 99), 64),    # wide halo
        (9000, (-1, 0, 1), 8),                # minimal row alignment
    ])
    def test_il_matvec_matches_oracle(self, n, offsets, tile_s):
        vals = _band_vals(n, offsets, 7)
        x = np.random.default_rng(7).random(n).astype(np.float32)
        R = il_rows(n, tile_s)
        y_il = dia_matvec_il(interleave_dia_vals(jnp.asarray(vals), R), offsets,
                             interleave_vec(jnp.asarray(x), R))
        np.testing.assert_allclose(np.asarray(deinterleave_vec(y_il, n)),
                                   _band_oracle(vals, offsets, x),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("offsets", [(-3, 0, 3), (-9, -1, 0, 4, 9)])
    def test_prebuilt_window_halo_values(self, offsets):
        """A caller-built window's halo rows may carry any values (the
        neighbour shard's entries): y[s, l] = sum_d v[d, s, l] *
        w[pr + s + off_d, l]."""
        rng = np.random.default_rng(11)
        R = 64
        pr = il_window_halo(offsets)
        v = rng.standard_normal((len(offsets), R, 128)).astype(np.float32)
        w = rng.standard_normal((R + 2 * pr, 128)).astype(np.float32)
        ref = np.zeros((R, 128))
        for d, off in enumerate(offsets):
            ref += v[d].astype(np.float64) * w[pr + off:pr + off + R]
        y = dia_matvec_il_window(jnp.asarray(v), offsets, jnp.asarray(w))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5, atol=1e-5)
        ys = dia_matmat_il_window(jnp.asarray(v), offsets,
                                  jnp.stack([jnp.asarray(w)] * 3))
        for j in range(3):
            np.testing.assert_allclose(np.asarray(ys[j]), ref, rtol=1e-5,
                                       atol=1e-5)

    def test_window_shape_checked(self):
        with pytest.raises(ValueError, match="window"):
            dia_matvec_il_window(jnp.zeros((3, 64, 128)), (-1, 0, 1),
                                 jnp.zeros((64, 128)))

    def test_codec_roundtrip(self):
        x = jnp.asarray(np.random.default_rng(0).random(12345), jnp.float32)
        R = il_rows(12345)
        np.testing.assert_array_equal(
            np.asarray(deinterleave_vec(interleave_vec(x, R), 12345)),
            np.asarray(x))

    def test_block_matmat_matches_oracle(self):
        n = 17000
        dia = banded_full(n, bandwidth=5, seed=2)
        rng = np.random.default_rng(3)
        R = il_rows(n, 64)
        vals = np.asarray(dia.data.astype(jnp.float32))
        vil = interleave_dia_vals(jnp.asarray(vals), R)
        xs = rng.standard_normal((4, n)).astype(np.float32)
        xs_il = jnp.stack([interleave_vec(jnp.asarray(v), R) for v in xs])
        ys = dia_matmat_il(vil, dia.offsets, xs_il)
        ref = _band_oracle(vals, dia.offsets, xs)
        for j in range(4):
            np.testing.assert_allclose(
                np.asarray(deinterleave_vec(ys[j], n)), ref[j],
                rtol=1e-4, atol=1e-4)

    def test_operator_protocol_and_power_method(self, key):
        dia = banded_full(4000, bandwidth=5, dtype=np.float32, seed=3)
        il = dia.interleaved()
        x = jnp.asarray(np.random.default_rng(0).standard_normal(4000),
                        jnp.float32)
        y1 = np.asarray(dia.matvec(x))
        y2 = np.asarray(il.decode_vec(il.matvec(il.encode_vec(x))))
        np.testing.assert_allclose(y2, y1, rtol=1e-6, atol=1e-6)
        opts = SolverOptions(max_iterations=1000, tolerance=1e-8)
        r1 = power_method(dia, opts, key=key)
        r2 = power_method(il, opts, key=key)
        assert bool(r1.converged) and bool(r2.converged)
        np.testing.assert_allclose(float(r2.eigenvalue),
                                   float(r1.eigenvalue), rtol=1e-5)
        assert r2.eigenvector.shape == (4000,)  # decoded back to natural

    def test_to_natural_roundtrip_and_queries(self):
        dia = banded_full(1000, bandwidth=3, dtype=np.float32, seed=4)
        il = dia.interleaved()
        nat = il.to_natural()
        np.testing.assert_allclose(np.asarray(nat.data),
                                   np.asarray(dia.data), rtol=0)
        assert il.bandwidth == dia.bandwidth
        assert not il.is_dense
        np.testing.assert_allclose(np.asarray(il.diagonal()),
                                   np.asarray(dia.diagonal()), rtol=0)
        with pytest.raises(TypeError, match="not sparse CSR"):
            il.as_csr()

    def test_bf16_storage_f32_accumulation(self):
        dia = banded_full(20000, bandwidth=4, dtype=np.float32, seed=5)
        il16 = dia.interleaved(dtype=jnp.bfloat16)
        x = jnp.asarray(np.random.default_rng(1).standard_normal(20000),
                        jnp.float32)
        y16 = il16.decode_vec(il16.matvec(il16.encode_vec(x)))
        assert y16.dtype == jnp.float32  # accumulation promoted
        y32 = dia.matvec(x)
        rel = float(jnp.max(jnp.abs(y16 - y32)) / jnp.max(jnp.abs(y32)))
        assert rel < 2e-2  # bf16 storage precision, not a logic error


class TestAdjointAndBounds:
    def test_adjoint_matches_dense_transpose(self):
        rng = np.random.default_rng(5)
        dia = banded_full(300, bandwidth=4, dtype=np.float64, seed=5)
        adj = dia.adjoint()
        d = np.asarray(dia.to_dense())
        np.testing.assert_allclose(np.asarray(adj.to_dense()), d.conj().T,
                                   rtol=1e-14)
        x = jnp.asarray(rng.standard_normal(300))
        np.testing.assert_allclose(np.asarray(adj.matvec(x)),
                                   np.asarray(dia.rmatvec(x)), rtol=1e-12)

    def test_adjoint_complex(self):
        from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
        rng = np.random.default_rng(6)
        n, offs = 50, (-3, 0, 2)
        data = np.zeros((3, n), np.complex128)
        for d, off in enumerate(offs):
            data[d] = rng.standard_normal(n) + 1j * rng.standard_normal(n)
            if off > 0:
                data[d, n - off:] = 0
            elif off < 0:
                data[d, :-off] = 0
        dia = SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))
        np.testing.assert_allclose(np.asarray(dia.adjoint().to_dense()),
                                   np.asarray(dia.to_dense()).conj().T,
                                   rtol=1e-14)

    def test_interleaved_adjoint(self):
        dia = banded_full(2000, bandwidth=3, dtype=np.float32, seed=7)
        il = dia.interleaved()
        adj = il.adjoint()
        x = jnp.asarray(np.random.default_rng(0).standard_normal(2000),
                        jnp.float32)
        y1 = np.asarray(il.decode_vec(adj.matvec(adj.encode_vec(x))))
        y2 = np.asarray(dia.rmatvec(x))
        np.testing.assert_allclose(y1, y2, rtol=1e-5, atol=1e-5)

    def test_spectral_bound_dominates(self):
        dia = banded_full(500, bandwidth=4, dtype=np.float64, seed=8)
        ev = np.linalg.eigvals(np.asarray(dia.to_dense()))
        bound = float(dia.spectral_bound())
        assert bound >= np.max(np.abs(ev)) - 1e-12
        il = dia.interleaved()
        np.testing.assert_allclose(float(il.spectral_bound()), bound,
                                   rtol=1e-6)
