"""Distributed DIA (banded halo) operator tests on the fake mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pcsc_eigenvalue_solver_project_tpu import SolverOptions, power_method
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import (
    banded_full, laplacian_1d)
from pcsc_eigenvalue_solver_project_tpu.parallel.dia import (
    distributed_dia_matvec, distributed_dia_power_method, partition_dia)
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_row_mesh(8)


class TestPartitionedDIA:
    def test_matvec_matches_sequential(self, mesh):
        n = 96
        m = SparseDIA.from_csr(laplacian_1d(n))
        A = partition_dia(m, mesh)
        rng = np.random.default_rng(0)
        x = np.zeros(A.n_padded)
        x[:n] = rng.random(n)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("rows")))
        y = np.asarray(distributed_dia_matvec(A, xs, mesh))
        expected = np.asarray(m.matvec(jnp.asarray(x[:n])))
        np.testing.assert_allclose(y[:n], expected, rtol=1e-13)
        np.testing.assert_allclose(y[n:], 0.0)

    @pytest.mark.slow
    def test_wide_band(self, mesh):
        # bandwidth close to rows_per_shard exercises deep halos
        n = 128
        m = banded_full(n, bandwidth=10, dtype=np.float64, seed=3)
        A = partition_dia(m, mesh)
        rng = np.random.default_rng(1)
        x = rng.random(A.n_padded)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("rows")))
        y = np.asarray(distributed_dia_matvec(A, xs, mesh))
        expected = np.asarray(m.matvec(jnp.asarray(x[:n])))
        np.testing.assert_allclose(y[:n], expected, rtol=1e-12)

    def test_bandwidth_exceeds_shard_rejected(self, mesh):
        m = banded_full(64, bandwidth=10, dtype=np.float64, seed=4)  # rps=8
        with pytest.raises(ValueError, match="bandwidth .10. exceeds rows per shard"):
            partition_dia(m, mesh)

    def test_power_matches_single_chip(self, mesh, key):
        n = 96
        m = SparseDIA.from_csr(laplacian_1d(n))
        A = partition_dia(m, mesh)
        x0 = np.asarray(jax.random.uniform(key, (n,), jnp.float64, minval=-1, maxval=1))
        seq = power_method(m, SolverOptions(tolerance=1e-10), x0=x0)
        dist = distributed_dia_power_method(A, mesh, SolverOptions(tolerance=1e-10),
                                            x0=x0)
        np.testing.assert_allclose(complex(dist.eigenvalue), complex(seq.eigenvalue),
                                   rtol=1e-10)
        assert int(dist.iterations) == int(seq.iterations)
        assert bool(dist.converged) == bool(seq.converged)

    def test_non_divisible(self, mesh, key):
        n = 50
        m = banded_full(n, bandwidth=2, dtype=np.float64, seed=5, diag_boost=4.0)
        A = partition_dia(m, mesh)
        res = distributed_dia_power_method(A, mesh, SolverOptions(tolerance=1e-10),
                                           key=key)
        seq = power_method(m, SolverOptions(tolerance=1e-10), key=key)
        np.testing.assert_allclose(complex(res.eigenvalue), complex(seq.eigenvalue),
                                   rtol=1e-8)


class TestPartitionedILDIA:
    """Interleaved distributed path: seam-lane ppermute halo, layout codec,
    power-method parity with the row-major distributed path."""

    def test_matvec_matches_single_chip(self, mesh):
        from pcsc_eigenvalue_solver_project_tpu.parallel.dia import (
            decode_vec_il_sharded, distributed_dia_il_matvec,
            encode_vec_il_sharded, partition_dia_il)
        n = 6000
        dia = banded_full(n, bandwidth=5, dtype=np.float32, seed=6)
        A = partition_dia_il(dia, mesh)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(n).astype(np.float32)
        x_il = encode_vec_il_sharded(x, A, mesh)
        y = decode_vec_il_sharded(distributed_dia_il_matvec(A, x_il, mesh), A)
        y_ref = np.asarray(dia.matvec(jnp.asarray(x)))
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)

    def test_codec_roundtrip(self, mesh):
        from pcsc_eigenvalue_solver_project_tpu.parallel.dia import (
            decode_vec_il_sharded, encode_vec_il_sharded, partition_dia_il)
        n = 5003  # odd: padding spread over trailing shard
        dia = banded_full(n, bandwidth=2, dtype=np.float32, seed=1)
        A = partition_dia_il(dia, mesh)
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        x2 = decode_vec_il_sharded(encode_vec_il_sharded(x, A, mesh), A)
        np.testing.assert_array_equal(x2, x)

    def test_power_matches_row_major_distributed(self, mesh, key):
        from pcsc_eigenvalue_solver_project_tpu.parallel.dia import (
            decode_vec_il_sharded, distributed_dia_il_power_method,
            distributed_dia_power_method, partition_dia, partition_dia_il)
        n = 6000
        dia = banded_full(n, bandwidth=5, dtype=np.float32, seed=6)
        opts = SolverOptions(max_iterations=2000, tolerance=1e-7)
        r_il = distributed_dia_il_power_method(
            partition_dia_il(dia, mesh), mesh, opts, key=key)
        r_row = distributed_dia_power_method(
            partition_dia(dia, mesh), mesh, opts, key=key)
        assert bool(r_il.converged) and bool(r_row.converged)
        np.testing.assert_allclose(float(r_il.eigenvalue),
                                   float(r_row.eigenvalue), rtol=1e-4)

    def test_halo_exceeding_shard_raises(self, mesh):
        from pcsc_eigenvalue_solver_project_tpu.parallel.dia import partition_dia_il
        dia = banded_full(600, bandwidth=20, dtype=np.float32, seed=0)
        with pytest.raises(ValueError, match="halo"):
            # 8 shards x alignment 8 -> R = 8 rows/shard < pr = 24
            partition_dia_il(dia, mesh, tile_s=8)
