"""Distributed shifted inverse power iteration.

The inner Krylov solve (parallel/krylov.py) is nested inside the outer
power loop (solvers/inverse_power.py:inverse_power_loop), both running on
row shards inside ONE jitted ``shard_map``: SpMVs exchange halos,
every scalar reduction is a ``psum``, convergence flags are replicated.
This replaces the reference's per-iteration SparseLU
refactorisation (shifted_inverse_power_solver.hpp:51 ->
solve_shifted.hpp:104-115) at scales where no dense factorisation is
possible.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.precision import full_precision
from ..core.options import ShiftedSolverOptions
from ..core.results import EigenResult
from ..solvers.inverse_power import inverse_power_loop
from ..utils.prng import default_key, random_unit_vector
from .mesh import ROW_AXIS
from .krylov import solve_shifted_distributed
from .sharded import (PartitionedELL, psum_norm, psum_vdot, spmv_all_gather,
                      spmv_halo)


@partial(jax.jit, static_argnames=("mesh", "axis", "exchange", "inner_maxiter"))
def _distributed_inverse_power(A: PartitionedELL, shift: jax.Array,
                               x0: jax.Array, max_iterations: jax.Array,
                               tol: jax.Array, inner_tol: jax.Array,
                               mesh: Mesh, axis: str, exchange: str,
                               inner_maxiter: int) -> EigenResult:
    body = spmv_halo if exchange == "halo" else spmv_all_gather
    rps = A.rows_per_shard

    def local_loop(data, indices, diag_local, x0_local):
        def matvec(x_local):
            return body(data, indices, x_local, axis=axis)

        vdot = lambda a, b: psum_vdot(a, b, axis=axis)
        nrm = lambda v: psum_norm(v, axis=axis)

        def solve(x_local):
            return solve_shifted_distributed(
                matvec, shift, x_local, vdot=vdot, norm=nrm, diag=diag_local,
                tol=inner_tol, maxiter=inner_maxiter)

        return inverse_power_loop(matvec, solve, vdot, nrm, x0_local,
                                  max_iterations, tol)

    # padded rows have zero diagonal; the Jacobi preconditioner divides by
    # (diag - shift), nonzero there as long as shift != 0 pads stay benign
    diag = _partitioned_diagonal(A)
    return jax.shard_map(
        local_loop, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        out_specs=EigenResult(eigenvalue=P(), eigenvector=P(axis),
                              iterations=P(), converged=P()),
    )(A.data, A.indices, diag, x0)


def _partitioned_diagonal(A: PartitionedELL) -> jax.Array:
    """Diagonal of the padded operator, row-sharded like the data."""
    n_pad, width = A.data.shape
    row_ids = jnp.arange(n_pad)[:, None]
    on_diag = A.indices == row_ids
    return jnp.sum(jnp.where(on_diag, A.data, 0), axis=1)


@full_precision
def distributed_shifted_inverse_power(A: PartitionedELL, mesh: Mesh,
                                      opts: ShiftedSolverOptions = ShiftedSolverOptions(),
                                      *, axis: str = ROW_AXIS,
                                      exchange: str = "auto", key=None,
                                      x0=None) -> EigenResult:
    """Eigenpair of the row-partitioned operator nearest ``opts.shift``."""
    if exchange == "auto":
        exchange = "halo" if A.halo_ok else "all_gather"
    n, n_pad = A.n_orig, A.n_padded
    if x0 is None:
        xh = np.asarray(random_unit_vector(key if key is not None else default_key(),
                                           n, A.dtype))
    else:
        xh = np.asarray(x0, dtype=A.dtype)
        nrm = np.linalg.norm(xh)
        if nrm != 0:
            xh = xh / nrm
    xp = np.zeros(n_pad, dtype=A.dtype)
    xp[:n] = xh
    x0_sharded = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(axis)))

    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    inner_maxiter = opts.inner_max_iterations or 4 * n_pad
    return _distributed_inverse_power(
        A, jnp.asarray(opts.shift, A.dtype), x0_sharded,
        jnp.asarray(opts.max_iterations, jnp.int32),
        jnp.asarray(opts.tolerance, ftype),
        jnp.asarray(opts.inner_tolerance, ftype),
        mesh, axis, exchange, inner_maxiter)
