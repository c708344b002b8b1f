"""Distributed block (subspace) iteration — top-k eigenvalues with the
interleaved block SpMM across a row mesh.

The BASELINE 1M-row 'distributed power iteration + QR (top-k)' config with
block bandwidth economics: every sweep reads the sharded diagonals ONCE
for the whole block (ops/dia.py block SpMM), the
shard-boundary halo is two (nvec, pr, 1) seam-lane ppermutes, and
CholeskyQR2 orthonormalisation needs only psum'd (b, b) Gram matrices —
no distributed QR factorisation anywhere. Host checks Ritz values of the
replicated projected block between device chunks (same convergence
contract as solvers/subspace.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.precision import full_precision
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..core.tolerance import is_close_relative
from ..ops.dia import LANES, dia_matmat_il_window, il_window_halo
from ..utils.prng import default_key
from .mesh import ROW_AXIS


def _block_gram(Xf, Yf, axis):
    """psum'd (b, b) Gram: G[i, j] = <X_i, Y_j> over the sharded domain."""
    g = jnp.tensordot(jnp.conj(Xf), Yf, axes=[[1, 2], [1, 2]])
    return jax.lax.psum(g, axis)


def _cholqr2_rows_dist(Xf, axis):
    def one(Xc):
        G = _block_gram(Xc, Xc, axis)
        eps = jnp.asarray(1e-7 if Xc.dtype in (jnp.float32, jnp.complex64)
                          else 1e-14, G.dtype)
        G = G + eps * jnp.trace(G) * jnp.eye(G.shape[0], dtype=G.dtype)
        L = jnp.linalg.cholesky(G)
        sol = jax.scipy.linalg.solve_triangular(
            jnp.conj(L), Xc.reshape(Xc.shape[0], -1), lower=True)
        return sol.reshape(Xc.shape)

    return one(one(Xf))


@partial(jax.jit, static_argnames=("mesh", "axis", "sweeps"))
def _dist_subspace_chunk(A, Xf: jax.Array, sweeps: int, mesh: Mesh, axis: str):
    from .dia import dia_il_halo_window
    pr = il_window_halo(A.offsets)

    def local(data_il, Xl):
        def apply_block(Xc):
            w = jax.vmap(lambda v: dia_il_halo_window(v, pr, axis=axis))(Xc)
            return dia_matmat_il_window(data_il, A.offsets, w)

        def body(_, Xc):
            return _cholqr2_rows_dist(apply_block(Xc), axis)

        Xl = jax.lax.fori_loop(0, sweeps, body, Xl)
        B = _block_gram(Xl, apply_block(Xl), axis)
        return Xl, B

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis, None), P(None, axis, None)),
        out_specs=(P(None, axis, None), P()),
    )(A.data_il, Xf)


@full_precision
def distributed_subspace_iteration(A, mesh: Mesh, k: int = 4, *,
                                   block: int | None = None,
                                   opts: SolverOptions = SolverOptions(),
                                   sweeps_per_check: int = 10,
                                   axis: str = ROW_AXIS, key=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) of a ``PartitionedILDIA``
    operator via distributed block iteration."""
    n = A.n_orig
    if k < 1:
        raise ValueError("distributed_subspace_iteration: k must be >= 1")
    b = block if block is not None else min(max(k + 4, 8), n)
    if b < k:
        raise ValueError(
            f"distributed_subspace_iteration: block ({b}) must be >= k ({k})")

    vdt = np.dtype(jnp.promote_types(A.dtype, jnp.float32))
    p, R = A.n_shards, A.R
    rng_host = np.random.default_rng(
        np.asarray(jax.random.key_data(key if key is not None else default_key()))[-1])
    # host-built block: real rows random, padding rows zero
    Xh = np.zeros((b, p * R * LANES), vdt)
    Xh[:, :n] = rng_host.uniform(-1, 1, (b, n)).astype(vdt)
    X_il = Xh.reshape(b, p, LANES, R).transpose(0, 1, 3, 2).reshape(
        b, p * R, LANES)
    Xf = jax.device_put(jnp.asarray(X_il),
                        NamedSharding(mesh, P(None, axis, None)))

    prev = None
    total = 0
    converged = False
    ritz = np.zeros(k, np.complex128)
    max_checks = -(-opts.max_iterations // sweeps_per_check)
    for _ in range(max_checks):
        Xf, B = _dist_subspace_chunk(A, Xf, sweeps_per_check, mesh, axis)
        total += sweeps_per_check
        w = np.linalg.eigvals(np.asarray(jax.device_get(B)))
        w = w[np.argsort(-np.abs(w))][:k]
        if prev is not None:
            close = all(bool(is_close_relative(w[i], prev[i], opts.tolerance))
                        for i in range(k))
            if close:
                ritz = w
                converged = True
                break
        prev = w
        ritz = w
    return QRResult(eigenvalues=jnp.asarray(ritz),
                    iterations=jnp.asarray(total, jnp.int32),
                    converged=jnp.asarray(converged))
