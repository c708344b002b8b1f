"""Block (subspace) iteration — top-k eigenvalues with block SpMM.

Single-vector power iteration on a bandwidth-bound SpMV leaves the compute
units idle waiting on memory; iterating a BLOCK of b vectors reads the
operator once per b matvecs (the block SpMM of ops/dia.py), so throughput
per vector scales ~b-fold until compute-bound. Orthonormalisation uses
CholeskyQR2 — two passes of Gram + Cholesky + triangular solve, all
matmuls, no Householder loops — and convergence is checked on host between
device chunks via the Ritz values of the projected b x b block.

This is the dominant-subspace counterpart of Arnoldi: simpler, restart-free,
block-bandwidth-optimal; Arnoldi remains better for interior clusters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import full_precision
from ..core.dtypes import check_scalar_type
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..core.tolerance import is_close_relative
from ..matrix.dia import InterleavedDIA, SparseDIA
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..ops.dia import dia_matmat
from ..utils.prng import default_key


def _apply_block(M: AbstractMatrix, X: jax.Array) -> jax.Array:
    """A @ X for X (n, b): block-kernel for DIA, matmul for dense,
    vmapped matvec otherwise."""
    if isinstance(M, SparseDIA):
        return dia_matmat(M.data, M.offsets, X.T).T
    if M.is_dense:
        return M.as_dense() @ X
    return jax.vmap(M.matvec, in_axes=1, out_axes=1)(X)


def _cholqr2(X: jax.Array) -> jax.Array:
    """Orthonormalise columns via two rounds of Cholesky QR (matmuls only)."""
    def one(Xc):
        G = jnp.conj(Xc).T @ Xc
        eps = jnp.asarray(1e-7 if Xc.dtype in (jnp.float32, jnp.complex64)
                          else 1e-14, G.real.dtype if hasattr(G, "real") else G.dtype)
        G = G + eps * jnp.trace(G).real.astype(G.dtype) * jnp.eye(G.shape[0], dtype=G.dtype)
        L = jnp.linalg.cholesky(G)
        return jax.scipy.linalg.solve_triangular(jnp.conj(L), Xc.T, lower=True).T

    return one(one(X))


@partial(jax.jit, static_argnames=("sweeps",))
def _subspace_chunk(M: AbstractMatrix, X: jax.Array, sweeps: int):
    def body(_, Xc):
        return _cholqr2(_apply_block(M, Xc))

    X = jax.lax.fori_loop(0, sweeps, body, X)
    B = jnp.conj(X).T @ _apply_block(M, X)  # projected block (b, b)
    return X, B


# --- row-domain variant (InterleavedDIA fast path) -----------------------
# Block vectors live as Xf (b, N): each ROW is one flattened interleaved
# domain vector. Gram matrices and triangular combinations are permutation-
# invariant over N, so the CholeskyQR2 algebra transposes cleanly:
# Q = X L^{-H}  (columns)  <=>  Qf = conj(L)^{-1} Xf  (rows).


def _apply_block_rows(M: InterleavedDIA, Xf: jax.Array) -> jax.Array:
    b = Xf.shape[0]
    return M.matmat(Xf.reshape(b, M.R, -1)).reshape(b, -1)


def _cholqr2_rows(Xf: jax.Array) -> jax.Array:
    def one(Xc):
        G = jnp.conj(Xc) @ Xc.T
        eps = jnp.asarray(1e-7 if Xc.dtype in (jnp.float32, jnp.complex64)
                          else 1e-14, G.real.dtype if hasattr(G, "real") else G.dtype)
        G = G + eps * jnp.trace(G).real.astype(G.dtype) * jnp.eye(G.shape[0], dtype=G.dtype)
        L = jnp.linalg.cholesky(G)
        return jax.scipy.linalg.solve_triangular(jnp.conj(L), Xc, lower=True)

    return one(one(Xf))


@partial(jax.jit, static_argnames=("sweeps",))
def _subspace_chunk_rows(M: InterleavedDIA, Xf: jax.Array, sweeps: int):
    def body(_, Xc):
        return _cholqr2_rows(_apply_block_rows(M, Xc))

    Xf = jax.lax.fori_loop(0, sweeps, body, Xf)
    B = jnp.conj(Xf) @ _apply_block_rows(M, Xf).T
    return Xf, B


# --------------------------------------------------------------------------
# Chebyshev-filtered subspace iteration (ChASE-style accelerated mode).
# A degree-m Chebyshev polynomial mapped onto the UNWANTED spectral
# interval [a, b] damps it by ~1/cosh(m*acosh(gamma)) while amplifying
# everything above b — each sweep costs m block SpMMs (cheap: the block
# kernel reads the diagonals once per application) and converges like m
# plain sweeps squared-ish. Symmetric operators, largest-algebraic end.
# --------------------------------------------------------------------------


def _cheb_apply_block(apply, X, deg: int, c, e):
    """p(A) X via the three-term recurrence on the interval (c-e, c+e);
    both carries are rescaled together each step (the recurrence is
    linear, so joint scaling is exact) to keep f32 from overflowing at
    high amplification."""
    Y1 = (apply(X) - c * X) / e
    if deg <= 1:
        return Y1

    def body(_, carry):
        Ym1, Y = carry
        Yn = 2.0 * (apply(Y) - c * Y) / e - Ym1
        s = 1.0 / jnp.maximum(1.0, jnp.max(jnp.abs(Yn)))
        return (Y * s, Yn * s)

    _, Y = jax.lax.fori_loop(0, deg - 1, body, (X, Y1))
    return Y


@partial(jax.jit, static_argnames=("sweeps", "deg"))
def _subspace_chunk_cheb(M: AbstractMatrix, X: jax.Array, sweeps: int,
                         deg: int, a: jax.Array, b: jax.Array):
    c = (a + b) * 0.5
    e = (b - a) * 0.5

    def body(_, Xc):
        return _cholqr2(_cheb_apply_block(lambda Z: _apply_block(M, Z),
                                          Xc, deg, c, e))

    X = jax.lax.fori_loop(0, sweeps, body, X)
    B = jnp.conj(X).T @ _apply_block(M, X)  # Rayleigh-Ritz on A itself
    return X, B


@partial(jax.jit, static_argnames=("sweeps", "deg"))
def _subspace_chunk_cheb_rows(M, Xf: jax.Array, sweeps: int, deg: int,
                              a: jax.Array, b: jax.Array):
    c = (a + b) * 0.5
    e = (b - a) * 0.5

    def body(_, Xc):
        return _cholqr2_rows(_cheb_apply_block(
            lambda Z: _apply_block_rows(M, Z), Xc, deg, c, e))

    Xf = jax.lax.fori_loop(0, sweeps, body, Xf)
    B = jnp.conj(Xf) @ _apply_block_rows(M, Xf).T
    return Xf, B


@full_precision
def chebyshev_subspace_iteration(M: AbstractMatrix, k: int = 4, *,
                                 block: int | None = None, degree: int = 10,
                                 opts: SolverOptions = SolverOptions(),
                                 sweeps_per_check: int = 2,
                                 interval: tuple | None = None,
                                 dtype=None, key=None, X0=None) -> QRResult:
    """Top-``k`` ALGEBRAIC eigenvalues of a SYMMETRIC operator via
    Chebyshev-filtered block iteration.

    Each sweep applies a degree-``degree`` Chebyshev filter over the
    unwanted interval ``[lo, edge]`` (``lo`` from the operator's
    Gershgorin enclosure, ``edge`` re-estimated every check from the
    block's weakest Ritz value), so ``opts.max_iterations`` counts
    SWEEPS and each sweep costs ``degree`` block SpMMs. Typically
    converges in far fewer operator applications than plain block
    iteration once the wanted end is separated from the bulk.
    """
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "chebyshev_subspace_iteration")
    require_square(M, "chebyshev_subspace_iteration")
    require_nonempty(M, "chebyshev_subspace_iteration")
    n = M.shape[0]
    if k < 1:
        raise ValueError("chebyshev_subspace_iteration: k must be >= 1")
    if degree < 1:
        raise ValueError("chebyshev_subspace_iteration: degree must be >= 1")
    b_sz = block if block is not None else min(max(k + 4, 8), n)
    if b_sz < k:
        raise ValueError(
            f"chebyshev_subspace_iteration: block ({b_sz}) must be >= k ({k})")
    b_sz = min(b_sz, n)

    rows_mode = isinstance(M, InterleavedDIA)
    vec_dt = jnp.promote_types(M.dtype, jnp.float32)
    if np.dtype(vec_dt).kind == "c":
        raise ValueError("chebyshev_subspace_iteration: symmetric real "
                         "operators only (Hermitian complex: use lanczos)")
    if X0 is None:
        X = jax.random.uniform(key if key is not None else default_key(),
                               (n, b_sz), vec_dt, minval=-1.0, maxval=1.0)
    else:
        X = jnp.asarray(X0, vec_dt)
    if rows_mode:
        X = jax.vmap(M.encode_vec, in_axes=1)(X).reshape(b_sz, -1)
        X = _cholqr2_rows(X)
    else:
        X = _cholqr2(X)

    # spectrum enclosure for the filter's lower edge
    if interval is not None:
        lo, hi = float(interval[0]), float(interval[1])
        if not lo < hi:
            raise ValueError(
                f"chebyshev_subspace_iteration: interval must satisfy "
                f"lo < hi, got ({lo}, {hi})")
    elif hasattr(M, "gershgorin_interval"):
        g = M.gershgorin_interval()
        lo, hi = float(g[0]), float(g[1])
    else:
        rho = float(jnp.max(jnp.abs(M.to_dense()))) * n  # crude fallback
        lo, hi = -rho, rho
    span = hi - lo

    # bootstrap: one UNfiltered chunk to seed the edge estimate
    X, B = (_subspace_chunk_rows(M, X, sweeps_per_check) if rows_mode
            else _subspace_chunk(M, X, sweeps_per_check))
    w_all = np.sort(np.linalg.eigvalsh(np.asarray(jax.device_get(B))))
    total = sweeps_per_check
    prev = None
    converged = False
    ritz = w_all[::-1][:k]
    while total < opts.max_iterations:
        # damp everything below the block's weakest Ritz value (clamped
        # inside the enclosure so the filter interval never degenerates)
        edge = float(np.clip(w_all[0], lo + 1e-3 * span, hi - 1e-3 * span))
        a_t = jnp.asarray(lo, vec_dt)
        b_t = jnp.asarray(edge, vec_dt)
        X, B = (_subspace_chunk_cheb_rows(M, X, sweeps_per_check, degree,
                                          a_t, b_t) if rows_mode
                else _subspace_chunk_cheb(M, X, sweeps_per_check, degree,
                                          a_t, b_t))
        total += sweeps_per_check
        w_all = np.sort(np.linalg.eigvalsh(np.asarray(jax.device_get(B))))
        w = w_all[::-1][:k]
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


@full_precision
def subspace_iteration(M: AbstractMatrix, k: int = 4, *, block: int | None = None,
                       opts: SolverOptions = SolverOptions(), dtype=None,
                       sweeps_per_check: int = 10, key=None,
                       X0=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) via block iteration.

    ``block`` defaults to ``max(k + 4, 8)`` padded for kernel efficiency.
    Convergence: the top-k Ritz values of the projected block satisfy the
    reference relative criterion between consecutive checks.
    """
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "subspace_iteration")
    require_square(M, "subspace_iteration")
    require_nonempty(M, "subspace_iteration")
    n = M.shape[0]
    if k < 1:
        raise ValueError("subspace_iteration: k must be >= 1")
    b = block if block is not None else min(max(k + 4, 8), n)
    if b < k:
        raise ValueError(f"subspace_iteration: block ({b}) must be >= k ({k})")
    b = min(b, n)

    rows_mode = isinstance(M, InterleavedDIA)
    vec_dt = jnp.promote_types(M.dtype, jnp.float32)
    if X0 is None:
        X = jax.random.uniform(key if key is not None else default_key(),
                               (n, b), jnp.dtype(vec_dt)
                               if np.dtype(M.dtype).kind != "c" else jnp.float64,
                               minval=-1.0, maxval=1.0).astype(vec_dt)
    else:
        X = jnp.asarray(X0, vec_dt)
    if rows_mode:
        # encode each column into the interleaved domain, rows = vectors
        X = jax.vmap(M.encode_vec, in_axes=1)(X).reshape(b, -1)
        X = _cholqr2_rows(X)
    else:
        X = _cholqr2(X)

    prev = None
    total = 0
    converged = False
    ritz = np.zeros(k, np.complex128)
    max_checks = -(-opts.max_iterations // sweeps_per_check)
    for _ in range(max_checks):
        X, B = (_subspace_chunk_rows(M, X, sweeps_per_check) if rows_mode
                else _subspace_chunk(M, X, sweeps_per_check))
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
