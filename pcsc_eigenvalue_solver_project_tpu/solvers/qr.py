"""Householder QR decomposition.

Reference parity (/root/reference/src/qr_method/qr_decompose.hpp:25-132):
``A = Q R`` for any m x n dense matrix via Householder reflectors with the
complex phase-correct sign, skip rules for already-eliminated columns, and
accumulation of the full m x m unitary Q. Empty input raises (:38-40); the
wrapper is dense-only (:110-112) and returns ``(Q, R)``.

Same structure as the Hessenberg reduction: ``lax.fori_loop`` over
columns with full-size masked reflectors, every update a fixed-shape outer
product and every matrix-vector product at ``HIGHEST`` precision. This
routine exists for exact reference-behavior parity (the parity-mode QR
iteration) and for the (Q, R) public API.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.dtypes import check_scalar_type, real_dtype_of
from ..matrix.protocol import AbstractMatrix

_HI = jax.lax.Precision.HIGHEST


@jax.jit
def qr_decompose_dense(a: jax.Array):
    """Householder QR of an m x n dense matrix; returns (Q, R)."""
    m, n = a.shape
    if m == 0 or n == 0:
        raise ValueError("qr_decompose_dense: empty matrix")
    dtype = a.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))
    row_idx = jnp.arange(m)
    col_idx = jnp.arange(n)
    kmax = min(m, n)

    def body(k, carry):
        Q, R = carry
        col = R[:, k]
        x = jnp.where(row_idx >= k, col, jnp.zeros((), dtype))
        norm_x = jnp.linalg.norm(x).astype(rdt)
        tail_zero = jnp.linalg.norm(jnp.where(row_idx >= k + 1, col, jnp.zeros((), dtype))) == 0

        x0 = col[k]
        sign = jnp.where(x0 != 0, x0 / jnp.abs(x0).astype(dtype), jnp.ones((), dtype))
        alpha = -sign * norm_x.astype(dtype)

        v = x.at[k].add(-alpha)
        vnorm = jnp.linalg.norm(v).astype(rdt)
        degenerate = vnorm == 0
        v = v / jnp.where(degenerate, jnp.ones((), rdt), vnorm).astype(dtype)

        # R(k:, k:) -= 2 v (v^H R)  (qr_decompose.hpp:77-79)
        w = jnp.matmul(jnp.conj(v), R, precision=_HI)
        w = jnp.where(col_idx >= k, w, jnp.zeros((), dtype))
        R1 = R - 2.0 * jnp.outer(v, w)
        # Q(:, k:) -= 2 (Q v) v^H  (qr_decompose.hpp:82-84)
        u = jnp.matmul(Q, v, precision=_HI)
        Q1 = Q - 2.0 * jnp.outer(u, jnp.conj(v))

        skip = jnp.logical_or(tail_zero, degenerate)
        return (jnp.where(skip, Q, Q1), jnp.where(skip, R, R1))

    Q0 = jnp.eye(m, dtype=dtype)
    Q, R = jax.lax.fori_loop(0, kmax, body, (Q0, a))
    return Q, R


def qr_decompose(M: AbstractMatrix, *, dtype=None):
    """Wrapper with the reference's dense-only and scalar-type guards."""
    if not M.is_dense:
        raise ValueError("qr_decompose: only dense matrices are supported")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "qr_decompose")
    return qr_decompose_dense(jnp.asarray(M.as_dense()))
