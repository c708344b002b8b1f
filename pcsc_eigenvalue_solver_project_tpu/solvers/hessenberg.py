"""Hessenberg reduction via Householder similarity transforms.

Reference parity (/root/reference/src/qr_method/to_hessenberg.hpp:23-119):
per column k, build a reflector from the subcolumn below the diagonal with
the phase-correct sign ``x0/|x0|`` for complex scalars (:51-57), skip when
the column is already zero below the subdiagonal (:46-48) or the reflector
degenerates (:62-64), and apply the left (:69-71) and right (:74-76)
rank-1 similarity updates. Dense only — the wrapper raises for sparse
matrices exactly like the reference (:104-106).

Structure: a ``lax.fori_loop`` over columns with full-size masked updates —
the reflector ``v`` lives in a fixed length-n vector that is zero outside
rows k+1..n-1, so one compiled program serves every k. The matrix-vector
products run at ``HIGHEST`` precision: a float32 dot may otherwise run in
TF32 on the GPU, which keeps about three decimal digits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.dtypes import check_scalar_type, real_dtype_of
from ..matrix.protocol import AbstractMatrix

_HI = jax.lax.Precision.HIGHEST


def _reduce(a: jax.Array, with_q: bool):
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("hessenberg_dense: A must be square")
    dtype = a.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))
    idx = jnp.arange(n)
    zero = jnp.zeros((), dtype)

    def body(k, carry):
        H, Q = carry
        col = jax.lax.dynamic_index_in_dim(H, k, axis=1, keepdims=False)
        # x = H[k+1:, k] embedded in a full-length vector
        x = jnp.where(idx >= k + 1, col, zero)
        norm_x = jnp.linalg.norm(x).astype(rdt)
        tail_zero = jnp.linalg.norm(jnp.where(idx >= k + 2, col, zero)) == 0

        e_next = (idx == k + 1).astype(dtype)
        x0 = jnp.sum(col * e_next)
        sign = jnp.where(x0 != 0, x0 / jnp.abs(x0).astype(dtype), jnp.ones((), dtype))
        alpha = -sign * norm_x.astype(dtype)

        v = x - alpha * e_next
        vnorm = jnp.linalg.norm(v).astype(rdt)
        degenerate = vnorm == 0
        v = v / jnp.where(degenerate, jnp.ones((), rdt), vnorm).astype(dtype)

        # Left: H(k+1:, k:) -= 2 v (v^H H); v is zero outside rows k+1..,
        # the column mask restricts to cols >= k (to_hessenberg.hpp:69-71).
        w = jnp.matmul(jnp.conj(v), H, precision=_HI)
        w = jnp.where(idx >= k, w, zero)
        H1 = H - 2.0 * jnp.outer(v, w)
        # Right: H(:, k+1:) -= 2 (H v) v^H; v's sparsity restricts the cols.
        u = jnp.matmul(H1, v, precision=_HI)
        H2 = H1 - 2.0 * jnp.outer(u, jnp.conj(v))
        # the reflector annihilates H[k+2:, k]; store exact zeros there
        H2 = jnp.where((idx[:, None] >= k + 2) & (idx[None, :] == k), zero, H2)

        skip = jnp.logical_or(tail_zero, degenerate)
        if with_q:
            # A = Q H Q^H: Q(:, k+1:) -= 2 (Q v) v^H
            Q2 = Q - 2.0 * jnp.outer(jnp.matmul(Q, v, precision=_HI),
                                     jnp.conj(v))
            Q = jnp.where(skip, Q, Q2)
        return jnp.where(skip, H, H2), Q

    Q0 = jnp.eye(n, dtype=dtype) if with_q else jnp.zeros((0,), dtype)
    # k ranges over 0..n-3 (to_hessenberg.hpp:38); empty range for n <= 2.
    return jax.lax.fori_loop(0, max(n - 2, 0), body, (a, Q0))


@jax.jit
def hessenberg_dense(a: jax.Array) -> jax.Array:
    """Reduce a square dense matrix to upper Hessenberg form (similar to A)."""
    return _reduce(a, with_q=False)[0]


@jax.jit
def hessenberg_dense_q(a: jax.Array):
    """Hessenberg reduction that also accumulates the unitary:
    returns ``(H, Q)`` with ``A = Q H Q^H``."""
    return _reduce(a, with_q=True)


def to_hessenberg(M: AbstractMatrix, *, dtype=None) -> jax.Array:
    """Wrapper with the reference's dense-only and scalar-type guards."""
    if not M.is_dense:
        raise ValueError("to_hessenberg: only dense matrices are supported")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "to_hessenberg")
    if M.shape[0] != M.shape[1]:
        raise ValueError("to_hessenberg_dense: A must be square")
    return hessenberg_dense(jnp.asarray(M.as_dense()))
