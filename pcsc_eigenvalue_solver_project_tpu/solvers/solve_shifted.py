"""Shifted linear solve ``(A - shift*I) x = b``.

Reference parity (/root/reference/src/matrix/solve_shifted.hpp:48-118):
dense path forms ``M = A - shift*I`` and LU-solves (PartialPivLU,
:74-79); sparse path subtracts the shift on the diagonal and SparseLU-solves
(:96-115). Guards preserved: scalar-type mismatch (TypeError, :56-58),
non-square (ValueError, :67-69/:88-90), size mismatch (ValueError,
:70-72/:91-93).

Mapping: the dense LU runs as XLA's LU. For sparse operators
``method="auto"`` densifies small systems (one dense LU) and uses
Jacobi-preconditioned BiCGStab on the SpMV for large ones.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.precision import full_precision
from ..core.dtypes import check_scalar_type
from ..matrix.dense import DenseMatrix
from ..matrix.protocol import AbstractMatrix
from ..ops.krylov import solve_shifted_bicgstab

# Below this size a sparse system is densified and LU-solved.
DENSE_FALLBACK_MAX_N = 2048


@partial(jax.jit, static_argnames=())
def _dense_solve_shifted(a: jax.Array, shift: jax.Array, b: jax.Array) -> jax.Array:
    n = a.shape[0]
    m = a - shift * jnp.eye(n, dtype=a.dtype)
    return jnp.linalg.solve(m, b)


@partial(jax.jit, static_argnames=("tol", "maxiter"))
def _sparse_solve_shifted(M: AbstractMatrix, shift: jax.Array, b: jax.Array,
                          tol: float, maxiter: int) -> jax.Array:
    return solve_shifted_bicgstab(M.matvec, shift, b, diag=M.diagonal(),
                                  tol=tol, maxiter=maxiter)


@full_precision
def solve_shifted(M: AbstractMatrix, shift, b, *, dtype=None,
                  method: str = "auto", tol: float = 1e-12,
                  maxiter: int | None = None) -> jax.Array:
    """Solve ``(A - shift*I) x = b`` for a wrapped dense or sparse matrix."""
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "solve_shifted")
    b = jnp.asarray(b, M.dtype)
    if M.shape[0] != M.shape[1]:
        kind = "dense" if M.is_dense else "sparse"
        raise ValueError(f"solve_shifted: A must be square ({kind} case)")
    if M.shape[0] != b.shape[0]:
        kind = "dense" if M.is_dense else "sparse"
        raise ValueError(f"solve_shifted: size mismatch between A and b ({kind} case)")
    shift = jnp.asarray(shift, M.dtype)

    if M.is_dense:
        return _dense_solve_shifted(M.as_dense(), shift, b)

    if method == "auto":
        method = "dense_lu" if M.shape[0] <= DENSE_FALLBACK_MAX_N else "bicgstab"
    if method == "dense_lu":
        return _dense_solve_shifted(M.to_dense(), shift, b)
    if method == "bicgstab":
        n = M.shape[0]
        return _sparse_solve_shifted(M, shift, b, tol, maxiter if maxiter else 4 * n)
    if method == "gmres":
        from ..parallel.krylov import gmres
        diag = M.diagonal()
        d = diag - shift
        safe = jnp.where(d == 0, jnp.ones((), d.dtype), d)
        x, _, _ = gmres(lambda v: M.matvec(v) - shift * v, b,
                        vdot=jnp.vdot, norm=jnp.linalg.norm,
                        precond=lambda v: v / safe, tol=tol)
        return x
    raise ValueError(f"solve_shifted: unknown method {method!r}")
