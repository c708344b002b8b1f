"""Krylov linear solvers for shifted systems.

The reference solves ``(A - shift*I) x = b`` with dense ``PartialPivLU`` or
``SparseLU`` (reference src/matrix/solve_shifted.hpp:74-115). A
sequential sparse factorisation never crosses devices well, so the sparse
path here is an iterative Krylov
solve (BiCGStab) built on the SpMV protocol with Jacobi preconditioning;
near-singular ``A - shift*I`` (the interesting regime for inverse
iteration) is handled by capping iterations and accepting the direction,
which is all inverse iteration needs.

Single-chip solves delegate to ``jax.scipy.sparse.linalg.bicgstab``; the
distributed variant with explicit ``psum`` reductions lives in
``parallel/krylov.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def jacobi_preconditioner(diag: jax.Array):
    """Left preconditioner v -> v / diag with zero-diagonal safety."""
    safe = jnp.where(diag == 0, jnp.ones((), diag.dtype), diag)

    def apply(v):
        return v / safe

    return apply


def solve_shifted_bicgstab(matvec, shift, b, *, diag=None, tol=1e-12,
                           atol=0.0, maxiter=None):
    """Solve ``(A - shift*I) y = b`` where ``matvec(v) == A @ v``.

    Returns the solution iterate (converged or not — inverse iteration only
    needs the direction; see module docstring).
    """
    shift = jnp.asarray(shift, b.dtype)

    def shifted_mv(v):
        return matvec(v) - shift * v

    precond = None
    if diag is not None:
        precond = jacobi_preconditioner(diag - shift)

    y, _ = jax.scipy.sparse.linalg.bicgstab(
        shifted_mv, b, tol=tol, atol=atol, maxiter=maxiter, M=precond)
    return y
