"""Shifted inverse power iteration — eigenvalue nearest the shift.

Reference parity (/root/reference/src/power_method/
shifted_inverse_power_solver.hpp:21-125): each iteration solves
``(A - shift*I) y = x`` (:51), normalises, and takes the Rayleigh quotient
on A (:62); stopping, breakdown, and iteration-count semantics match the
power method. The shift is FIXED (no Rayleigh-quotient-iteration update).

Improvements over the reference:

- The reference re-runs a full LU factorisation EVERY outer iteration
  because its ``solve_shifted`` is stateless (solve_shifted.hpp:78,104-115
  called from the loop at shifted_inverse_power_solver.hpp:51). The shift
  is fixed, so here the dense path factorises ``A - shift*I`` ONCE outside
  the loop (``lu_factor``) and back-substitutes per iteration — identical
  numerics, O(n^3) -> O(n^2) per iteration.
- Sparse path: small systems densify (one dense LU), large ones run
  Jacobi-preconditioned BiCGStab or restarted GMRES on the SpMV inside
  the jitted outer loop (an inner Krylov loop nested in the outer power
  loop, both on device).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..core.precision import full_precision
from ..core.dtypes import check_scalar_type, real_dtype_of
from ..core.options import ShiftedSolverOptions
from ..core.results import EigenResult
from ..core.tolerance import is_close_relative
from ..matrix.protocol import (AbstractMatrix, decode_result,
                               require_nonempty, require_square)
from ..ops.krylov import solve_shifted_bicgstab
from ..utils.prng import default_key, random_unit_vector

# Sparse systems up to this size are densified and LU-factorised once.
DENSE_FALLBACK_MAX_N = 2048


def inverse_power_loop(matvec, solve, vdot, norm, x0: jax.Array,
                       max_iterations, tol) -> EigenResult:
    """Generic shifted-inverse-power ``lax.while_loop`` kernel; the
    distributed path (parallel/inverse_power.py) injects psum-based
    ``vdot``/``norm`` and a Krylov ``solve`` running on shards."""
    dtype = x0.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))

    def cond(c):
        k, x, lam, initialized, converged, used, done = c
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        k, x, lam, initialized, converged, used, done = c
        y = solve(x)  # (A - shift I) y = x   (shifted_inverse_power_solver.hpp:51)
        norm_y = norm(y).astype(rdt)
        # breakdown also covers a non-finite inner solve (Krylov breakdown
        # on near-singular A - shift*I): keep the previous iterate and
        # report converged=False rather than poisoning the result with NaN
        breakdown = jnp.logical_or(norm_y == 0,
                                   jnp.logical_not(jnp.isfinite(norm_y)))
        safe = jnp.where(breakdown, jnp.ones((), rdt), norm_y).astype(dtype)
        x_new = y / safe
        lam_new = vdot(x_new, matvec(x_new))  # Rayleigh quotient on A (:62)
        conv_now = jnp.logical_and(initialized, is_close_relative(lam_new, lam, tol))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        return (
            k + 1,
            jnp.where(breakdown, x, x_new),
            jnp.where(breakdown, lam, lam_new),
            jnp.logical_or(initialized, jnp.logical_not(breakdown)),
            jnp.logical_or(converged, conv_now),
            k + 1,
            jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)),
        )

    init = (
        jnp.zeros((), jnp.int32),
        x0,
        jnp.zeros((), dtype),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((), jnp.int32),
        jnp.asarray(False),
    )
    k, x, lam, initialized, converged, used, done = jax.lax.while_loop(cond, body, init)
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used, converged=converged)


@jax.jit
def _inverse_power_dense(a: jax.Array, shift: jax.Array, x0: jax.Array,
                         max_iterations: jax.Array, tol: jax.Array) -> EigenResult:
    from ..matrix.dense import DenseMatrix
    n = a.shape[0]
    m = a - shift * jnp.eye(n, dtype=a.dtype)
    lu, piv = jsl.lu_factor(m)  # factorise ONCE (shift is fixed)

    def solve(x):
        return jsl.lu_solve((lu, piv), x)

    return inverse_power_loop(DenseMatrix(a).matvec, solve, jnp.vdot,
                              jnp.linalg.norm, x0, max_iterations, tol)


@partial(jax.jit, static_argnames=("inner_maxiter",))
def _inverse_power_krylov(M: AbstractMatrix, shift: jax.Array, x0: jax.Array,
                          max_iterations: jax.Array, tol: jax.Array,
                          inner_tol: jax.Array, inner_maxiter: int) -> EigenResult:
    # x0 arrives in the operator's vector domain (see the caller); the
    # diagonal is encoded to match. Padding positions of an interleaved
    # layout stay an invariant zero subspace of (A - shift*I) restricted to
    # zero-padded right-hand sides, so BiCGStab never excites them.
    diag = M.encode_vec(M.diagonal())

    def solve(x):
        return solve_shifted_bicgstab(M.matvec, shift, x, diag=diag,
                                      tol=inner_tol, maxiter=inner_maxiter)

    return inverse_power_loop(M.matvec, solve, jnp.vdot, jnp.linalg.norm,
                              x0, max_iterations, tol)


@partial(jax.jit, static_argnames=("inner_m",))
def _inverse_power_gmres(M: AbstractMatrix, shift: jax.Array, x0: jax.Array,
                         max_iterations: jax.Array, tol: jax.Array,
                         inner_tol: jax.Array, inner_m: int) -> EigenResult:
    """Restarted-GMRES inner solve: more robust than BiCGStab on
    nonsymmetric near-singular ``A - shift*I`` (the regime of interior
    shifts, where BiCGStab's rho-breakdown produces NaN directions)."""
    from ..parallel.krylov import gmres
    diag = M.encode_vec(M.diagonal())
    d = diag - shift
    safe = jnp.where(d == 0, jnp.ones((), d.dtype), d)

    def shifted_mv(v):
        return M.matvec(v) - shift * v

    def solve(x):
        # a handful of restarts suffices: the outer iteration only needs
        # the inverse-iteration DIRECTION, not a tight linear solve
        y, _, _ = gmres(shifted_mv, x, vdot=jnp.vdot, norm=jnp.linalg.norm,
                        m=inner_m, tol=inner_tol, max_restarts=4,
                        precond=lambda v: v / safe)
        return y

    return inverse_power_loop(M.matvec, solve, jnp.vdot, jnp.linalg.norm,
                              x0, max_iterations, tol)


@partial(jax.jit, static_argnames=("inner_maxiter", "inner_method"))
def _inverse_power_splitc(M, shift_p: jax.Array, x0_p: jax.Array,
                          max_iterations: jax.Array, tol: jax.Array,
                          inner_tol: jax.Array, inner_maxiter: int,
                          inner_method: str = "bicgstab") -> EigenResult:
    """Split-plane complex shifted inverse power on (2, n) re/im planes.
    Inner solve is the plane BiCGStab or
    restarted plane GMRES (ops/split_krylov.py); outer loop mirrors the
    reference semantics."""
    from ..ops.split_complex import (splitc_is_close_relative, splitc_norm,
                                     splitc_vdot)
    from ..ops.split_krylov import (solve_shifted_splitc,
                                    solve_shifted_splitc_gmres)
    rdt = x0_p.dtype
    diag = M.encode_vec(M.diagonal_planes())

    if inner_method == "gmres":
        # Interior shifts make (A - sigma I) indefinite — its spectrum
        # surrounds the origin and restarted GMRES with a small basis
        # stagnates (measured: m=30/60 stall at ~0.4 relative residual on
        # a 500-row banded case; m >= n/3 converges). Scale the basis
        # with n, capped to keep the (m+1, 2, n) basis affordable.
        n_ = int(x0_p.shape[-1])
        gm = max(2, min(max(30, n_ // 3), 180, n_))
        restarts = max(-(-inner_maxiter // gm), 2)

        def solve(x):
            return solve_shifted_splitc_gmres(M.matvec, shift_p, x,
                                              diag=diag, tol=inner_tol,
                                              m=gm, max_restarts=restarts)
    else:
        def solve(x):
            return solve_shifted_splitc(M.matvec, shift_p, x, diag=diag,
                                        tol=inner_tol, maxiter=inner_maxiter)

    def cond(c):
        k, x, lam, initialized, converged, used, done = c
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        k, x, lam, initialized, converged, used, done = c
        y = solve(x)
        norm_y = splitc_norm(y)
        breakdown = jnp.logical_or(norm_y == 0,
                                   jnp.logical_not(jnp.isfinite(norm_y)))
        safe = jnp.where(breakdown, jnp.ones((), rdt), norm_y)
        x_new = y / safe
        lam_new = splitc_vdot(x_new, M.matvec(x_new))
        conv_now = jnp.logical_and(initialized,
                                   splitc_is_close_relative(lam_new, lam, tol))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        return (
            k + 1,
            jnp.where(breakdown, x, x_new),
            jnp.where(breakdown, lam, lam_new),
            jnp.logical_or(initialized, jnp.logical_not(breakdown)),
            jnp.logical_or(converged, conv_now),
            k + 1,
            jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)),
        )

    init = (jnp.zeros((), jnp.int32), x0_p, jnp.zeros((2,), rdt),
            jnp.asarray(False), jnp.asarray(False), jnp.zeros((), jnp.int32),
            jnp.asarray(False))
    k, x, lam, initialized, converged, used, done = jax.lax.while_loop(
        cond, body, init)
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used,
                       converged=converged)


@jax.jit
def _inverse_power_splitc_dense(pl: jax.Array, shift_p: jax.Array,
                                x0_p: jax.Array, max_iterations: jax.Array,
                                tol: jax.Array) -> EigenResult:
    """Dense split-plane path: ``(A - shift I)`` as the equivalent REAL
    2n x 2n block system [[R, -I_m], [I_m, R]] (R/I_m = re/im of the
    shifted matrix), LU-factorised ONCE — the split-plane analogue of the
    reference's PartialPivLU path (solve_shifted.hpp:74-79)."""
    from ..ops.split_complex import (splitc_is_close_relative, splitc_norm,
                                     splitc_vdot)
    rdt = x0_p.dtype
    n = pl.shape[1]
    eye = jnp.eye(n, dtype=rdt)
    Rr = pl[0] - shift_p[0] * eye
    Ri = pl[1] - shift_p[1] * eye
    B = jnp.block([[Rr, -Ri], [Ri, Rr]])
    lu, piv = jsl.lu_factor(B)

    def solve(x):
        y = jsl.lu_solve((lu, piv), jnp.concatenate([x[0], x[1]]))
        return jnp.stack([y[:n], y[n:]])

    def matvec(x):
        return jnp.stack([pl[0] @ x[0] - pl[1] @ x[1],
                          pl[0] @ x[1] + pl[1] @ x[0]])

    def cond(c):
        k, x, lam, initialized, converged, used, done = c
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        k, x, lam, initialized, converged, used, done = c
        y = solve(x)
        norm_y = splitc_norm(y)
        breakdown = jnp.logical_or(norm_y == 0,
                                   jnp.logical_not(jnp.isfinite(norm_y)))
        safe = jnp.where(breakdown, jnp.ones((), rdt), norm_y)
        x_new = y / safe
        lam_new = splitc_vdot(x_new, matvec(x_new))
        conv_now = jnp.logical_and(initialized,
                                   splitc_is_close_relative(lam_new, lam, tol))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        return (
            k + 1,
            jnp.where(breakdown, x, x_new),
            jnp.where(breakdown, lam, lam_new),
            jnp.logical_or(initialized, jnp.logical_not(breakdown)),
            jnp.logical_or(converged, conv_now),
            k + 1,
            jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)),
        )

    init = (jnp.zeros((), jnp.int32), x0_p, jnp.zeros((2,), rdt),
            jnp.asarray(False), jnp.asarray(False), jnp.zeros((), jnp.int32),
            jnp.asarray(False))
    k, x, lam, initialized, converged, used, done = jax.lax.while_loop(
        cond, body, init)
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used,
                       converged=converged)


@full_precision
def shifted_inverse_power_split_complex(M, opts: ShiftedSolverOptions = ShiftedSolverOptions(),
                                        *, key=None, x0=None) -> EigenResult:
    """Eigenpair nearest ``opts.shift`` of a split-plane complex banded
    operator (``SplitComplexDIA`` / ``InterleavedSplitComplexDIA``).
    ``eigenvalue`` comes back as a (2,) plane scalar and ``eigenvector``
    as (2, n) planes — convert with ``ops.split_complex.from_planes``."""
    import numpy as _np
    n = M.shape[0]
    if M.shape[0] != M.shape[1]:
        raise ValueError("shifted_inverse_power_method: matrix must be square")
    if n == 0:
        raise ValueError("shifted_inverse_power_method: matrix has zero size")
    rdt = jnp.dtype(M.dtype)
    if x0 is None:
        x0 = jax.random.uniform(key if key is not None else default_key(),
                                (2, n), rdt, minval=-1.0, maxval=1.0)
        nrm = jnp.sqrt(jnp.sum(x0 * x0))
        x0 = x0 / jnp.where(nrm == 0, 1, nrm)
    else:
        x0 = jnp.asarray(x0, rdt)
        if x0.shape != (2, n):
            raise ValueError(
                "shifted_inverse_power_split_complex: x0 must be (2, n) planes")
        nrm = jnp.sqrt(jnp.sum(x0 * x0))
        x0 = jnp.where(nrm == 0, x0, x0 / jnp.where(nrm == 0, 1, nrm))
    sh = complex(opts.shift)
    shift_p = jnp.asarray(_np.array([sh.real, sh.imag]), rdt)
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    max_it = jnp.asarray(opts.max_iterations, jnp.int32)
    tol = jnp.asarray(opts.tolerance, ftype)
    method = opts.inner_method
    if method == "auto":
        method = "dense_lu" if n <= DENSE_FALLBACK_MAX_N else "bicgstab"
    if method == "dense_lu":
        from ..matrix.split_complex import SplitComplexDIA
        nat = M if isinstance(M, SplitComplexDIA) else M.to_natural()
        return _inverse_power_splitc_dense(nat.to_dense_planes(), shift_p,
                                           x0, max_it, tol)
    if method not in ("bicgstab", "gmres"):
        raise ValueError(
            f"shifted_inverse_power_method: split-complex operators support "
            f"inner_method 'auto' | 'dense_lu' | 'bicgstab' | 'gmres', "
            f"got {method!r}")
    inner_maxiter = opts.inner_max_iterations or 4 * n
    r = _inverse_power_splitc(M, shift_p, M.encode_vec(x0), max_it, tol,
                              jnp.asarray(opts.inner_tolerance, ftype),
                              inner_maxiter, inner_method=method)
    return decode_result(M, r)


@jax.jit
def _rqi_dense(a: jax.Array, shift0: jax.Array, x0: jax.Array,
               max_iterations: jax.Array, tol: jax.Array) -> EigenResult:
    n = a.shape[0]
    dtype = a.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))
    eye = jnp.eye(n, dtype=dtype)

    def cond(c):
        k, x, lam, shift, initialized, converged, used, done = c
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        k, x, lam, shift, initialized, converged, used, done = c
        y = jnp.linalg.solve(a - shift * eye, x)
        norm_y = jnp.linalg.norm(y).astype(rdt)
        breakdown = jnp.logical_or(norm_y == 0,
                                   jnp.logical_not(jnp.isfinite(norm_y)))
        safe = jnp.where(breakdown, jnp.ones((), rdt), norm_y).astype(dtype)
        x_new = y / safe
        lam_new = jnp.vdot(x_new, a @ x_new)
        conv_now = jnp.logical_and(initialized,
                                   is_close_relative(lam_new, lam, tol))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        return (
            k + 1,
            jnp.where(breakdown, x, x_new),
            jnp.where(breakdown, lam, lam_new),
            jnp.where(breakdown, shift, lam_new),  # Rayleigh update
            jnp.logical_or(initialized, jnp.logical_not(breakdown)),
            jnp.logical_or(converged, conv_now),
            k + 1,
            jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)),
        )

    init = (jnp.zeros((), jnp.int32), x0, jnp.zeros((), dtype), shift0,
            jnp.asarray(False), jnp.asarray(False), jnp.zeros((), jnp.int32),
            jnp.asarray(False))
    k, x, lam, shift, initialized, converged, used, done = \
        jax.lax.while_loop(cond, body, init)
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used,
                       converged=converged)


@full_precision
def rayleigh_quotient_iteration(M: AbstractMatrix,
                                opts: ShiftedSolverOptions = ShiftedSolverOptions(),
                                *, dtype=None, key=None, x0=None) -> EigenResult:
    """Rayleigh-quotient iteration — the shift UPDATES each step.

    A superset of the reference's fixed-shift method (the survey notes the
    reference has 'no Rayleigh-quotient-iteration update',
    shifted_inverse_power_solver.hpp docs): cubic local convergence at the
    price of a fresh factorisation per iteration (which the reference paid
    anyway). Dense operators only (the moving shift defeats Krylov
    preconditioning at small sizes; sparse callers should densify or use
    the fixed-shift method).
    """
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "rayleigh_quotient_iteration")
    require_square(M, "rayleigh_quotient_iteration")
    require_nonempty(M, "rayleigh_quotient_iteration")
    n = M.shape[0]
    if x0 is None:
        x0 = random_unit_vector(key if key is not None else default_key(), n, M.dtype)
    else:
        x0 = jnp.asarray(x0, M.dtype)
        nrm = jnp.linalg.norm(x0)
        x0 = jnp.where(nrm == 0, x0, x0 / jnp.where(nrm == 0, 1, nrm).astype(M.dtype))
    a = M.to_dense() if not M.is_dense else M.as_dense()
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return _rqi_dense(a, jnp.asarray(opts.shift, M.dtype), x0,
                      jnp.asarray(opts.max_iterations, jnp.int32),
                      jnp.asarray(opts.tolerance, ftype))


@full_precision
def shifted_inverse_power_method(M: AbstractMatrix,
                                 opts: ShiftedSolverOptions = ShiftedSolverOptions(),
                                 *, dtype=None, key=None, x0=None) -> EigenResult:
    """Eigenpair nearest ``opts.shift`` via shifted inverse iteration."""
    from ..matrix.split_complex import (InterleavedSplitComplexDIA,
                                        SplitComplexDIA)
    if isinstance(M, (SplitComplexDIA, InterleavedSplitComplexDIA)):
        return shifted_inverse_power_split_complex(M, opts, key=key, x0=x0)
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "shifted_inverse_power_method")
    require_square(M, "shifted_inverse_power_method")
    require_nonempty(M, "shifted_inverse_power_method")
    n = M.shape[0]
    vec_dt = jnp.promote_types(M.dtype, jnp.float32)  # bf16 ops iterate in f32
    if x0 is None:
        x0 = random_unit_vector(key if key is not None else default_key(), n, vec_dt)
    else:
        x0 = jnp.asarray(x0, vec_dt)
        nrm = jnp.linalg.norm(x0)
        x0 = jnp.where(nrm == 0, x0, x0 / jnp.where(nrm == 0, 1, nrm).astype(vec_dt))
    shift = jnp.asarray(opts.shift, vec_dt)
    # All option scalars ride as traced values: changing the shift,
    # tolerance, or iteration caps never retriggers compilation.
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    max_it = jnp.asarray(opts.max_iterations, jnp.int32)
    tol = jnp.asarray(opts.tolerance, ftype)
    method = opts.inner_method
    if M.is_dense:
        return _inverse_power_dense(M.as_dense(), shift, x0, max_it, tol)
    if method == "auto":
        method = "dense_lu" if n <= DENSE_FALLBACK_MAX_N else "bicgstab"
    if method == "dense_lu":
        return _inverse_power_dense(M.to_dense(), shift, x0, max_it, tol)
    if method == "bicgstab":
        inner_maxiter = opts.inner_max_iterations or 4 * n
        r = _inverse_power_krylov(M, shift, M.encode_vec(x0), max_it, tol,
                                  jnp.asarray(opts.inner_tolerance, ftype),
                                  inner_maxiter)
        return decode_result(M, r)
    if method == "gmres":
        inner_m = min(opts.inner_max_iterations or 40, n)
        r = _inverse_power_gmres(M, shift, M.encode_vec(x0), max_it, tol,
                                 jnp.asarray(opts.inner_tolerance, ftype),
                                 inner_m)
        return decode_result(M, r)
    raise ValueError(f"shifted_inverse_power_method: unknown inner method {method!r}")
