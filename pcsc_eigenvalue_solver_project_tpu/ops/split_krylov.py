"""Split-plane complex Krylov solver — BiCGStab on (2, n) real planes.

The reference's complex shifted solve is ``Eigen::SparseLU`` over
``std::complex`` (/root/reference/src/matrix/solve_shifted.hpp:96-115).
Here it is BiCGStab (or restarted GMRES) with every scalar (rho, alpha,
omega) carried as a (2,) re/im plane pair and every vector as (2, n)
planes — the split representation of the split-complex operators
(ops/split_complex.py, ops/dia.py). All arithmetic is real jnp, so the
whole solve jits and nests inside the outer inverse-power
``while_loop``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.precision import full_precision
from .split_complex import splitc_mul, splitc_vdot


def splitc_dotu(a, b):
    """UNCONJUGATED bilinear form sum(a * b) over trailing axes — the
    classical choice for complex BiCG-family rho/alpha (the conjugated
    sesquilinear form loses the Lanczos biorthogonality that drives
    convergence; measured ~30x better residuals on nonsymmetric complex
    banded systems)."""
    re = jnp.sum(a[0] * b[0] - a[1] * b[1])
    im = jnp.sum(a[0] * b[1] + a[1] * b[0])
    return jnp.stack([re, im])


def _sx(s, v):
    """Reshape a (2,) plane scalar to broadcast over vector axes of v."""
    return s.reshape((2,) + (1,) * (v.ndim - 1))


def splitc_div(a, b):
    """Elementwise complex division of plane arrays: a / b, zero-safe
    (b == 0 positions divide by 1 instead — callers mask)."""
    denom = b[0] * b[0] + b[1] * b[1]
    safe = jnp.where(denom == 0, jnp.ones((), denom.dtype), denom)
    re = (a[0] * b[0] + a[1] * b[1]) / safe
    im = (a[1] * b[0] - a[0] * b[1]) / safe
    return jnp.stack([re, im])


@full_precision
def splitc_bicgstab(matvec, b, *, precond=None, tol=1e-10, maxiter=200):
    """Solve ``A x = b`` in split-plane form. ``matvec``/``precond`` map
    (2, n) -> (2, n); returns the final iterate (converged or not — the
    inverse-power caller only needs the direction). Breakdown (zero
    denominators, non-finite residual) freezes the iterate and exits.
    """
    K = precond if precond is not None else (lambda v: v)
    rdt = b.dtype
    b_p = K(b)
    bnorm = jnp.sqrt(jnp.sum(b_p * b_p))
    atol = tol * jnp.where(bnorm == 0, jnp.ones((), rdt), bnorm)

    one = jnp.zeros((2,), rdt).at[0].set(1.0)
    zero2 = jnp.zeros((2,), rdt)
    x0 = jnp.zeros_like(b)

    # carry: (x, r, rhat, p, v, rho, alpha, omega, k, done)
    init = (x0, b_p, b_p, jnp.zeros_like(b), jnp.zeros_like(b),
            one, one, one, jnp.zeros((), jnp.int32), jnp.asarray(False))

    def cond(c):
        *_, k, done = c
        return jnp.logical_and(k < maxiter, jnp.logical_not(done))

    def body(c):
        x, r, rhat, p, v, rho, alpha, omega, k, done = c
        rho_new = splitc_dotu(rhat, r)
        # beta = (rho_new / rho) * (alpha / omega)
        beta = splitc_mul(splitc_div(rho_new, rho), splitc_div(alpha, omega))
        brk = jnp.logical_or(jnp.all(rho == 0), jnp.all(omega == 0))
        p_new = r + splitc_mul(_sx(beta, p), p - splitc_mul(_sx(omega, v), v))
        v_new = K(matvec(p_new))
        rv = splitc_dotu(rhat, v_new)
        alpha_new = splitc_div(rho_new, rv)
        brk = jnp.logical_or(brk, jnp.all(rv == 0))
        s = r - splitc_mul(_sx(alpha_new, v_new), v_new)
        t = K(matvec(s))
        tt = splitc_vdot(t, t)
        omega_new = splitc_div(splitc_vdot(t, s), tt)
        brk = jnp.logical_or(brk, jnp.all(tt == 0))
        x_new = x + splitc_mul(_sx(alpha_new, p_new), p_new) \
                  + splitc_mul(_sx(omega_new, s), s)
        r_new = s - splitc_mul(_sx(omega_new, t), t)
        rnorm = jnp.sqrt(jnp.sum(r_new * r_new))
        bad = jnp.logical_not(jnp.isfinite(rnorm))
        conv = rnorm <= atol
        keep = jnp.logical_or(brk, bad)
        return (jnp.where(keep, x, x_new),
                jnp.where(keep, r, r_new),
                rhat,
                jnp.where(keep, p, p_new),
                jnp.where(keep, v, v_new),
                jnp.where(keep, rho, rho_new),
                jnp.where(keep, alpha, alpha_new),
                jnp.where(keep, omega, omega_new),
                k + 1,
                jnp.logical_or(done, jnp.logical_or(conv, keep)))

    x, *_ = jax.lax.while_loop(cond, body, init)
    return x


def solve_shifted_splitc(matvec, shift, b, *, diag=None, tol=1e-10,
                         maxiter=200):
    """Solve ``(A - shift*I) y = b`` in planes: ``shift`` is a (2,)
    complex-plane scalar, ``diag`` the (2, n) diagonal planes for Jacobi
    preconditioning."""
    def shifted_mv(v):
        return matvec(v) - splitc_mul(_sx(shift, v), v)

    precond = None
    if diag is not None:
        d = diag - _sx(shift, diag)
        dd = d[0] * d[0] + d[1] * d[1]
        one_plane = jnp.stack([jnp.ones_like(d[0]), jnp.zeros_like(d[1])])
        d = jnp.where(dd[None] == 0, one_plane, d)
        precond = lambda v: splitc_div(v, d)

    return splitc_bicgstab(shifted_mv, b, precond=precond, tol=tol,
                           maxiter=maxiter)


@full_precision
def splitc_gmres(matvec, b, *, precond=None, tol=1e-10, m=30,
                 max_restarts=None):
    """Restarted GMRES(m) in split-plane form: all Arnoldi vectors are
    (2, n) planes, the (m+1, m) complex Hessenberg least-squares is solved
    as the equivalent real 2(m+1) x 2m block system with XLA QR. Left
    Jacobi preconditioning like ``splitc_bicgstab``. Returns the final
    iterate (converged or not — the inverse-power caller only needs the
    direction).

    This is the robust inner method for interior complex shifts near an
    eigenvalue (the reference demo's sigma=2.3 case, main.cpp:87), where
    BiCGStab's short recurrence can stall on the near-singular
    ``A - sigma I``.
    """
    from .split_complex import splitc_norm

    K = precond if precond is not None else (lambda v: v)
    rdt = b.dtype
    n = b.shape[-1]
    if max_restarts is None:
        max_restarts = max(-(-4 * n // m), 8)

    def op(v):
        return K(matvec(v))

    b_p = K(b)
    bnorm = splitc_norm(b_p)
    atol = tol * jnp.where(bnorm == 0, jnp.ones((), rdt), bnorm)
    idx_basis = jnp.arange(m + 1)

    def arnoldi(r, beta):
        V0 = jnp.zeros((m + 1, 2, n), rdt)
        safe_b = jnp.where(beta == 0, jnp.ones((), rdt), beta)
        V0 = V0.at[0].set(r / safe_b)
        Hr0 = jnp.zeros((m + 1, m), rdt)
        Hi0 = jnp.zeros((m + 1, m), rdt)

        def body(j, carry):
            V, Hr, Hi = carry
            vj = jax.lax.dynamic_index_in_dim(V, j, axis=0, keepdims=False)
            w = op(vj)
            mask = (idx_basis <= j).astype(rdt)
            # CGS2: classical Gram-Schmidt with one re-orthogonalization
            # pass — single-pass CGS loses orthogonality in f32 and the
            # restarted solve stagnates on near-singular shifted systems
            hr = (V[:, 0, :] @ w[0] + V[:, 1, :] @ w[1]) * mask
            hi = (V[:, 0, :] @ w[1] - V[:, 1, :] @ w[0]) * mask
            w0 = w[0] - (hr @ V[:, 0, :] - hi @ V[:, 1, :])
            w1 = w[1] - (hr @ V[:, 1, :] + hi @ V[:, 0, :])
            cr = (V[:, 0, :] @ w0 + V[:, 1, :] @ w1) * mask
            ci = (V[:, 0, :] @ w1 - V[:, 1, :] @ w0) * mask
            w0 = w0 - (cr @ V[:, 0, :] - ci @ V[:, 1, :])
            w1 = w1 - (cr @ V[:, 1, :] + ci @ V[:, 0, :])
            hr = hr + cr
            hi = hi + ci
            nrm = jnp.sqrt(jnp.sum(w0 * w0 + w1 * w1))
            brk = nrm == 0
            inv = jnp.where(brk, jnp.zeros((), rdt),
                            1.0 / jnp.where(brk, jnp.ones((), rdt), nrm))
            V = jax.lax.dynamic_update_index_in_dim(
                V, jnp.stack([w0 * inv, w1 * inv]), j + 1, axis=0)
            col_r = hr + nrm * (idx_basis == j + 1).astype(rdt)
            Hr = jax.lax.dynamic_update_index_in_dim(Hr, col_r, j, axis=1)
            Hi = jax.lax.dynamic_update_index_in_dim(Hi, hi, j, axis=1)
            return V, Hr, Hi

        return jax.lax.fori_loop(0, m, body, (V0, Hr0, Hi0))

    def cond(c):
        x, rnorm, it, done = c
        return jnp.logical_and(it < max_restarts, jnp.logical_not(done))

    def body(c):
        x, _, it, done = c
        r = b_p - op(x)
        beta = splitc_norm(r)
        V, Hr, Hi = arnoldi(r, beta)
        # real block least squares: [[Hr, -Hi], [Hi, Hr]] y = beta e1
        G = jnp.block([[Hr, -Hi], [Hi, Hr]])          # (2(m+1), 2m)
        rhs = jnp.zeros((2 * (m + 1),), rdt).at[0].set(beta)
        Q, R = jnp.linalg.qr(G, mode="reduced")
        qtr = Q.T @ rhs
        diag_r = jnp.diagonal(R)
        sing = jnp.abs(diag_r) == 0
        R_safe = R + jnp.diag(jnp.where(sing, jnp.ones((), rdt),
                                        jnp.zeros((), rdt)))
        y = jax.scipy.linalg.solve_triangular(R_safe, qtr, lower=False)
        y = jnp.where(sing, jnp.zeros((), rdt), y)
        yr, yi = y[:m], y[m:]
        x0_new = x[0] + yr @ V[:m, 0, :] - yi @ V[:m, 1, :]
        x1_new = x[1] + yr @ V[:m, 1, :] + yi @ V[:m, 0, :]
        x_new = jnp.stack([x0_new, x1_new])
        r_new = b_p - op(x_new)
        rnorm = splitc_norm(r_new)
        bad = jnp.logical_not(jnp.isfinite(rnorm))
        x_keep = jnp.where(bad, x, x_new)
        return (x_keep, rnorm, it + 1,
                jnp.logical_or(bad, rnorm <= atol))

    x0 = jnp.zeros_like(b)
    x, rnorm, it, done = jax.lax.while_loop(
        cond, body, (x0, bnorm, jnp.zeros((), jnp.int32), bnorm <= atol))
    return x


def solve_shifted_splitc_gmres(matvec, shift, b, *, diag=None, tol=1e-10,
                               m=30, max_restarts=None):
    """GMRES variant of ``solve_shifted_splitc`` — same shifted operator
    and Jacobi plane preconditioner, restarted-GMRES inner method."""
    def shifted_mv(v):
        return matvec(v) - splitc_mul(_sx(shift, v), v)

    precond = None
    if diag is not None:
        d = diag - _sx(shift, diag)
        dd = d[0] * d[0] + d[1] * d[1]
        one_plane = jnp.stack([jnp.ones_like(d[0]), jnp.zeros_like(d[1])])
        d = jnp.where(dd[None] == 0, one_plane, d)
        precond = lambda v: splitc_div(v, d)

    return splitc_gmres(shifted_mv, b, precond=precond, tol=tol, m=m,
                        max_restarts=max_restarts)
