"""Distributed Krylov solver: BiCGStab with injected reductions.

``jax.scipy.sparse.linalg.bicgstab`` computes its inner products with
plain tree-vdots, which are shard-local inside ``shard_map``; this
implementation takes ``vdot``/``norm`` as arguments so the distributed
path can pass ``psum``-based versions (parallel/sharded.py) and the whole
solve runs on row shards with scalars replicated across devices. This
replaces the reference's SparseLU factorisation (solve_shifted.hpp:104-115)
in the distributed setting: no factorisation ever crosses devices — only
SpMV halo exchanges and scalar psums (the SURVEY §2 'distributed shifted
solve' row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.precision import full_precision


@full_precision
def bicgstab(matvec, b, *, vdot, norm, precond=None, tol=1e-12, atol=0.0,
             maxiter=None, x0=None):
    """Preconditioned BiCGStab for ``A x = b`` with injectable reductions.

    Returns ``(x, residual_norm, iterations)``. On breakdown (rho or
    omega denominators vanish) the current iterate is returned — inverse
    iteration only needs the direction.
    """
    dtype = b.dtype
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    M = precond if precond is not None else (lambda v: v)

    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    bnorm = norm(b)
    atol_eff = jnp.maximum(tol * bnorm, atol)

    init = dict(
        x=x0, r=r0, rhat=r0,
        rho=jnp.ones((), dtype), alpha=jnp.ones((), dtype),
        omega=jnp.ones((), dtype),
        v=jnp.zeros_like(b), p=jnp.zeros_like(b),
        k=jnp.zeros((), jnp.int32), done=jnp.asarray(False),
    )

    def cond(s):
        return jnp.logical_and(s["k"] < maxiter,
                               jnp.logical_not(s["done"]))

    def body(s):
        rho_new = vdot(s["rhat"], s["r"])
        rho_breakdown = rho_new == 0
        beta = jnp.where(rho_breakdown, jnp.zeros((), dtype),
                         (rho_new / jnp.where(rho_breakdown, 1, s["rho"])) *
                         (s["alpha"] / jnp.where(s["omega"] == 0, 1, s["omega"])))
        p = s["r"] + beta * (s["p"] - s["omega"] * s["v"])
        phat = M(p)
        v = matvec(phat)
        denom = vdot(s["rhat"], v)
        alpha_breakdown = denom == 0
        alpha = jnp.where(alpha_breakdown, jnp.zeros((), dtype),
                          rho_new / jnp.where(alpha_breakdown, 1, denom))
        h = s["x"] + alpha * phat
        srt = s["r"] - alpha * v
        s_small = norm(srt) <= atol_eff
        shat = M(srt)
        t = matvec(shat)
        tt = vdot(t, t)
        omega_breakdown = tt == 0
        omega = jnp.where(omega_breakdown, jnp.zeros((), dtype),
                          vdot(t, srt) / jnp.where(omega_breakdown, 1, tt))
        x = jnp.where(s_small, h, h + omega * shat)
        r = jnp.where(s_small, srt, srt - omega * t)
        converged = jnp.logical_or(s_small, norm(r) <= atol_eff)
        done = jnp.logical_or(converged,
                              jnp.logical_or(rho_breakdown,
                                             jnp.logical_or(alpha_breakdown,
                                                            omega_breakdown)))
        return dict(x=x, r=r, rhat=s["rhat"], rho=rho_new, alpha=alpha,
                    omega=omega, v=v, p=p, k=s["k"] + 1, done=done)

    out = jax.lax.while_loop(cond, body, init)
    return out["x"], norm(out["r"]), out["k"]


@full_precision
def gmres(matvec, b, *, vdot, norm, m=30, tol=1e-12, atol=0.0,
          max_restarts=None, precond=None, x0=None):
    """Restarted GMRES(m) with injectable reductions.

    Builds an m-step Arnoldi basis of the (right-preconditioned) operator
    per restart (reusing solvers.arnoldi.arnoldi_decomposition with the
    caller's psum-capable ``vdot``/``norm``), solves the small least
    squares with XLA QR, and corrects. Whole solve is one
    ``lax.while_loop``; returns ``(x, residual_norm, restarts)``.
    """
    from ..solvers.arnoldi import arnoldi_decomposition

    dtype = b.dtype
    n = b.size
    if max_restarts is None:
        max_restarts = max(-(-4 * n // m), 8)
    M = precond if precond is not None else (lambda v: v)

    def op(v):
        return matvec(M(v))

    bnorm = norm(b)
    atol_eff = jnp.maximum(tol * bnorm, atol)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def cond(c):
        u, rnorm, it, done = c
        return jnp.logical_and(it < max_restarts, jnp.logical_not(done))

    def body(c):
        u, rnorm, it, done = c
        r = b - op(u)
        beta = norm(r).astype(dtype)
        breakdown = beta == 0
        safe_r = jnp.where(breakdown, jnp.ones_like(r).at[0].set(1), r)
        V, H, brk = arnoldi_decomposition(op, safe_r, m, vdot=vdot, norm=norm)
        e1 = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        Q, R = jnp.linalg.qr(H, mode="reduced")  # (m+1, m) -> (m+1, m), (m, m)
        rhs = jnp.conj(Q).T @ e1
        # guard singular R (Arnoldi breakdown columns are zero)
        diag_r = jnp.diagonal(R)
        safe = jnp.where(diag_r == 0, jnp.ones((), dtype), diag_r)
        Rsafe = R - jnp.diag(diag_r) + jnp.diag(safe)
        y = jax.scipy.linalg.solve_triangular(Rsafe, rhs, lower=False)
        # shape-agnostic basis combination (vector axes may be >1-D, e.g.
        # the interleaved (R, 128) layout)
        u_new = u + jnp.tensordot(y, V[:m], axes=[[0], [0]])
        r_new = b - op(u_new)
        rn = norm(r_new)
        conv = rn <= atol_eff
        u = jnp.where(breakdown, u, u_new)
        return (u, rn, it + 1, jnp.logical_or(conv, breakdown))

    u, rnorm, it, done = jax.lax.while_loop(
        cond, body, (x0, norm(b - op(x0)), jnp.zeros((), jnp.int32),
                     jnp.asarray(False)))
    return M(u), rnorm, it


def solve_shifted_distributed(matvec, shift, b, *, vdot, norm, diag=None,
                              tol=1e-12, maxiter=None):
    """Solve ``(A - shift I) y = b`` on shards; Jacobi preconditioning."""
    shift = jnp.asarray(shift, b.dtype)

    def shifted_mv(v):
        return matvec(v) - shift * v

    precond = None
    if diag is not None:
        d = diag - shift
        safe = jnp.where(d == 0, jnp.ones((), d.dtype), d)
        precond = lambda v: v / safe

    x, _, _ = bicgstab(shifted_mv, b, vdot=vdot, norm=norm, precond=precond,
                       tol=tol, maxiter=maxiter)
    return x
