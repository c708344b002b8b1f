"""Lanczos iteration — top-k eigenvalues of symmetric/Hermitian operators.

The symmetric specialisation of Arnoldi (solvers/arnoldi.py): the projected
matrix is tridiagonal, so the recurrence keeps only three vectors and the
small solve is an ``eigh`` of a real tridiagonal — O(m^2) instead of the
shifted-QR O(m^3), with Ritz-residual bounds ``|beta_m * s_{m,i}|`` for
free. The reference has no sparse-spectrum capability at all (its QR stack
is dense-only, qr_eigenvalues.hpp:131-133); this is part of the
superset mandated by the BASELINE large-sparse configs.

Structure: the whole basis build is one jitted ``fori_loop`` whose only
O(n) ops are the operator's matvec and (optionally) a full
reorthogonalisation pass written as TWO matmuls against the fixed-shape
basis — rows beyond the current step are zero, so no masking is needed.
Reductions are injectable so the distributed
build (parallel/lanczos.py) reuses this verbatim with psum'd versions.

Hermitian input is the caller's contract (as with every Lanczos
implementation); the Rayleigh coefficients are taken as their real parts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import full_precision
from ..core.dtypes import check_scalar_type, real_dtype_of
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..utils.prng import default_key, random_unit_vector


def _default_project(V, w):
    """c_i = <V_i, w> for the reorthogonalisation pass (vector axes of w
    may be multi-dimensional, e.g. the interleaved (R, 128) layout)."""
    return jnp.tensordot(jnp.conj(V), w, axes=w.ndim)


@full_precision
def lanczos_decomposition(matvec, x0: jax.Array, m: int, *, vdot=jnp.vdot,
                          norm=jnp.linalg.norm, project=_default_project,
                          reorth: bool = True):
    """Three-term Lanczos factorisation ``A V_m = V_m T_m + beta_m v_{m+1}``.

    Returns ``(V, alpha, beta, breakdown_at)``: V ``(m+1, *x0.shape)``,
    ``alpha`` (m,) real diagonal, ``beta`` (m,) real subdiagonal
    (``beta[j] = T[j+1, j]``; ``beta[m-1]`` is the residual norm used in
    Ritz bounds), ``breakdown_at`` the step where the subspace became
    invariant (m if none). Fixed shapes; masked updates after breakdown.

    ``reorth=True`` adds one full classical Gram-Schmidt pass per step
    (two matmuls) — without it, finite-precision Lanczos loses
    orthogonality once Ritz values converge (ghost eigenvalues).
    """
    dtype = x0.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))

    V0 = jnp.zeros((m + 1,) + x0.shape, dtype).at[0].set(
        x0 / norm(x0).astype(dtype))
    alpha0 = jnp.zeros((m,), rdt)
    beta0 = jnp.zeros((m,), rdt)

    def outer(j, carry):
        V, alpha, beta, brk = carry
        v = V[j]
        w = matvec(v)
        a = jnp.real(vdot(v, w)).astype(rdt)
        # three-term recurrence; V[j-1] is the zero row m when j == 0
        # (dynamic index clamps) and the coefficient is 0 there anyway
        b_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)],
                           jnp.zeros((), rdt))
        w = w - a.astype(dtype) * v - b_prev.astype(dtype) * V[jnp.maximum(j - 1, 0)]
        if reorth:
            # rows > j of V are zero -> unmasked full pass is exact
            c = project(V, w)
            w = w - jnp.tensordot(c, V, axes=[[0], [0]])
        b = norm(w).astype(rdt)
        # epsilon-relative breakdown (invariant subspace): the exact b == 0
        # never fires in floating point once reorthogonalisation leaves
        # O(eps) noise; scale by the current recurrence magnitudes
        scale = jnp.maximum(jnp.abs(a), b_prev)
        breakdown = b <= 100 * jnp.finfo(rdt).eps * scale
        safe = jnp.where(breakdown, jnp.ones((), rdt), b).astype(dtype)

        still = jnp.logical_not(brk < j + 1)
        V = jnp.where(jnp.logical_and(still, jnp.logical_not(breakdown)),
                      V.at[j + 1].set(w / safe), V)
        alpha = jnp.where(still, alpha.at[j].set(a), alpha)
        beta = jnp.where(jnp.logical_and(still, jnp.logical_not(breakdown)),
                         beta.at[j].set(b), beta)
        brk = jnp.where(jnp.logical_and(still, breakdown),
                        jnp.minimum(brk, j + 1), brk)
        return (V, alpha, beta, brk)

    V, alpha, beta, brk = jax.lax.fori_loop(
        0, m, outer, (V0, alpha0, beta0, jnp.asarray(m + 1, jnp.int32)))
    return V, alpha, beta, jnp.minimum(brk, m)


@partial(jax.jit, static_argnames=("m", "reorth"))
def _lanczos_basis(M: AbstractMatrix, x0: jax.Array, m: int, reorth: bool):
    return lanczos_decomposition(M.matvec, x0, m, reorth=reorth)


def _ritz_from_tridiag(alpha: np.ndarray, beta: np.ndarray, k: int,
                       which: str, tol: float):
    """Host-side m x m tridiagonal eigensolve + Ritz residual bounds.

    Returns (ritz (k,), converged) — ``converged`` is True when every
    selected Ritz pair's residual bound |beta_m s_{m,i}| passes the
    reference relative criterion against its Ritz value."""
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[:m - 1], 1) + np.diag(beta[:m - 1], -1)
    theta, S = np.linalg.eigh(T)
    if which == "LA":
        idx = np.argsort(-theta)[:k]
    elif which == "SA":
        idx = np.argsort(theta)[:k]
    else:  # "LM"
        idx = np.argsort(-np.abs(theta))[:k]
    resid = np.abs(beta[m - 1] * S[m - 1, idx])
    converged = bool(np.all(resid <= tol * (1.0 + np.abs(theta[idx]))))
    return theta[idx], converged, S[:, idx]


@full_precision
def lanczos_extend(matvec, W_init: jax.Array, l: int, m: int, *,
                   vdot=jnp.vdot, norm=jnp.linalg.norm,
                   project=_default_project):
    """Extend a thick-restart basis: rows ``0..l`` of ``W_init``
    ((m+1, *vec_shape)) hold the retained Ritz vectors plus the residual
    vector; steps ``l..m-1`` run the Lanczos recurrence with a FULL
    reorthogonalisation pass (which also removes the arrowhead coupling
    at the seam step, so no special-casing is needed). Returns
    ``(W, alpha, beta, breakdown_at)`` with ``alpha[j]``/``beta[j]``
    defined for ``j >= l``.
    """
    dtype = W_init.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))
    alpha0 = jnp.zeros((m,), rdt)
    beta0 = jnp.zeros((m,), rdt)

    def outer(j, carry):
        W, alpha, beta, brk = carry
        v = W[j]
        w = matvec(v)
        a = jnp.real(vdot(v, w)).astype(rdt)
        # full classical Gram-Schmidt pass against the whole basis (rows
        # beyond the frontier are zero) — subsumes the three-term
        # subtraction AND the restart coupling
        c = project(W, w)
        w = w - jnp.tensordot(c, W, axes=[[0], [0]])
        b = norm(w).astype(rdt)
        scale = jnp.maximum(jnp.abs(a), jnp.max(jnp.abs(c)).astype(rdt))
        breakdown = b <= 100 * jnp.finfo(rdt).eps * scale
        safe = jnp.where(breakdown, jnp.ones((), rdt), b).astype(dtype)

        still = jnp.logical_not(brk < j + 1)
        W = jnp.where(jnp.logical_and(still, jnp.logical_not(breakdown)),
                      W.at[j + 1].set(w / safe), W)
        alpha = jnp.where(still, alpha.at[j].set(a), alpha)
        beta = jnp.where(jnp.logical_and(still, jnp.logical_not(breakdown)),
                         beta.at[j].set(b), beta)
        brk = jnp.where(jnp.logical_and(still, breakdown),
                        jnp.minimum(brk, j + 1), brk)
        return (W, alpha, beta, brk)

    W, alpha, beta, brk = jax.lax.fori_loop(
        l, m, outer, (W_init, alpha0, beta0, jnp.asarray(m + 1, jnp.int32)))
    return W, alpha, beta, jnp.minimum(brk, m)


@partial(jax.jit, static_argnames=("l", "m"))
def _lanczos_extend_basis(M: AbstractMatrix, W_init: jax.Array, l: int, m: int):
    return lanczos_extend(M.matvec, W_init, l, m)


@full_precision
def lanczos_thick_restart(M: AbstractMatrix, k: int = 6, *,
                          m: int | None = None, restarts: int = 50,
                          opts: SolverOptions = SolverOptions(),
                          which: str = "LA", dtype=None, key=None,
                          x0=None) -> QRResult:
    """Thick-restart Lanczos (TRLan): top-``k`` eigenvalues of a
    symmetric/Hermitian operator with a MEMORY-BOUNDED basis.

    Plain ``lanczos_eigenvalues`` needs ``m`` large enough to resolve the
    spectrum in one Krylov sweep; here the basis is capped at ``m``
    vectors and restarted: each cycle keeps the ``l ~ 2k`` best Ritz
    vectors plus the residual vector and extends back to ``m`` (the
    restart coupling is an arrowhead in the projected matrix, assembled
    explicitly). Converges on clustered spectra where a single m-step
    sweep cannot (ARPACK-class behavior). ``which``: "LA" or "SA".
    ``iterations`` reports total matvecs spent on basis building.
    """
    if which not in ("LA", "SA"):
        raise ValueError(f"lanczos_thick_restart: unknown which={which!r} "
                         "(LA or SA; use lanczos_eigenvalues for LM)")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "lanczos_thick_restart")
    require_square(M, "lanczos_thick_restart")
    require_nonempty(M, "lanczos_thick_restart")
    n = M.shape[0]
    if k < 1:
        raise ValueError("lanczos_thick_restart: k must be >= 1")
    if m is None:
        m = min(max(3 * k + 10, 20), n)
    m = min(m, n)
    l = min(2 * k, m - 2)
    if l < k:
        raise ValueError(
            f"lanczos_thick_restart: m ({m}) too small for k ({k}); need "
            f"m >= k + 2")

    vec_dt = jnp.promote_types(M.dtype, jnp.float32)
    if x0 is None:
        x0 = random_unit_vector(key if key is not None else default_key(),
                                n, vec_dt)
    else:
        x0 = jnp.asarray(x0, vec_dt)
    x0 = M.encode_vec(x0)

    sign = -1.0 if which == "LA" else 1.0  # eigh sorts ascending

    # first cycle: plain Lanczos
    V, alpha, beta, brk = _lanczos_basis(M, x0, m, True)
    steps = min(int(np.asarray(brk)), m)
    total_mv = steps
    T = np.diag(np.asarray(alpha)[:steps])
    if steps > 1:
        off = np.asarray(beta)[:steps - 1]
        T += np.diag(off, 1) + np.diag(off, -1)
    beta_last = float(np.asarray(beta)[steps - 1]) if steps >= 1 else 0.0

    tol = float(opts.tolerance)
    for _ in range(restarts):
        theta, S = np.linalg.eigh(T)
        order = np.argsort(sign * theta)
        sel_k = order[:k]
        resid_k = np.abs(beta_last * S[-1, sel_k])
        if np.all(resid_k <= tol * (1.0 + np.abs(theta[sel_k]))) or \
                beta_last == 0.0:
            return QRResult(eigenvalues=jnp.asarray(theta[sel_k]),
                            iterations=jnp.asarray(total_mv, jnp.int32),
                            converged=jnp.asarray(True))
        # retain l Ritz pairs + the residual direction
        sel_l = order[:min(l, steps - 1)]
        l_eff = len(sel_l)
        S_l = jnp.asarray(S[:, sel_l], V.dtype)          # (steps, l_eff)
        Y = jnp.tensordot(S_l, V[:steps], axes=[[0], [0]])  # (l_eff, vec)
        v_res = V[steps]                                  # residual vector
        W0 = jnp.zeros((m + 1,) + v_res.shape, V.dtype)
        W0 = W0.at[:l_eff].set(Y).at[l_eff].set(v_res)
        coupling = beta_last * np.asarray(S[-1, sel_l])   # (l_eff,)

        V, alpha2, beta2, brk2 = _lanczos_extend_basis(M, W0, l_eff, m)
        steps2 = min(int(np.asarray(brk2)), m)
        new_lo, new_hi = l_eff, steps2
        total_mv += max(new_hi - new_lo, 0)
        # assemble the arrowhead + tridiagonal projected matrix
        T = np.zeros((steps2, steps2))
        th = np.asarray(theta[sel_l])
        T[:l_eff, :l_eff] = np.diag(th)
        T[:l_eff, l_eff] = coupling[:l_eff]
        T[l_eff, :l_eff] = coupling[:l_eff]
        a2 = np.asarray(alpha2)
        b2 = np.asarray(beta2)
        for j in range(l_eff, steps2):
            T[j, j] = a2[j]
            if j + 1 < steps2:
                T[j + 1, j] = T[j, j + 1] = b2[j]
        beta_last = float(b2[steps2 - 1]) if steps2 > l_eff else 0.0
        steps = steps2

    theta, S = np.linalg.eigh(T)
    order = np.argsort(sign * theta)[:k]
    return QRResult(eigenvalues=jnp.asarray(theta[order]),
                    iterations=jnp.asarray(total_mv, jnp.int32),
                    converged=jnp.asarray(False))


def lanczos_eigenpairs(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                       opts: SolverOptions = SolverOptions(),
                       which: str = "LM", reorth: bool = True, dtype=None,
                       key=None, x0=None):
    """Like ``lanczos_eigenvalues`` but also returns the Ritz VECTORS.

    Returns ``(result, vectors)`` with ``vectors`` an ``(n, k)`` array of
    Ritz vectors ``Y = V_m^T S`` decoded to the natural domain (columns
    normalised). Residuals ``||A y - theta y||`` match the bounds used
    for ``result.converged``.
    """
    res, Y = _lanczos_impl(M, k, m=m, opts=opts, which=which, reorth=reorth,
                           dtype=dtype, key=key, x0=x0, want_vectors=True)
    return res, Y


def lanczos_eigenvalues(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                        opts: SolverOptions = SolverOptions(),
                        which: str = "LM", reorth: bool = True, dtype=None,
                        key=None, x0=None) -> QRResult:
    """Top-``k`` eigenvalues of a symmetric/Hermitian operator.

    ``which``: "LM" (largest magnitude, default), "LA" (largest algebraic)
    or "SA" (smallest algebraic). ``m`` defaults to ``min(max(2k+10, 20), n)``
    Lanczos steps. Returns a ``QRResult`` whose (real) ``eigenvalues`` are
    the selected Ritz values, ``iterations`` the Krylov steps actually run,
    and ``converged`` the all-pairs Ritz-residual test at ``opts.tolerance``.
    """
    return _lanczos_impl(M, k, m=m, opts=opts, which=which, reorth=reorth,
                         dtype=dtype, key=key, x0=x0, want_vectors=False)


@full_precision
def _lanczos_impl(M: AbstractMatrix, k: int, *, m, opts, which, reorth,
                  dtype, key, x0, want_vectors: bool):
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"lanczos_eigenvalues: unknown which={which!r}")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "lanczos_eigenvalues")
    require_square(M, "lanczos_eigenvalues")
    require_nonempty(M, "lanczos_eigenvalues")
    n = M.shape[0]
    if k < 1:
        raise ValueError("lanczos_eigenvalues: k must be >= 1")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(f"lanczos_eigenvalues: k ({k}) must be <= m ({m})")

    vec_dt = jnp.promote_types(M.dtype, jnp.float32)
    if x0 is None:
        x0 = random_unit_vector(key if key is not None else default_key(),
                                n, vec_dt)
    else:
        x0 = jnp.asarray(x0, vec_dt)
    x0 = M.encode_vec(x0)

    V, alpha, beta, brk = _lanczos_basis(M, x0, m, reorth)
    steps = int(np.asarray(brk)) if int(np.asarray(brk)) < m else m
    steps = max(steps, 1)
    ritz, converged, S = _ritz_from_tridiag(
        np.asarray(alpha)[:steps], np.asarray(beta)[:steps],
        min(k, steps), which, float(opts.tolerance))
    res = QRResult(eigenvalues=jnp.asarray(ritz),
                   iterations=jnp.asarray(steps, jnp.int32),
                   converged=jnp.asarray(converged))
    if not want_vectors:
        return res
    # Ritz vectors: Y = sum_j S[j, :] V_j, decoded to the natural domain
    Y = jnp.tensordot(jnp.asarray(S[:steps], V.dtype), V[:steps],
                      axes=[[0], [0]])  # (k, *vec_shape)
    Y = jnp.stack([M.decode_vec(y) for y in Y], axis=1)  # (n, k)
    return res, Y
