"""QR eigenvalue iteration.

Two modes (``QROptions.mode``):

``"parity"`` — the reference algorithm exactly
(/root/reference/src/qr_method/qr_eigenvalues.hpp:40-108): Hessenberg
reduction, then unshifted sweeps ``H = Q R; H := R Q`` using the FULL
Householder QR each sweep, stopping when
``max_i |H(i, i-1)| <= tol * (1 + ||H||_F)`` (:77-93). Iteration-count
semantics preserved: ``iterations == iter+1`` at the converging sweep and
``max_iterations + 1`` on non-convergence (:69,104); n == 0 returns an
empty converged result (:55-57).

``"accelerated"`` — the superset the survey calls for: rotations
exploiting the Hessenberg structure (O(n^2) per sweep instead of the
reference's O(n^3) re-decomposition), shifts, and deflation with a
device-resident active-window counter. The whole solve is ONE
``lax.while_loop`` under jit — fixed shapes, dynamic inner loop bounds
shrink the per-sweep work as the window deflates, zero host round-trips.
Complex input runs complex Givens sweeps with Wilkinson shifts; real input
runs Francis double-shift sweeps in real arithmetic and reads conjugate
pairs off its 2x2 blocks (the reference's real unshifted iteration cannot
separate them). Eigenvectors (``compute_vectors``) come from the Schur
form by back-substitution, also on the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dtypes import check_scalar_type, complex_dtype_of, real_dtype_of
from ..core.options import QROptions, SolverOptions
from ..core.results import QRResult
from ..matrix.protocol import AbstractMatrix
from .hessenberg import hessenberg_dense, hessenberg_dense_q
from .qr import qr_decompose_dense

_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# parity mode
# ---------------------------------------------------------------------------

@jax.jit
def _qr_eigenvalues_parity(a: jax.Array, max_iterations: jax.Array,
                           tol: jax.Array) -> QRResult:
    n = a.shape[0]
    dtype = a.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))

    if n == 0:
        return QRResult(eigenvalues=jnp.zeros((0,), dtype),
                        iterations=jnp.zeros((), jnp.int32),
                        converged=jnp.asarray(True))

    H0 = hessenberg_dense(a)

    def cond(c):
        H, it, converged = c
        return jnp.logical_and(it < max_iterations, jnp.logical_not(converged))

    def body(c):
        H, it, _ = c
        Q, R = qr_decompose_dense(H)
        H = jnp.matmul(R, Q, precision=_HI)  # (qr_eigenvalues.hpp:74)
        if n > 1:
            max_subdiag = jnp.max(jnp.abs(jnp.diagonal(H, offset=-1)))
        else:
            max_subdiag = jnp.zeros((), rdt)
        thresh = tol.astype(rdt) * (1.0 + jnp.linalg.norm(H).astype(rdt))
        return (H, it + 1, max_subdiag <= thresh)

    H, it, converged = jax.lax.while_loop(cond, body, (H0, jnp.zeros((), jnp.int32),
                                                       jnp.asarray(False)))
    # reference reports iter+1: converging sweep i (0-based) -> i+1 == it;
    # non-convergence -> max_iterations + 1 (qr_eigenvalues.hpp:69,104).
    iterations = jnp.where(converged, it, it + 1)
    return QRResult(eigenvalues=jnp.diagonal(H), iterations=iterations,
                    converged=converged)


# ---------------------------------------------------------------------------
# accelerated mode: Givens sweeps + Wilkinson shift + deflation, on device
# ---------------------------------------------------------------------------

def _givens_sweep(H: jax.Array, hi: jax.Array, shift: jax.Array):
    """One shifted QR sweep on the active window H[:hi, :hi] via Givens.

    Computes ``H - shift I = Q R`` with n-1 Givens rotations (only the
    Hessenberg subdiagonal needs elimination), then ``R Q + shift I``.
    Rotations are only formed for k < hi-1 (traced loop bound), so the
    per-sweep cost shrinks as the window deflates.
    """
    n = H.shape[0]
    dtype = H.dtype
    diag_mask = jnp.arange(n) < hi
    H = H - jnp.diag(jnp.where(diag_mask, shift, jnp.zeros((), dtype)))

    g00_0 = jnp.ones((max(n - 1, 1),), dtype)
    g01_0 = jnp.zeros((max(n - 1, 1),), dtype)

    def left_body(k, carry):
        Hc, g00s, g01s = carry
        a = Hc[k, k]
        b = Hc[k + 1, k]
        r = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(b) ** 2)
        zero = r == 0
        rs = jnp.where(zero, jnp.ones((), r.dtype), r).astype(dtype)
        g00 = jnp.where(zero, jnp.ones((), dtype), jnp.conj(a) / rs)
        g01 = jnp.where(zero, jnp.zeros((), dtype), jnp.conj(b) / rs)
        row_k = Hc[k, :]
        row_k1 = Hc[k + 1, :]
        Hc = Hc.at[k, :].set(g00 * row_k + g01 * row_k1)
        Hc = Hc.at[k + 1, :].set(-jnp.conj(g01) * row_k + jnp.conj(g00) * row_k1)
        return Hc, g00s.at[k].set(g00), g01s.at[k].set(g01)

    H, g00s, g01s = jax.lax.fori_loop(0, hi - 1, left_body, (H, g00_0, g01_0))

    def right_body(k, Hc):
        ck = Hc[:, k]
        ck1 = Hc[:, k + 1]
        Hc = Hc.at[:, k].set(jnp.conj(g00s[k]) * ck + jnp.conj(g01s[k]) * ck1)
        Hc = Hc.at[:, k + 1].set(-g01s[k] * ck + g00s[k] * ck1)
        return Hc

    H = jax.lax.fori_loop(0, hi - 1, right_body, H)
    return H + jnp.diag(jnp.where(diag_mask, shift, jnp.zeros((), dtype)))


def _wilkinson_shift(H: jax.Array, hi: jax.Array) -> jax.Array:
    """Eigenvalue of the trailing active 2x2 closest to its bottom entry."""
    a = H[hi - 2, hi - 2]
    b = H[hi - 2, hi - 1]
    c = H[hi - 1, hi - 2]
    d = H[hi - 1, hi - 1]
    delta = (a - d) / 2.0
    sq = jnp.sqrt(delta * delta + b * c)  # complex sqrt
    mu_plus = d + delta + sq
    mu_minus = d + delta - sq
    return jnp.where(jnp.abs(mu_plus - d) < jnp.abs(mu_minus - d), mu_plus, mu_minus)


@jax.jit
def _qr_eigenvalues_accel(H0: jax.Array, max_sweeps: jax.Array,
                          tol: jax.Array) -> QRResult:
    """Input MUST already be upper Hessenberg (callers pre-reduce)."""
    n = H0.shape[0]
    dtype = H0.dtype  # complex by construction
    rdt = jnp.dtype(real_dtype_of(dtype))

    if n == 0:
        return QRResult(eigenvalues=jnp.zeros((0,), dtype),
                        iterations=jnp.zeros((), jnp.int32),
                        converged=jnp.asarray(True))
    if n == 1:
        return QRResult(eigenvalues=jnp.diagonal(H0),
                        iterations=jnp.zeros((), jnp.int32),
                        converged=jnp.asarray(True))

    tol = tol.astype(rdt)

    def deflate(state):
        H, hi = state

        def d_cond(hh):
            hi_ = hh
            sub = jnp.abs(H[hi_ - 1, hi_ - 2])
            scale = jnp.abs(H[hi_ - 2, hi_ - 2]) + jnp.abs(H[hi_ - 1, hi_ - 1])
            small = sub <= tol * jnp.maximum(scale, jnp.ones((), rdt))
            return jnp.logical_and(hi_ > 1, small)

        return jax.lax.while_loop(d_cond, lambda hh: hh - 1, hi)

    def cond(c):
        H, hi, sweeps = c
        return jnp.logical_and(hi > 1, sweeps < max_sweeps)

    def body(c):
        H, hi, sweeps = c
        shift = _wilkinson_shift(H, hi)
        H = _givens_sweep(H, hi, shift)
        hi = deflate((H, hi))
        return H, hi, sweeps + 1

    hi0 = deflate((H0, jnp.asarray(n, jnp.int32)))
    H, hi, sweeps = jax.lax.while_loop(
        cond, body, (H0, hi0, jnp.zeros((), jnp.int32)))
    return QRResult(eigenvalues=jnp.diagonal(H), iterations=sweeps,
                    converged=hi <= 1)


def _givens_sweep_q(H, Q, hi, shift):
    """_givens_sweep that also right-multiplies the accumulated unitary Q
    by the sweep's rotation product (A = Q H Q^H stays invariant)."""
    n = H.shape[0]
    dtype = H.dtype
    diag_mask = jnp.arange(n) < hi
    H = H - jnp.diag(jnp.where(diag_mask, shift, jnp.zeros((), dtype)))

    g00_0 = jnp.ones((max(n - 1, 1),), dtype)
    g01_0 = jnp.zeros((max(n - 1, 1),), dtype)

    def left_body(k, carry):
        Hc, g00s, g01s = carry
        a = Hc[k, k]
        b = Hc[k + 1, k]
        r = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(b) ** 2)
        zero = r == 0
        rs = jnp.where(zero, jnp.ones((), r.dtype), r).astype(dtype)
        g00 = jnp.where(zero, jnp.ones((), dtype), jnp.conj(a) / rs)
        g01 = jnp.where(zero, jnp.zeros((), dtype), jnp.conj(b) / rs)
        row_k = Hc[k, :]
        row_k1 = Hc[k + 1, :]
        Hc = Hc.at[k, :].set(g00 * row_k + g01 * row_k1)
        Hc = Hc.at[k + 1, :].set(-jnp.conj(g01) * row_k + jnp.conj(g00) * row_k1)
        return Hc, g00s.at[k].set(g00), g01s.at[k].set(g01)

    H, g00s, g01s = jax.lax.fori_loop(0, hi - 1, left_body, (H, g00_0, g01_0))

    def right_body(k, carry):
        Hc, Qc = carry
        ck = Hc[:, k]
        ck1 = Hc[:, k + 1]
        Hc = Hc.at[:, k].set(jnp.conj(g00s[k]) * ck + jnp.conj(g01s[k]) * ck1)
        Hc = Hc.at[:, k + 1].set(-g01s[k] * ck + g00s[k] * ck1)
        qk = Qc[:, k]
        qk1 = Qc[:, k + 1]
        Qc = Qc.at[:, k].set(jnp.conj(g00s[k]) * qk + jnp.conj(g01s[k]) * qk1)
        Qc = Qc.at[:, k + 1].set(-g01s[k] * qk + g00s[k] * qk1)
        return Hc, Qc

    H, Q = jax.lax.fori_loop(0, hi - 1, right_body, (H, Q))
    return H + jnp.diag(jnp.where(diag_mask, shift, jnp.zeros((), dtype))), Q


@jax.jit
def _qr_eigenvalues_accel_schur(H0: jax.Array, max_sweeps: jax.Array,
                                tol: jax.Array):
    """_qr_eigenvalues_accel variant returning the full Schur pieces
    (T, Q_sweeps, sweeps, hi) for eigenvector extraction."""
    n = H0.shape[0]
    dtype = H0.dtype
    rdt = jnp.dtype(real_dtype_of(dtype))
    tol = tol.astype(rdt)

    def deflate(state):
        H, hi = state

        def d_cond(hh):
            sub = jnp.abs(H[hh - 1, hh - 2])
            scale = jnp.abs(H[hh - 2, hh - 2]) + jnp.abs(H[hh - 1, hh - 1])
            small = sub <= tol * jnp.maximum(scale, jnp.ones((), rdt))
            return jnp.logical_and(hh > 1, small)

        return jax.lax.while_loop(d_cond, lambda hh: hh - 1, hi)

    def cond(c):
        H, Q, hi, sweeps = c
        return jnp.logical_and(hi > 1, sweeps < max_sweeps)

    def body(c):
        H, Q, hi, sweeps = c
        shift = _wilkinson_shift(H, hi)
        H, Q = _givens_sweep_q(H, Q, hi, shift)
        hi = deflate((H, hi))
        return H, Q, hi, sweeps + 1

    Q0 = jnp.eye(n, dtype=dtype)
    hi0 = deflate((H0, jnp.asarray(n, jnp.int32)))
    H, Q, hi, sweeps = jax.lax.while_loop(
        cond, body, (H0, Q0, hi0, jnp.zeros((), jnp.int32)))
    return H, Q, sweeps, hi


def triangular_eigenvectors(T: jax.Array, eps) -> jax.Array:
    """Eigenvectors of an upper-triangular matrix by back-substitution.

    Column k solves ``(T - T[k,k] I) y = 0`` with ``y[k] = 1`` and zeros
    below. All columns advance together, one row per step from the
    bottom: ``y[i, k] = -(T[i, i+1:] @ y[i+1:, k]) / (T[i,i] - T[k,k])``
    for k > i. Pivots smaller than ``eps`` are replaced by ``eps`` (the
    LAPACK treatment of repeated eigenvalues), and a column whose entries
    grow past ``sqrt(finfo.max)`` is rescaled by a positive factor, which
    keeps it a solution and keeps it finite. Returns unnormalised columns.
    """
    n = T.shape[0]
    idx = jnp.arange(n)
    diag = jnp.diagonal(T)
    zero = jnp.zeros((), T.dtype)
    rdt = jnp.dtype(real_dtype_of(T.dtype))
    big = jnp.sqrt(jnp.finfo(rdt).max)

    def body(step, V):
        i = n - 1 - step
        t_row = jax.lax.dynamic_index_in_dim(T, i, axis=0, keepdims=False)
        r = jnp.matmul(jnp.where(idx > i, t_row, zero), V, precision=_HI)
        denom = t_row[i] - diag
        denom = jnp.where(jnp.abs(denom) < eps, jnp.asarray(eps, T.dtype),
                          denom)
        row = jnp.where(idx > i, -r / denom, (idx == i).astype(T.dtype))
        V = jax.lax.dynamic_update_index_in_dim(V, row, i, axis=0)
        colmax = jnp.max(jnp.abs(V), axis=0)
        return V * jnp.where(colmax > big, 1.0 / colmax, 1.0).astype(T.dtype)

    return jax.lax.fori_loop(0, n, body, jnp.eye(n, dtype=T.dtype))


@jax.jit
def _qr_eigenpairs(a: jax.Array, max_sweeps: jax.Array, tol: jax.Array):
    """Schur form by shifted Givens sweeps with Q accumulation, then
    eigenvectors by back-substitution: returns (eigs, V, sweeps, hi)."""
    rdt = jnp.dtype(real_dtype_of(a.dtype))
    H0, Qh = hessenberg_dense_q(a)
    T, Qs, sweeps, hi = _qr_eigenvalues_accel_schur(H0, max_sweeps, tol)
    scale = jnp.maximum(jnp.max(jnp.abs(T)), jnp.ones((), rdt))
    Y = triangular_eigenvectors(T, jnp.finfo(rdt).eps * scale)
    V = jnp.matmul(jnp.matmul(Qh, Qs, precision=_HI), Y, precision=_HI)
    nrm = jnp.linalg.norm(V, axis=0, keepdims=True)
    V = V / jnp.maximum(nrm, jnp.finfo(rdt).tiny).astype(V.dtype)
    return jnp.diagonal(T), V, sweeps, hi


# ---------------------------------------------------------------------------
# accelerated mode, real arithmetic — Francis double-shift QR with 1x1/2x2
# deflation; complex conjugate pairs are extracted analytically from
# trailing 2x2 blocks into (re, im) plane buffers.
# ---------------------------------------------------------------------------

def _eig2x2_planes(a, b, c, d):
    """Eigenvalues of a real 2x2 [[a,b],[c,d]] as ((re1,im1),(re2,im2))."""
    half_tr = (a + d) / 2.0
    delta = (a - d) / 2.0
    disc = delta * delta + b * c
    s = jnp.sqrt(jnp.abs(disc))
    real_case = disc >= 0
    re1 = jnp.where(real_case, half_tr + s, half_tr)
    re2 = jnp.where(real_case, half_tr - s, half_tr)
    im1 = jnp.where(real_case, jnp.zeros_like(s), s)
    im2 = -im1
    return (re1, im1), (re2, im2)


def _householder3(x, y, z, use_z):
    """3-vector Householder P = I - 2 v v^T zeroing y (and z when use_z).

    Returns the 3x3 P; acts as identity when the vector is already
    aligned (degenerate norm)."""
    rdt = x.dtype
    z = jnp.where(use_z, z, jnp.zeros((), rdt))
    nrm = jnp.sqrt(x * x + y * y + z * z)
    sign = jnp.where(x >= 0, jnp.ones((), rdt), -jnp.ones((), rdt))
    alpha = -sign * nrm
    v0 = x - alpha
    v = jnp.stack([v0, y, z])
    vn2 = v0 * v0 + y * y + z * z
    degenerate = vn2 == 0
    safe = jnp.where(degenerate, jnp.ones((), rdt), vn2)
    P = jnp.eye(3, dtype=rdt) - (2.0 / safe) * jnp.outer(v, v)
    return jnp.where(degenerate, jnp.eye(3, dtype=rdt), P)


def _francis_sweep(H, lo, hi):
    """One implicit double-shift (Francis) QR sweep on the trailing
    unreduced block H[lo:hi, lo:hi] via bulge chasing — the textbook real
    algorithm: the shift pair is the trailing 2x2's eigenvalues (complex
    pairs included, all in real arithmetic), each chase step applies a 3x3
    Householder similarity to three rows/columns.

    ``lo`` MUST be the top of the trailing unreduced block (first row
    below a negligible subdiagonal): starting the bulge higher lets it die
    at the tiny subdiagonal and destroys shift transmission (the classic
    stall). Caller guarantees hi - lo >= 3.
    """
    n = H.shape[0]
    rdt = H.dtype

    # shift pair (s = sum, t = product) from the trailing 2x2
    a_ = H[hi - 2, hi - 2]
    b_ = H[hi - 2, hi - 1]
    c_ = H[hi - 1, hi - 2]
    d_ = H[hi - 1, hi - 1]
    s = a_ + d_
    t = a_ * d_ - b_ * c_

    # first column of (H - l1 I)(H - l2 I) restricted to the block
    h00 = H[lo, lo]
    h10 = H[lo + 1, lo]
    x0 = h00 * h00 + H[lo, lo + 1] * h10 - s * h00 + t
    y0 = h10 * (h00 + H[lo + 1, lo + 1] - s)
    z0 = h10 * H[lo + 2, lo + 1]

    def chase(k, Hc):
        first = k == lo
        x = jnp.where(first, x0, Hc[k, k - 1])
        y = jnp.where(first, y0, Hc[k + 1, k - 1])
        z = jnp.where(first, z0, Hc[k + 2, k - 1])
        use_z = k <= hi - 3  # last position only needs a 2-rotation
        P = _householder3(x, y, z, use_z)
        # guard the z row when the bulge is only 2 tall
        P = jnp.where(use_z, P,
                      P.at[:, 2].set(jnp.array([0, 0, 1], rdt)).at[2, :].set(
                          jnp.array([0, 0, 1], rdt)))
        k0 = jnp.asarray(k, jnp.int32)
        zero = jnp.zeros((), jnp.int32)
        rows = jax.lax.dynamic_slice(Hc, (k0, zero), (3, n))
        Hc = jax.lax.dynamic_update_slice(
            Hc, jnp.matmul(P, rows, precision=_HI), (k0, zero))
        cols = jax.lax.dynamic_slice(Hc, (zero, k0), (n, 3))
        Hc = jax.lax.dynamic_update_slice(
            Hc, jnp.matmul(cols, P.T, precision=_HI), (zero, k0))
        return Hc

    # chase k = lo .. hi-3; the leftover bulge element is cleaned by the
    # explicit 2x2 rotation below.
    H = jax.lax.fori_loop(lo, hi - 2, chase, H)

    # final step: zero the leftover bulge H[hi-1, hi-3] with a 2-rotation
    # of rows/cols (hi-2, hi-1)
    x = H[hi - 2, hi - 3]
    y = H[hi - 1, hi - 3]
    r = jnp.sqrt(x * x + y * y)
    zero = r == 0
    safe = jnp.where(zero, jnp.ones((), rdt), r)
    cth = jnp.where(zero, jnp.ones((), rdt), x / safe)
    sth = jnp.where(zero, jnp.zeros((), rdt), y / safe)
    rk = H[hi - 2, :]
    rk1 = H[hi - 1, :]
    H = H.at[hi - 2, :].set(cth * rk + sth * rk1)
    H = H.at[hi - 1, :].set(-sth * rk + cth * rk1)
    ck = H[:, hi - 2]
    ck1 = H[:, hi - 1]
    H = H.at[:, hi - 2].set(cth * ck + sth * ck1)
    H = H.at[:, hi - 1].set(-sth * ck + cth * ck1)
    return H


@jax.jit
def _qr_eigenvalues_accel_real(H0: jax.Array, max_sweeps: jax.Array,
                               tol: jax.Array):
    """Real-arithmetic accelerated QR over an ALREADY-HESSENBERG input.
    Returns (eig_planes (2, n), iterations, converged)."""
    n = H0.shape[0]
    rdt = H0.dtype
    tol = tol.astype(rdt)

    if n == 0:
        return jnp.zeros((2, 0), rdt), jnp.zeros((), jnp.int32), jnp.asarray(True)
    if n == 1:
        planes = jnp.stack([jnp.diagonal(H0), jnp.zeros((1,), rdt)])
        return planes, jnp.zeros((), jnp.int32), jnp.asarray(True)

    eig0 = jnp.zeros((2, n), rdt)

    def small(H, i):
        # |H[i, i-1]| negligible relative to its diagonal neighbourhood
        sub = jnp.abs(H[i, i - 1])
        scale = jnp.abs(H[i - 1, i - 1]) + jnp.abs(H[i, i])
        return sub <= tol * jnp.maximum(scale, jnp.ones((), rdt))

    def write1(eig, i, v):
        return eig.at[0, i].set(v)

    def write2(eig, i, H):
        (r1, i1), (r2, i2) = _eig2x2_planes(H[i, i], H[i, i + 1],
                                            H[i + 1, i], H[i + 1, i + 1])
        eig = eig.at[0, i].set(r1).at[1, i].set(i1)
        return eig.at[0, i + 1].set(r2).at[1, i + 1].set(i2)

    if n == 2:  # static: solve analytically, never trace the chase loop
        return (write2(eig0, 0, H0), jnp.zeros((), jnp.int32), jnp.asarray(True))

    def deflate(state):
        def d_cond(s):
            H, hi, eig = s
            can1 = jnp.logical_and(hi >= 2, small(H, hi - 1))
            can2 = jnp.logical_and(hi >= 3, small(H, hi - 2))
            return jnp.logical_and(hi > 2, jnp.logical_or(can1, can2))

        def d_body(s):
            H, hi, eig = s
            can1 = small(H, hi - 1)
            eig1 = write1(eig, hi - 1, H[hi - 1, hi - 1])
            eig2 = write2(eig, hi - 2, H)
            eig = jnp.where(can1, eig1, eig2)
            hi = jnp.where(can1, hi - 1, hi - 2)
            return (H, hi, eig)

        return jax.lax.while_loop(d_cond, d_body, state)

    def cond(c):
        H, hi, eig, sweeps = c
        return jnp.logical_and(hi > 2, sweeps < max_sweeps)

    idx = jnp.arange(n)

    def find_lo(H, hi):
        """Top of the trailing unreduced block: the largest i < hi with a
        negligible subdiagonal H[i, i-1] (0 if none)."""
        if n < 2:
            return jnp.zeros((), jnp.int32)
        sub = jnp.abs(jnp.diagonal(H, offset=-1))  # entry i -> H[i+1, i]
        d = jnp.abs(jnp.diagonal(H))
        scale = jnp.maximum(d[:-1] + d[1:], jnp.ones((), rdt))
        negligible = sub <= tol * scale
        i = idx[1:]  # subdiag entry H[i, i-1] corresponds to position i
        cand = jnp.where(jnp.logical_and(negligible, i < hi), i, 0)
        return jnp.max(cand).astype(jnp.int32)

    def body(c):
        H, hi, eig, sweeps = c
        lo = find_lo(H, hi)
        H = _francis_sweep(H, lo, hi)  # cond + deflate guarantee hi - lo >= 3
        H, hi, eig = deflate((H, hi, eig))
        return H, hi, eig, sweeps + 1

    H, hi0, eig = deflate((H0, jnp.asarray(n, jnp.int32), eig0))
    H, hi, eig, sweeps = jax.lax.while_loop(
        cond, body, (H, hi0, eig, jnp.zeros((), jnp.int32)))

    # finish the trailing <=2 window analytically
    eig_f1 = write1(eig, 0, H[0, 0])                     # hi == 1
    eig_f2 = write2(eig, 0, H)                           # hi == 2
    eig = jnp.where(hi == 1, eig_f1, jnp.where(hi == 2, eig_f2, eig))
    converged = hi <= 2
    return eig, sweeps, converged


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def qr_eigenvalues(M: AbstractMatrix, opts: SolverOptions = QROptions(), *,
                   dtype=None) -> QRResult:
    """All eigenvalues of a dense square matrix via QR iteration.

    Dense-only like the reference (qr_eigenvalues.hpp:131-133); ``dtype``
    asserts the stored scalar type (TypeError on mismatch, :135-138).
    Every mode and dtype runs on the default device.
    """
    if not M.is_dense:
        raise ValueError("qr_eigenvalues: only dense matrices are supported")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "qr_eigenvalues")
    if M.shape[0] != M.shape[1]:
        raise ValueError("qr_eigenvalues_dense: A must be square")

    mode = opts.mode if isinstance(opts, QROptions) else "parity"
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    max_it = jnp.asarray(opts.max_iterations, jnp.int32)
    n = M.shape[0]
    a = jnp.asarray(M.as_dense())

    if mode == "parity":
        return _qr_eigenvalues_parity(a, max_it,
                                      jnp.asarray(opts.tolerance, ftype))

    dtol = opts.deflation_tolerance if isinstance(opts, QROptions) and \
        opts.deflation_tolerance is not None else opts.tolerance
    dtol = jnp.asarray(dtol, ftype)
    complex_a = a.astype(jnp.dtype(complex_dtype_of(a.dtype)))
    if isinstance(opts, QROptions) and opts.compute_vectors and n > 0:
        eigs, V, sweeps, hi = _qr_eigenpairs(complex_a, max_it, dtol)
        return QRResult(eigenvalues=eigs, iterations=sweeps,
                        converged=hi <= 1, eigenvectors=V)
    if np.dtype(M.dtype).kind != "c":
        # real input: real-arithmetic Francis sweeps — complex conjugate
        # pairs come out of analytic 2x2 deflation
        planes, sweeps, converged = _qr_eigenvalues_accel_real(
            hessenberg_dense(a), max_it, dtol)
        return QRResult(eigenvalues=jax.lax.complex(planes[0], planes[1]),
                        iterations=sweeps, converged=converged)
    return _qr_eigenvalues_accel(hessenberg_dense(complex_a), max_it, dtol)
