"""Power iteration — dominant eigenpair.

Reference parity (/root/reference/src/power_method/power_method.hpp:47-148):

    x_{k+1} = A x_k / ||A x_k||,   lambda_k = x_k^H (A x_k)

with convergence when successive Rayleigh quotients satisfy
``|l_new - l| <= tol * (1 + |l_new|)`` (power_method.hpp:83-91 via
tolerance.hpp:29-33), breakdown (``||Ax|| == 0``) exiting with
``converged=False`` (power_method.hpp:73-76), and ``iterations == k+1`` at
the breaking iteration (power_method.hpp:87,95).

Structure: the whole loop is one ``lax.while_loop`` under jit
with an on-device convergence flag in the carry — zero host round-trips per
iteration. The reference performs TWO matvecs per iteration (``A*x`` at :69
and ``x.dot(A*x)`` at :81); here the Rayleigh-quotient matvec ``A x_{k+1}``
is carried over as the next iteration's ``y`` — the identical sequence of
floating-point operations with exactly ONE matvec per iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dtypes import check_scalar_type, real_dtype_of
from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..core.tolerance import is_close_relative
from ..matrix.protocol import (AbstractMatrix, decode_result,
                               require_nonempty, require_square)
from ..utils.prng import default_key, random_unit_vector


def power_init_carry(matvec, x0: jax.Array):
    """Initial loop carry: (k, x, z=A@x, lambda, initialized, converged,
    used_iterations, done). Exposed so chunked/resumable drivers
    (utils/checkpoint.py) can persist and re-enter the loop."""
    return (
        jnp.zeros((), jnp.int32),
        x0,
        matvec(x0),
        jnp.zeros((), x0.dtype),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((), jnp.int32),
        jnp.asarray(False),
    )


def power_carry_loop(matvec, vdot, norm, carry, max_iterations, tol):
    """Advance the power-iteration carry until ``k == max_iterations`` or
    convergence/breakdown. Generic over the reduction primitives so the
    distributed path (``parallel/power.py``) can inject ``psum``-based
    ``vdot``/``norm`` inside ``shard_map``."""
    dtype = carry[1].dtype
    rdt = jnp.dtype(real_dtype_of(dtype))

    def cond(c):
        k, x, z, lam, initialized, converged, used, done = c
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        k, x, z, lam, initialized, converged, used, done = c
        y = z  # == A @ x, computed at the end of the previous iteration
        norm_y = norm(y).astype(rdt)
        breakdown = norm_y == 0
        safe = jnp.where(breakdown, jnp.ones((), rdt), norm_y).astype(dtype)
        x_new = y / safe
        z_new = matvec(x_new)
        lam_new = vdot(x_new, z_new)  # x^H (A x): conjugates first arg like Eigen dot
        conv_now = jnp.logical_and(initialized,
                                   is_close_relative(lam_new, lam, tol))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        return (
            k + 1,
            jnp.where(breakdown, x, x_new),
            jnp.where(breakdown, z, z_new),
            jnp.where(breakdown, lam, lam_new),
            jnp.logical_or(initialized, jnp.logical_not(breakdown)),
            jnp.logical_or(converged, conv_now),
            k + 1,  # usedIters = k+1 on every executed iteration (power_method.hpp:87,95)
            jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)),
        )

    return jax.lax.while_loop(cond, body, carry)


def carry_to_result(carry) -> EigenResult:
    k, x, z, lam, initialized, converged, used, done = carry
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used,
                       converged=converged)


def power_iteration_loop(matvec, vdot, norm, x0: jax.Array,
                         max_iterations, tol) -> EigenResult:
    """Run the full power iteration from a fresh start vector."""
    carry = power_carry_loop(matvec, vdot, norm, power_init_carry(matvec, x0),
                             max_iterations, tol)
    return carry_to_result(carry)


@jax.jit
def _power_loop(M: AbstractMatrix, x0: jax.Array, max_iterations: jax.Array,
                tol: jax.Array) -> EigenResult:
    # max_iterations/tol ride as traced scalars: changing options never
    # retriggers compilation (only shapes/dtypes/matrix kind do).
    return power_iteration_loop(M.matvec, jnp.vdot, jnp.linalg.norm, x0,
                                max_iterations, tol)


@jax.jit
def _power_loop_split(M, x0: jax.Array, max_iterations: jax.Array,
                      tol: jax.Array) -> EigenResult:
    """Split-plane complex power loop: x is (2, n) real planes, lambda a
    (2,) scalar. Same structure and stopping semantics as the complex-dtype
    loop."""
    from ..ops.split_complex import (splitc_is_close_relative, splitc_norm,
                                     splitc_vdot)
    rdt = x0.dtype

    def cond(c):
        k, x, z, lam, initialized, converged, used, done = c
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        k, x, z, lam, initialized, converged, used, done = c
        y = z
        norm_y = splitc_norm(y)
        breakdown = norm_y == 0
        safe = jnp.where(breakdown, jnp.ones((), rdt), norm_y)
        x_new = y / safe
        z_new = M.matvec(x_new)
        lam_new = splitc_vdot(x_new, z_new)
        conv_now = jnp.logical_and(initialized,
                                   splitc_is_close_relative(lam_new, lam, tol))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        return (
            k + 1,
            jnp.where(breakdown, x, x_new),
            jnp.where(breakdown, z, z_new),
            jnp.where(breakdown, lam, lam_new),
            jnp.logical_or(initialized, jnp.logical_not(breakdown)),
            jnp.logical_or(converged, conv_now),
            k + 1,
            jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)),
        )

    init = (
        jnp.zeros((), jnp.int32),
        x0,
        M.matvec(x0),
        jnp.zeros((2,), rdt),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((), jnp.int32),
        jnp.asarray(False),
    )
    k, x, z, lam, initialized, converged, used, done = jax.lax.while_loop(
        cond, body, init)
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used,
                       converged=converged)


def power_method_split_complex(M, opts: SolverOptions = SolverOptions(), *,
                               key=None, x0=None) -> EigenResult:
    """Power iteration on a split-plane complex operator
    (matrix/split_complex.py). ``EigenResult.eigenvalue`` is a (2,) plane
    scalar and ``eigenvector`` a (2, n) plane vector; convert on host with
    ``ops.split_complex.from_planes``."""
    n = M.shape[0]
    if M.shape[0] != M.shape[1]:
        raise ValueError("power_method: matrix must be square")
    if n == 0:
        raise ValueError("power_method: matrix has zero size")
    rdt = jnp.dtype(M.dtype)
    if x0 is None:
        # uniform [-1,1] re/im planes (Eigen Random-complex analogue),
        # generated as real arrays so no complex op ever reaches the device
        x0 = jax.random.uniform(key if key is not None else default_key(),
                                (2, n), rdt, minval=-1.0, maxval=1.0)
        nrm = jnp.sqrt(jnp.sum(x0 * x0))
        x0 = x0 / jnp.where(nrm == 0, 1, nrm)
    else:
        x0 = jnp.asarray(x0, rdt)
        if x0.shape != (2, n):
            raise ValueError("power_method_split_complex: x0 must be (2, n) planes")
        nrm = jnp.sqrt(jnp.sum(x0 * x0))
        x0 = jnp.where(nrm == 0, x0, x0 / jnp.where(nrm == 0, 1, nrm))
    x0 = M.encode_vec(x0)  # identity for SplitComplexDIA; interleave otherwise
    r = _power_loop_split(M, x0,
                          jnp.asarray(opts.max_iterations, jnp.int32),
                          jnp.asarray(opts.tolerance, rdt))
    return decode_result(M, r)


def power_method(M: AbstractMatrix, opts: SolverOptions = SolverOptions(), *,
                 dtype=None, key=None, x0=None) -> EigenResult:
    """Dominant-eigenpair power iteration on a dense or sparse matrix.

    ``dtype`` is the ``Scalar`` template-parameter analogue: when given, a
    mismatch with the stored dtype raises ``TypeError`` (parity with
    power_method.hpp:137-139). ``key``/``x0`` control the random start.
    Split-plane complex operators are routed to the plane-based loop.
    """
    from ..matrix.split_complex import (InterleavedSplitComplexDIA,
                                        SplitComplexDIA)
    if isinstance(M, (SplitComplexDIA, InterleavedSplitComplexDIA)):
        return power_method_split_complex(M, opts, key=key, x0=x0)
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "power_method")
    require_square(M, "power_method")
    require_nonempty(M, "power_method")
    # Iterate in at least f32 even when the operator stores bf16 diagonals
    # (the interleaved-DIA fast path): matvec accumulates in f32 already.
    vec_dt = jnp.promote_types(M.dtype, jnp.float32)
    if x0 is None:
        x0 = random_unit_vector(key if key is not None else default_key(),
                                M.shape[0], vec_dt)
    else:
        x0 = jnp.asarray(x0, vec_dt)
        nrm = jnp.linalg.norm(x0)
        x0 = jnp.where(nrm == 0, x0, x0 / jnp.where(nrm == 0, 1, nrm).astype(vec_dt))
    # Solve in the operator's vector domain (identity for most kinds;
    # lane-major interleaved for InterleavedDIA) — encode once, iterate
    # domain-native, decode the eigenvector once.
    x0 = M.encode_vec(x0)
    r = _power_loop(M, x0, jnp.asarray(opts.max_iterations, jnp.int32),
                    jnp.asarray(opts.tolerance, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32))
    return decode_result(M, r)


# ---------------------------------------------------------------------------
# Double-single (f64-class accuracy from f32) power iteration.
# The reference's scalar contract is double precision (types.hpp:28-30);
# this path runs the same loop in two-float compensated arithmetic
# (ops/ds64.py) at ~2^-48 relative per op.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("offsets",))
def _power_loop_ds64(data_h, data_l, offsets, x0h, x0l,
                     max_iterations: jax.Array, tol: jax.Array):
    from ..ops.ds64 import (dia_matvec_ds, ds_add, ds_dot, ds_mul_f32,
                            ds_rsqrt)

    def matvec(xh, xl):
        return dia_matvec_ds(data_h, data_l, offsets, xh, xl)

    def cond(c):
        k = c[0]
        done = c[-1]
        return jnp.logical_and(k < max_iterations, jnp.logical_not(done))

    def body(c):
        (k, xh, xl, zh, zl, lh, ll, initialized, converged, used, done) = c
        n2h, n2l = ds_dot(zh, zl, zh, zl)
        breakdown = n2h == 0.0
        rh, rl = ds_rsqrt(jnp.where(breakdown, jnp.float32(1.0), n2h),
                          jnp.where(breakdown, jnp.float32(0.0), n2l))
        xnh, xnl = ds_mul_f32(*ds_mul_f32(zh, zl, rh), 1.0)
        # second-order: x = z * (rh + rl) = z*rh + z*rl
        c2h, c2l = ds_mul_f32(zh, zl, rl)
        xnh, xnl = ds_add(xnh, xnl, c2h, c2l)
        znh, znl = matvec(xnh, xnl)
        lnh, lnl = ds_dot(xnh, xnl, znh, znl)
        dh, _dl = ds_add(lnh, lnl, -lh, -ll)
        conv_now = jnp.logical_and(
            initialized, jnp.abs(dh) <= tol * (1.0 + jnp.abs(lnh)))
        conv_now = jnp.logical_and(conv_now, jnp.logical_not(breakdown))
        keep = jnp.logical_not(breakdown)

        def sel(new, old):
            return jnp.where(keep, new, old)

        return (k + 1, sel(xnh, xh), sel(xnl, xl), sel(znh, zh),
                sel(znl, zl), sel(lnh, lh), sel(lnl, ll),
                jnp.logical_or(initialized, keep),
                jnp.logical_or(converged, conv_now), k + 1,
                jnp.logical_or(done, jnp.logical_or(breakdown, conv_now)))

    z0h, z0l = matvec(x0h, x0l)
    init = (jnp.zeros((), jnp.int32), x0h, x0l, z0h, z0l,
            jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32),
            jnp.asarray(False), jnp.asarray(False),
            jnp.zeros((), jnp.int32), jnp.asarray(False))
    out = jax.lax.while_loop(cond, body, init)
    (_k, xh, xl, _zh, _zl, lh, ll, _ini, converged, used, _done) = out
    return xh, xl, lh, ll, used, converged


def power_method_ds64(M, opts: SolverOptions = SolverOptions(), *,
                      key=None, x0=None) -> EigenResult:
    """Dominant eigenpair of a real banded ``SparseDIA`` operator at
    double-precision-class accuracy, entirely on-chip: the reference
    power loop (power_method.hpp:47-99, same stopping rule, breakdown
    semantics, and k+1 iteration count) in two-float compensated
    arithmetic (ops/ds64.py). The returned eigenvalue/eigenvector are
    float64 (hi+lo recombined on the device when x64 is enabled, on the
    host otherwise); accuracy vs a float64 loop is <= ~1e-12 relative
    (tests/test_ds64.py)."""
    from ..matrix.dia import SparseDIA
    from ..ops.ds64 import ds_from_f64, ds_to_f64
    if not isinstance(M, SparseDIA):
        raise ValueError("power_method_ds64: operator must be a SparseDIA")
    require_square(M, "power_method_ds64")
    require_nonempty(M, "power_method_ds64")
    if np.dtype(M.dtype).kind == "c":
        raise ValueError("power_method_ds64: real operators only")
    n = M.shape[0]
    data64 = np.asarray(M.data, np.float64)
    dh, dl = ds_from_f64(data64)
    if x0 is None:
        x0 = random_unit_vector(key if key is not None else default_key(),
                                n, np.float64)
    xh, xl = ds_from_f64(np.asarray(x0, np.float64))
    out = _power_loop_ds64(dh, dl, tuple(M.offsets), xh, xl,
                           jnp.asarray(opts.max_iterations, jnp.int32),
                           jnp.asarray(opts.tolerance, jnp.float32))
    rxh, rxl, lh, ll, used, converged = out
    if jax.config.jax_enable_x64:
        f64 = jnp.float64
        return EigenResult(
            eigenvalue=lh.astype(f64) + ll.astype(f64),
            eigenvector=rxh.astype(f64) + rxl.astype(f64),
            iterations=used, converged=converged)
    rxh, rxl, lh, ll, used, converged = jax.device_get(out)
    return EigenResult(
        eigenvalue=np.float64(lh) + np.float64(ll),
        eigenvector=ds_to_f64(rxh, rxl),
        iterations=np.int32(used),
        converged=np.bool_(converged))
