"""Double-single (two-float compensated) arithmetic.

The reference's native scalar is ``double``/``complex<double>``
(/root/reference/src/core/types.hpp:28-30; the demo runs entirely in
complex<double>, main.cpp:42). Here every value is carried as an
unevaluated pair ``hi + lo`` of f32 with |lo| <= ulp(hi)/2, giving ~2^-48
(~3.6e-15) relative per operation — double-precision-class accuracy from
float32 arithmetic.

Classical error-free transformations (Dekker 1971, Knuth TwoSum) built
from jnp elementwise ops so XLA fuses them into the surrounding
kernels; products use Dekker's 12-bit split (no FMA dependence, exact
on f32).  All functions are shape-polymorphic and jit-safe.

Used by ``dia_matvec_ds`` (the banded SpMV at f64-class accuracy) and
``power_iteration_ds64`` (solvers/power.py) — validated to <= 1e-12
against host f64 on the 100K banded config (tests/test_ds64.py) with
the Gnnz/s cost recorded by ``bench.py --suite ds64``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SPLIT = jnp.float32(4097.0)        # 2^12 + 1 (f32: 24-bit mantissa)

# Every error-free transform forces its intermediates through an
# optimization barrier. Two separate compilers break the compensation
# algebra otherwise (round-5 diagnosis, pinned by tests/test_ds64.py):
# (1) XLA's algebraic simplifier folds it symbolically (``e = b -
# (s - a)`` with ``s = a + b`` simplifies to 0); (2) with
# ``--xla_allow_excess_precision=true`` fused f32 chains evaluate in wider precision and round once at the
# end, so ``s = p + e`` is NOT the f32-rounded sum the algorithm's
# error analysis requires — the same expression then yields different
# roundings at its two uses and the compensation term is garbage.
# Barriers force a materialized f32 value at every EFT-critical edge.
# Eager op-by-op execution was exact all along; only jit-fused graphs
# degraded (to ~2^-24, i.e. plain f32).
#
# Fence choice matters (all probed by HLO dump + numeric check):
# - ``optimization_barrier`` is dropped by the CPU pipeline before
#   fusion (opt-barrier count 0 in the compiled module);
# - a double ``bitcast_convert_type`` round-trip is eliminated by the
#   algebraic simplifier (bitcast(bitcast(x)) -> x);
# - ``reduce_precision(x, 8, 23)`` — i.e. "round to exactly f32" —
#   SURVIVES, is numerically the identity on finite f32, and forces a
#   materialized correctly-rounded value the rewrites cannot cross.
# The fences cost a cheap elementwise op and buy backend-independent
# correctness (a GPU compiler may also contract a multiply and an add
# into one FMA; the fences keep every EFT-critical value rounded).


def _fence(x):
    return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)


def _ob(x):
    if isinstance(x, tuple):
        return tuple(_fence(v) for v in x)
    return _fence(x)


def two_sum(a, b):
    """Knuth: s + e == a + b exactly (no magnitude assumption)."""
    s = _ob(a + b)
    bb = _ob(s - a)
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker: requires |a| >= |b|; s + e == a + b exactly."""
    s = _ob(a + b)
    t = _ob(s - a)
    return s, b - t


def _split(a):
    c = _ob(_SPLIT * a)
    t = _ob(c - a)
    hi = _ob(c - t)
    # the lo part must be opaque too: leaving it as the expression
    # ``a - hi`` lets the simplifier reassemble (ah+al)(bh+bl) - p into
    # fl(a*b) - p == 0 inside two_prod, zeroing the compensation
    return hi, _ob(a - hi)


def two_prod(a, b):
    """p + e == a * b exactly (Dekker split; f32 products of 12-bit
    halves are exact)."""
    p = _ob(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_add(xh, xl, yh, yl):
    """(xh + xl) + (yh + yl) renormalized to a ds pair."""
    s, e = two_sum(xh, yh)
    e = _ob(e + (xl + yl))
    return fast_two_sum(s, e)


def ds_mul(xh, xl, yh, yl):
    """(xh + xl) * (yh + yl) renormalized to a ds pair."""
    p, e = two_prod(xh, yh)
    e = _ob(e + (xh * yl + xl * yh))
    return fast_two_sum(p, e)


def ds_mul_f32(xh, xl, y):
    """(xh + xl) * y for plain-f32 ``y``."""
    p, e = two_prod(xh, y)
    e = _ob(e + xl * y)
    return fast_two_sum(p, e)


def ds_from_f64(x) -> tuple[jax.Array, jax.Array]:
    """Host-side split of f64 data into a ds pair (exact)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def ds_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def ds_sum(xh, xl):
    """Compensated reduction of a ds vector to one ds scalar: pairwise
    tree of ds_add levels (log2(n) vectorized steps — each level is
    exact-transform accurate, so the total error is O(log n * 2^-48))."""
    n = xh.shape[-1]
    m = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    pad = m - n
    if pad:
        xh = jnp.pad(xh, [(0, 0)] * (xh.ndim - 1) + [(0, pad)])
        xl = jnp.pad(xl, [(0, 0)] * (xl.ndim - 1) + [(0, pad)])
    while m > 1:
        m //= 2
        xh, xl = ds_add(xh[..., :m], xl[..., :m], xh[..., m:], xl[..., m:])
    return xh[..., 0], xl[..., 0]


def ds_dot(xh, xl, yh, yl):
    """Compensated inner product: elementwise ds_mul then tree ds_sum."""
    ph, pl = ds_mul(xh, xl, yh, yl)
    return ds_sum(ph, pl)


def ds_rsqrt(sh, sl):
    """1/sqrt of a ds scalar via one Newton step on the f32 seed:
    r' = r * (1.5 - 0.5 * s * r^2), all in ds — doubles the seed's
    accurate bits (~24 -> ~48)."""
    r0 = jax.lax.rsqrt(jnp.maximum(sh, jnp.float32(1e-38)))
    r2h, r2l = ds_mul_f32(*ds_mul_f32(sh, sl, r0), r0)      # s * r0^2
    th, tl = ds_add(jnp.float32(1.5), jnp.float32(0.0),
                    -0.5 * r2h, -0.5 * r2l)
    return ds_mul_f32(th, tl, r0)


def dia_matvec_ds(data_h, data_l, offsets, xh, xl):
    """Banded (DIA, row-aligned convention) SpMV in ds arithmetic:
    y = A @ x with A and x as ds pairs. Pure elementwise jnp — XLA
    fuses the shift/multiply/compensate chain; the layout matches
    ``ops.dia.dia_matvec`` (entry (i, i+off) at data[d, i])."""
    n = xh.shape[0]
    yh = jnp.zeros(n, jnp.float32)
    yl = jnp.zeros(n, jnp.float32)
    for d, off in enumerate(offsets):
        if off >= 0:
            src_h = jnp.pad(xh[off:], (0, off))
            src_l = jnp.pad(xl[off:], (0, off))
        else:
            src_h = jnp.pad(xh[:off], (-off, 0))
            src_l = jnp.pad(xl[:off], (-off, 0))
        ph, pl = ds_mul(data_h[d], data_l[d], src_h, src_l)
        yh, yl = ds_add(yh, yl, ph, pl)
    return yh, yl
