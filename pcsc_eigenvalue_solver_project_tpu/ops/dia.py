"""Banded (DIA) SpMV in plain ``jax.numpy``.

Every matvec here is a chain of static slices, multiplies and adds over
the stored diagonals. XLA fuses such a chain into one loop that reads each
diagonal once, so the traffic is vals + x + y: the memory-bound floor for
a banded SpMV.

Two layouts:

- natural: ``vals`` is ``(k, n)`` with ``vals[d, i] = A[i, i + off_d]``
  (matrix/dia.py convention); a shift by ``off`` is a padded slice of x;
- interleaved (lane-major): an n-vector is stored as ``(R, 128)`` with
  element ``i`` at ``(i % R, i // R)``, so each of the 128 columns holds a
  contiguous chunk of R elements. A shift by ``off`` is then a row slice of
  a haloed window that carries ``pr`` rows of each neighbouring chunk
  (``il_window``). The distributed solvers fill the window's seam columns
  from the neighbour shard, which keeps their halo exchange to two
  ``(pr, 1)`` permutes per matvec (parallel/dia.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LANES = 128
# Row alignment of the interleaved layout: R is a multiple of this.
DEFAULT_IL_TILE = 64
_HALO_ALIGN = 8


def _shifted(x: jax.Array, off: int, axis: int = -1) -> jax.Array:
    """``s[i] = x[i + off]`` along ``axis``, zero where out of range."""
    if off == 0:
        return x
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    if off > 0:
        pad[axis] = (0, off)
        return jnp.pad(jax.lax.slice_in_dim(x, off, n, axis=axis), pad)
    pad[axis] = (-off, 0)
    return jnp.pad(jax.lax.slice_in_dim(x, 0, n + off, axis=axis), pad)


def _acc_dtype(*dtypes):
    """Accumulation dtype: at least f32 (bf16 diagonals accumulate in f32)."""
    return jnp.result_type(*dtypes, jnp.float32)


def dia_matvec(vals: jax.Array, offsets: tuple, x: jax.Array) -> jax.Array:
    """Natural-layout banded SpMV: ``vals`` (k, n), ``x`` (n,) -> (n,)."""
    y = jnp.zeros(x.shape, _acc_dtype(vals.dtype, x.dtype))
    for d, off in enumerate(offsets):
        y = y + vals[d] * _shifted(x, off)
    return y


def dia_matmat(vals: jax.Array, offsets: tuple, xs: jax.Array) -> jax.Array:
    """Banded SpMM: ``xs`` (nvec, n) -> (nvec, n); one read of the band."""
    ys = jnp.zeros(xs.shape, _acc_dtype(vals.dtype, xs.dtype))
    for d, off in enumerate(offsets):
        ys = ys + vals[d][None] * _shifted(xs, off)
    return ys


def _planes_mac(yr, yi, vr, vi, sr, si):
    return yr + vr * sr - vi * si, yi + vr * si + vi * sr


def dia_matvec_planes(vals_p: jax.Array, offsets: tuple,
                      x_p: jax.Array) -> jax.Array:
    """Split-plane complex SpMV: ``vals_p`` (2, k, n) and ``x_p`` (2, n)
    real re/im planes -> (2, n)."""
    dt = _acc_dtype(vals_p.dtype, x_p.dtype)
    yr = jnp.zeros(x_p.shape[1:], dt)
    yi = jnp.zeros(x_p.shape[1:], dt)
    for d, off in enumerate(offsets):
        s = _shifted(x_p, off)
        yr, yi = _planes_mac(yr, yi, vals_p[0, d], vals_p[1, d], s[0], s[1])
    return jnp.stack([yr, yi])


# --------------------------------------------------------------------------
# Interleaved layout
# --------------------------------------------------------------------------

def il_rows(n: int, tile_s: int = DEFAULT_IL_TILE) -> int:
    """Row count R of the interleaved layout of an n-vector (rounded up so
    that R is a multiple of ``tile_s``)."""
    return -(-(-(-n // LANES)) // tile_s) * tile_s


def il_window_halo(offsets) -> int:
    """Rows ``pr`` of halo an interleaved window carries on each side: the
    bandwidth rounded up to a multiple of 8."""
    bw = max((abs(o) for o in offsets), default=0)
    return max(-(-bw // _HALO_ALIGN) * _HALO_ALIGN, _HALO_ALIGN)


def interleave_vec(x: jax.Array, R: int) -> jax.Array:
    """(n,) -> (R, 128) lane-major: element i at (i % R, i // R)."""
    n = x.shape[0]
    return jnp.pad(x, (0, R * LANES - n)).reshape(LANES, R).T


def deinterleave_vec(x_il: jax.Array, n: int) -> jax.Array:
    """(R, 128) lane-major -> (n,)."""
    return x_il.T.reshape(-1)[:n]


def interleave_dia_vals(vals: jax.Array, R: int) -> jax.Array:
    """(k, n) diagonals -> (k, R, 128) lane-major (one-time transform)."""
    k, n = vals.shape
    return jnp.pad(vals, ((0, 0), (0, R * LANES - n))).reshape(
        k, LANES, R).transpose(0, 2, 1)


def il_window(x_il: jax.Array, pr: int) -> jax.Array:
    """Haloed window (R + 2*pr, 128): pr rows above and below each chunk
    carry the tail and head of the neighbouring column's chunk (zero at
    the array's ends). Then ``x[i + off]`` for ``|off| <= pr`` is
    ``window[pr + (i % R) + off, i // R]``."""
    R = x_il.shape[0]
    top = jnp.pad(x_il[R - pr:, : LANES - 1], ((0, 0), (1, 0)))
    bot = jnp.pad(x_il[:pr, 1:], ((0, 0), (0, 1)))
    return jnp.concatenate([top, x_il, bot], axis=0)


def _check_halo(offsets, R: int, what: str) -> int:
    pr = il_window_halo(offsets)
    if pr > R:
        raise ValueError(f"{what}: bandwidth exceeds chunk size R")
    return pr


def dia_matvec_il_window(vals_il: jax.Array, offsets: tuple,
                         w: jax.Array) -> jax.Array:
    """Interleaved SpMV from a caller-built haloed window (R + 2*pr, 128).

    The halo rows may carry any values, e.g. the neighbour shard's entries
    in the distributed row partition:
    ``y[s, l] = sum_d vals[d, s, l] * w[pr + s + off_d, l]``.
    """
    k, R, _ = vals_il.shape
    pr = il_window_halo(offsets)
    if w.shape[0] != R + 2 * pr:
        raise ValueError(
            f"dia_matvec_il_window: window has {w.shape[0]} rows, "
            f"expected R + 2*pr = {R + 2 * pr}")
    dt = _acc_dtype(vals_il.dtype, w.dtype)
    y = jnp.zeros((R, w.shape[1]), dt)
    for d, off in enumerate(offsets):
        seg = jax.lax.slice_in_dim(w, pr + off, pr + off + R, axis=0)
        y = y + vals_il[d].astype(dt) * seg.astype(dt)
    return y


def dia_matvec_il(vals_il: jax.Array, offsets: tuple,
                  x_il: jax.Array) -> jax.Array:
    """Interleaved-domain banded SpMV: (k, R, 128) x (R, 128) -> (R, 128).

    Operands and result stay in the layout of ``interleave_vec`` /
    ``interleave_dia_vals``, so solver loops never convert. Requires
    bandwidth <= R.
    """
    pr = _check_halo(offsets, vals_il.shape[1], "dia_matvec_il")
    return dia_matvec_il_window(vals_il, offsets, il_window(x_il, pr))


def dia_matmat_il_window(vals_il: jax.Array, offsets: tuple,
                         w: jax.Array) -> jax.Array:
    """Interleaved block SpMM from caller-built windows
    (nvec, R + 2*pr, 128) -> (nvec, R, 128); one read of the band serves
    every vector (cf. ``dia_matvec_il_window``)."""
    k, R, _ = vals_il.shape
    pr = il_window_halo(offsets)
    if w.shape[1] != R + 2 * pr:
        raise ValueError(
            f"dia_matmat_il_window: window has {w.shape[1]} rows, "
            f"expected R + 2*pr = {R + 2 * pr}")
    dt = _acc_dtype(vals_il.dtype, w.dtype)
    ys = jnp.zeros((w.shape[0], R, w.shape[2]), dt)
    for d, off in enumerate(offsets):
        seg = jax.lax.slice_in_dim(w, pr + off, pr + off + R, axis=1)
        ys = ys + vals_il[d][None].astype(dt) * seg.astype(dt)
    return ys


def dia_matmat_il(vals_il: jax.Array, offsets: tuple,
                  xs_il: jax.Array) -> jax.Array:
    """Interleaved-domain block SpMM: (nvec, R, 128) -> (nvec, R, 128)."""
    pr = _check_halo(offsets, vals_il.shape[1], "dia_matmat_il")
    w = jax.vmap(lambda v: il_window(v, pr))(xs_il)
    return dia_matmat_il_window(vals_il, offsets, w)


def dia_matvec_il_planes(vals_il_p: jax.Array, offsets: tuple,
                         x_il_p: jax.Array) -> jax.Array:
    """Interleaved split-plane complex SpMV: vals (2, k, R, 128) real,
    x (2, R, 128) real -> (2, R, 128) real (y = A x with A, x complex)."""
    _, k, R, _ = vals_il_p.shape
    pr = _check_halo(offsets, R, "dia_matvec_il_planes")
    w = jax.vmap(lambda v: il_window(v, pr))(x_il_p)
    dt = _acc_dtype(vals_il_p.dtype, w.dtype)
    yr = jnp.zeros((R, w.shape[2]), dt)
    yi = jnp.zeros((R, w.shape[2]), dt)
    for d, off in enumerate(offsets):
        s = jax.lax.slice_in_dim(w, pr + off, pr + off + R, axis=1).astype(dt)
        yr, yi = _planes_mac(yr, yi, vals_il_p[0, d].astype(dt),
                             vals_il_p[1, d].astype(dt), s[0], s[1])
    return jnp.stack([yr, yi])
