"""Split-plane complex arithmetic — complex numbers as (2, ...) real arrays.

The split-complex operators (matrix/split_complex.py) carry complex
numbers (ScalarConcept, types.hpp:28-30; the reference demo runs entirely
in complex<double>) as re/im planes in axis 0 of a real array:

    vector  z  -> (2, n)    scalars -> (2,)    diagonals -> (2, k, n)

Host conversion helpers plus the algebra the solver loops need (conjugating
dot, norm, divide-by-scalar, relative-tolerance check). All ops are real
jnp.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_planes(z) -> jax.Array:
    """Host/any: complex array -> (2, ...) real planes."""
    z = jnp.asarray(z)
    rdt = jnp.float32 if z.dtype in (jnp.complex64, jnp.float32) else jnp.float64
    return jnp.stack([jnp.real(z).astype(rdt), jnp.imag(z).astype(rdt)])


def from_planes(p) -> np.ndarray:
    """Planes -> host complex array."""
    p = np.asarray(p)
    cdt = np.complex64 if p.dtype == np.float32 else np.complex128
    return (p[0] + 1j * p[1]).astype(cdt)


def splitc_mul(a, b):
    """(2,...) * (2,...) complex multiply."""
    return jnp.stack([a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]])


def splitc_vdot(a, b):
    """sum(conj(a) * b) over all trailing axes -> (2,) scalar planes."""
    re = jnp.sum(a[0] * b[0] + a[1] * b[1])
    im = jnp.sum(a[0] * b[1] - a[1] * b[0])
    return jnp.stack([re, im])


def splitc_norm(a):
    """Real 2-norm of a split-complex vector."""
    return jnp.sqrt(jnp.sum(a[0] * a[0] + a[1] * a[1]))


def splitc_abs(s):
    """|s| for a (2,) scalar."""
    return jnp.sqrt(s[0] * s[0] + s[1] * s[1])


def splitc_scale(a, s_real):
    """Multiply planes by a real scalar."""
    return a * s_real


def splitc_div_scalar(a, s):
    """a / s for (2, n) planes and a (2,) scalar."""
    denom = s[0] * s[0] + s[1] * s[1]
    safe = jnp.where(denom == 0, jnp.ones((), denom.dtype), denom)
    re = (a[0] * s[0] + a[1] * s[1]) / safe
    im = (a[1] * s[0] - a[0] * s[1]) / safe
    return jnp.stack([re, im])


def splitc_is_close_relative(a, b, tol):
    """Reference stopping rule |a-b| <= tol*(1+|a|) on (2,) scalars
    (tolerance.hpp:29-33)."""
    diff = splitc_abs(a - b)
    return diff <= tol * (1.0 + splitc_abs(a))
