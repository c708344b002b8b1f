"""Matrix-product precision for the solvers.

On the GPU a float32 dot may run in TF32 under JAX's default precision,
which keeps about three decimal digits. The Krylov orthogonalisation, the
Rayleigh-Ritz products and the dense reductions need full float32, so the
solvers trace under ``full_precision``; callers set nothing.
"""

from __future__ import annotations

import functools

import jax


def full_precision(fn):
    """Run ``fn`` (and trace everything it calls) with HIGHEST precision
    for every matrix product whose precision is not set explicitly."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
