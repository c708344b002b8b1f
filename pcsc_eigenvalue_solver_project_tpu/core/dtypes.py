"""Scalar dtype policy for the eigenvalue solver.

Reference parity: the C++ library restricts scalars with ``ScalarConcept``
(/root/reference/src/core/types.hpp:28-30) to floating-point and
``std::complex`` of floating-point. Here the same contract is expressed as a
set of allowed JAX dtypes. ``float64``/``complex128`` require
``jax.config.update("jax_enable_x64", True)`` (done in tests).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# The allowed scalar dtypes (the ScalarConcept analogue).
REAL_DTYPES = (jnp.float32, jnp.float64)
COMPLEX_DTYPES = (jnp.complex64, jnp.complex128)
SCALAR_DTYPES = REAL_DTYPES + COMPLEX_DTYPES

_CANON = {np.dtype(d): np.dtype(d) for d in SCALAR_DTYPES}
# common aliases
_ALIASES = {
    np.dtype(np.float16): np.dtype(np.float32),
}


def canonical_dtype(dtype) -> np.dtype:
    """Validate and canonicalise a scalar dtype.

    Raises ``TypeError`` for dtypes outside the scalar concept (ints, bools,
    bf16...), mirroring the compile-time rejection by ``ScalarConcept``.
    """
    dt = np.dtype(dtype)
    if dt in _CANON:
        return dt
    raise TypeError(
        f"dtype {dt} does not satisfy the scalar concept "
        f"(allowed: float32, float64, complex64, complex128)"
    )


def is_complex_dtype(dtype) -> bool:
    """``is_complex_of_floating`` analogue (types.hpp:15-21)."""
    return np.dtype(dtype).kind == "c"


def real_dtype_of(dtype) -> np.dtype:
    """The real dtype underlying a scalar dtype (NumTraits<Scalar>::Real)."""
    dt = canonical_dtype(dtype)
    if dt.kind == "c":
        return np.dtype(np.float32) if dt == np.dtype(np.complex64) else np.dtype(np.float64)
    return dt


def complex_dtype_of(dtype) -> np.dtype:
    """The complex dtype with the same precision as ``dtype``."""
    dt = canonical_dtype(dtype)
    if dt.kind == "c":
        return dt
    return np.dtype(np.complex64) if dt == np.dtype(np.float32) else np.dtype(np.complex128)


def check_scalar_type(array_dtype, expected_dtype, what: str) -> None:
    """Runtime scalar-type guard.

    Parity with ``M.scalar_type() != typeid(Scalar)`` checks that raise
    ``std::runtime_error("...: scalar type mismatch")`` (e.g.
    power_method.hpp:137-139). Raises ``TypeError``.
    """
    if np.dtype(array_dtype) != np.dtype(expected_dtype):
        raise TypeError(f"{what}: scalar type mismatch "
                        f"(stored {np.dtype(array_dtype)}, requested {np.dtype(expected_dtype)})")
