"""Matrix-vector product kernels (single chip, XLA level).

These are the hot ops of the whole framework — the reference's ``A * x``
inside power iteration (power_method.hpp:69) is a sequential Eigen
dense-GEMV / CSC-SpMV. Here:

- dense matvec lowers to an XLA dot at full f32 precision;
- CSR SpMV uses gather + segment-sum (XLA scatter-add), with an ELL
  (padded row-width) variant whose gather/multiply/reduce fuses better;
- the packed gather-ELL evaluation lives in ``ops/gell.py`` (via
  ``SparseCSR.to_gell()``).

All functions are shape-static and jit-friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dense_matvec(a: jax.Array, x: jax.Array) -> jax.Array:
    """``a @ x`` with accumulation in the array dtype."""
    return jnp.matmul(a, x, precision=jax.lax.Precision.HIGHEST)


def dense_rmatvec(a: jax.Array, x: jax.Array) -> jax.Array:
    """``a^H @ x``."""
    return jnp.matmul(jnp.conj(a).T, x, precision=jax.lax.Precision.HIGHEST)


def csr_matvec(rows: jax.Array, indices: jax.Array, data: jax.Array,
               x: jax.Array, n_rows: int) -> jax.Array:
    """CSR/COO SpMV via gather + segment-sum.

    ``rows``/``indices``/``data`` are the nnz-length expanded-row-id, column
    index, and value arrays (row-sorted). ``n_rows`` must be static.
    """
    contrib = data * jnp.take(x, indices, axis=0)
    return jax.ops.segment_sum(contrib, rows, num_segments=n_rows,
                               indices_are_sorted=True)


def ell_matvec(ell_indices: jax.Array, ell_data: jax.Array, x: jax.Array) -> jax.Array:
    """ELLPACK SpMV: per-row padded gather then row reduction.

    ``ell_indices``/``ell_data`` have shape (n_rows, max_row_nnz); padding
    entries carry value 0 (their column index is arbitrary but in range).
    """
    gathered = jnp.take(x, ell_indices, axis=0)
    return jnp.sum(ell_data * gathered, axis=1)
