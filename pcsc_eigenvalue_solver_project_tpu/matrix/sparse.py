"""Sparse matrix types: CSR (authoritative) and ELL (padded rows).

Replaces the sparse arm of ``EigSol::Matrix`` (``Matrix::Sparse<Scalar>`` =
``Eigen::SparseMatrix<S>``; /root/reference/src/matrix/matrix.hpp:39-44,
89-94). The reference ingests COO triplets and compresses
(file_matrix_reader.hpp:84-132); here COO is ingested on host with NumPy,
row-sorted, and stored as CSR plus an expanded row-id array so SpMV can use
gather + segment-sum without dynamic shapes.

``SparseELL`` is the padded fixed-row-width layout: every row is padded to
the maximum row nnz so the SpMV becomes one 2-D gather + row reduction —
static shapes, no scatter. The packed gather-ELL for unstructured
matrices is in ``matrix/gell.py`` (``to_gell()``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dtypes import canonical_dtype
from ..ops.matvec import csr_matvec, ell_matvec
from .protocol import AbstractMatrix


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseCSR(AbstractMatrix):
    """CSR matrix. Leaves: data/indices/rows/indptr; shape is static.

    ``rows`` is the per-nnz row id (COO expansion of ``indptr``), kept so
    SpMV and conversions avoid dynamic-length ``repeat``s under jit.
    """

    data: jax.Array      # (nnz,) scalar dtype
    indices: jax.Array   # (nnz,) int32 column indices, row-major sorted
    rows: jax.Array      # (nnz,) int32 row ids, sorted ascending
    indptr: jax.Array    # (n_rows + 1,) int32
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    # --- constructors ---
    @staticmethod
    def from_coo(row, col, values, shape, dtype=None, *,
                 sum_duplicates: bool = True) -> "SparseCSR":
        """Build from COO triplets (host-side).

        With ``sum_duplicates=False`` a repeated (row, col) raises
        ``ValueError`` — parity with Eigen ``insert()`` which rejects
        duplicate insertion (used by the reference reader,
        file_matrix_reader.hpp:118-128).
        """
        n_rows, n_cols = map(int, shape)
        if dtype is not None:
            dtype = canonical_dtype(dtype)
        r = np.asarray(row, dtype=np.int64)
        c = np.asarray(col, dtype=np.int64)
        v = np.asarray(values, dtype=dtype)
        if not (r.shape == c.shape == v.shape) or r.ndim != 1:
            raise ValueError("SparseCSR.from_coo: row/col/values must be 1-D of equal length")
        if r.size and (r.min() < 0 or r.max() >= n_rows or c.min() < 0 or c.max() >= n_cols):
            raise ValueError("Sparse indices out of range")
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        if r.size:
            dup = (np.diff(r) == 0) & (np.diff(c) == 0)
            if dup.any():
                if not sum_duplicates:
                    raise ValueError("SparseCSR.from_coo: duplicate (row, col) entry")
                # segment-sum duplicates on host
                keep = np.concatenate([[True], ~dup])
                group = np.cumsum(keep) - 1
                v = np.bincount(group, weights=v.real).astype(v.real.dtype) if v.dtype.kind != "c" \
                    else (np.bincount(group, weights=v.real) + 1j * np.bincount(group, weights=v.imag)).astype(v.dtype)
                r, c = r[keep], c[keep]
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        indptr = np.cumsum(indptr)
        canonical_dtype(v.dtype)
        return SparseCSR(
            data=jnp.asarray(v),
            indices=jnp.asarray(c, dtype=jnp.int32),
            rows=jnp.asarray(r, dtype=jnp.int32),
            indptr=jnp.asarray(indptr, dtype=jnp.int32),
            shape=(n_rows, n_cols),
        )

    @staticmethod
    def from_scipy(mat, dtype=None) -> "SparseCSR":
        """Build from a scipy.sparse matrix (host-side convenience)."""
        m = mat.tocoo()
        return SparseCSR.from_coo(m.row, m.col, m.data.astype(dtype) if dtype else m.data,
                                  m.shape, dtype=dtype)

    @staticmethod
    def from_dense(a, dtype=None) -> "SparseCSR":
        arr = np.asarray(a, dtype=dtype)
        r, c = np.nonzero(arr)
        return SparseCSR.from_coo(r, c, arr[r, c], arr.shape, dtype=dtype)

    # --- queries ---
    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    # --- compute ---
    def matvec(self, x):
        return csr_matvec(self.rows, self.indices, self.data, x, self.shape[0])

    def rmatvec(self, x):
        # A^H x: swap roles of rows/cols on the conjugated data.
        contrib = jnp.conj(self.data) * jnp.take(x, self.rows, axis=0)
        return jax.ops.segment_sum(contrib, self.indices, num_segments=self.shape[1])

    def diagonal(self):
        k = min(self.shape)
        on_diag = (self.rows == self.indices) & (self.rows < k)
        contrib = jnp.where(on_diag, self.data, jnp.zeros((), self.data.dtype))
        idx = jnp.where(on_diag, self.rows, k)  # park off-diagonal at segment k
        return jax.ops.segment_sum(contrib, idx, num_segments=k + 1)[:k]

    def to_dense(self):
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        return out.at[self.rows, self.indices].add(self.data)

    # --- conversions ---
    def to_ell(self, pad_to: int | None = None) -> "SparseELL":
        """Convert to padded ELL layout (host round-trip for packing)."""
        indptr = np.asarray(self.indptr)
        counts = np.diff(indptr)
        width = int(counts.max()) if counts.size else 0
        if pad_to is not None:
            width = max(width, pad_to)
        n_rows, n_cols = self.shape
        idx = np.zeros((n_rows, width), dtype=np.int32)
        val = np.zeros((n_rows, width), dtype=self.dtype)
        data = np.asarray(self.data)
        cols = np.asarray(self.indices)
        rows = np.asarray(self.rows)
        # vectorised packing: position of each nnz within its row
        slot = np.arange(len(rows)) - indptr[rows]
        idx[rows, slot] = cols
        val[rows, slot] = data
        return SparseELL(data=jnp.asarray(val), indices=jnp.asarray(idx),
                         shape=self.shape)

    def to_gell(self, tile_rows: int | None = None):
        """Convert to the packed gather-ELL format (``matrix/gell.py``)."""
        from .gell import SparseGELL
        return SparseGELL.from_csr(self, tile_rows=tile_rows)

    # --- checked access ---
    def as_csr(self):
        return self


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseELL(AbstractMatrix):
    """Padded fixed-row-width sparse layout (see module docstring)."""

    data: jax.Array     # (n_rows, width)
    indices: jax.Array  # (n_rows, width) int32; padding entries point at col 0 with value 0
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def nnz(self) -> int:
        # padded layout: count structural (value-carrying) entries on host
        return int(np.count_nonzero(np.asarray(self.data)))

    def matvec(self, x):
        return ell_matvec(self.indices, self.data, x)

    def diagonal(self):
        n = min(self.shape)
        row_ids = jnp.arange(self.data.shape[0])[:, None]
        on_diag = self.indices == row_ids
        d = jnp.sum(jnp.where(on_diag, self.data, 0), axis=1)
        return d[:n]

    def to_dense(self):
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        row_ids = jnp.broadcast_to(jnp.arange(self.shape[0])[:, None], self.indices.shape)
        return out.at[row_ids, self.indices].add(self.data)

    def as_csr(self):
        raise TypeError("SparseELL: stored matrix is not sparse CSR (convert explicitly)")
