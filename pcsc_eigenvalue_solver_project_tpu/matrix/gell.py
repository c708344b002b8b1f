"""``SparseGELL`` — the packed gather-ELL format for unstructured sparse.

An operator type for the reference's sparse ``A * x``
(reference src/power_method/power_method.hpp:69, sparse arm of
src/matrix/matrix.hpp:39-44). ``SparseCSR`` stays the authoritative
ingest/storage format (exact reader parity); converting with
``SparseCSR.to_gell()`` re-packs the nonzeros into the tile layout of
``ops/gell.py``.

The packing is a host-side, one-time cost (like the reference's
``makeCompressed()``, file_matrix_reader.hpp:130); the resulting type is a
pytree and its ``matvec`` is jit/while_loop-friendly, so the whole power
iteration stays on device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dtypes import canonical_dtype
from ..ops.gell import GELLPack, gell_matvec, pack_gell
from .protocol import AbstractMatrix


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseGELL(AbstractMatrix):
    """Packed gather-ELL sparse matrix (see module docstring).

    ``diag`` is precomputed at pack time (host) so Jacobi-preconditioned
    inner solves don't need a scatter pass over the packed layout.
    """

    pack: GELLPack
    diag: jax.Array
    nnz: int = dataclasses.field(metadata=dict(static=True))

    # --- constructors ---
    @staticmethod
    def from_coo(row, col, values, shape, dtype=None,
                 tile_rows: int | None = None) -> "SparseGELL":
        n_rows, n_cols = map(int, shape)
        r = np.asarray(row, np.int64)
        c = np.asarray(col, np.int64)
        v = np.asarray(values, dtype=canonical_dtype(dtype) if dtype else None)
        canonical_dtype(v.dtype)
        if not (r.shape == c.shape == v.shape) or r.ndim != 1:
            raise ValueError("SparseGELL.from_coo: row/col/values must be 1-D of equal length")
        if r.size and (r.min() < 0 or r.max() >= n_rows or c.min() < 0 or c.max() >= n_cols):
            raise ValueError("Sparse indices out of range")
        pack = pack_gell(r, c, v, (n_rows, n_cols), tile_rows=tile_rows)
        k = min(n_rows, n_cols)
        d = np.zeros(k, v.dtype)
        on = r == c
        np.add.at(d, r[on & (r < k)], v[on & (r < k)])
        return SparseGELL(pack=pack, diag=jnp.asarray(d), nnz=int(r.size))

    @staticmethod
    def from_csr(csr, tile_rows: int | None = None) -> "SparseGELL":
        return SparseGELL.from_coo(np.asarray(csr.rows), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape,
                                   tile_rows=tile_rows)

    # --- queries ---
    @property
    def shape(self) -> tuple:
        return self.pack.shape

    @property
    def dtype(self):
        return self.pack.dtype

    @property
    def is_dense(self) -> bool:
        return False

    # --- compute ---
    def matvec(self, x):
        return gell_matvec(self.pack, x)

    def diagonal(self):
        return self.diag
