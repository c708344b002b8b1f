"""DIA (diagonal) sparse format — the layout for banded operators.

The reference's Eigen CSC storage (matrix.hpp:39-44) makes SpMV a
gather-per-entry. For banded matrices — the realistic large-sparse regime
and the one the distributed halo exchange targets — storing the diagonals
densely turns SpMV into pure shifted multiply-accumulates: zero gathers,
unit-stride reads, one pass over the data (ops/dia.py).

Convention (row-indexed): ``data[d, i] = A[i, i + offsets[d]]`` with zeros
where the index leaves the matrix.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dtypes import canonical_dtype
from ..ops.dia import (DEFAULT_IL_TILE, deinterleave_vec, dia_matmat_il,
                       dia_matvec, dia_matvec_il, il_rows, interleave_dia_vals,
                       interleave_vec)
from .protocol import AbstractMatrix
from .sparse import SparseCSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseDIA(AbstractMatrix):
    """Banded matrix stored by diagonals. ``offsets`` is static."""

    data: jax.Array  # (k, n) — data[d, i] = A[i, i + offsets[d]]
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_csr(m: SparseCSR) -> "SparseDIA":
        """Host-side conversion; any (row, col) populates its diagonal."""
        n, nc = m.shape
        if n != nc:
            raise ValueError("SparseDIA.from_csr: matrix must be square")
        rows = np.asarray(m.rows)
        cols = np.asarray(m.indices)
        vals = np.asarray(m.data)
        diffs = cols.astype(np.int64) - rows.astype(np.int64)
        offs = np.unique(diffs)
        data = np.zeros((len(offs), n), dtype=m.dtype)
        d_ids = np.searchsorted(offs, diffs)
        data[d_ids, rows] = vals
        return SparseDIA(data=jnp.asarray(data),
                         offsets=tuple(int(o) for o in offs), shape=(n, n))

    @staticmethod
    def from_diagonals(diagonals, offsets, n, dtype=None) -> "SparseDIA":
        """Build from per-diagonal arrays (row-indexed, length n each)."""
        if dtype is not None:
            dtype = canonical_dtype(dtype)
        data = np.zeros((len(offsets), n), dtype=dtype)
        for d, diag in enumerate(diagonals):
            data[d] = np.asarray(diag, dtype=dtype)
            off = offsets[d]
            if off > 0:
                data[d, n - off:] = 0
            elif off < 0:
                data[d, :-off] = 0
        return SparseDIA(data=jnp.asarray(data), offsets=tuple(int(o) for o in offsets),
                         shape=(n, n))

    # --- queries ---
    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.data)))

    # --- compute ---
    def matvec(self, x):
        return dia_matvec(self.data, self.offsets, x)

    def rmatvec(self, x):
        # A^H: diagonal at offset o becomes offset -o, shifted by o
        n = self.shape[0]
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            c = jnp.conj(self.data[d]) * x
            if off >= 0:
                seg = jnp.pad(c[: n - off], (off, 0)) if off else c
            else:
                seg = jnp.pad(c[-off:], (0, -off))
            y = y + seg
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros((self.shape[0],), self.dtype)

    def to_dense(self):
        n = self.shape[0]
        out = jnp.zeros((n, n), self.dtype)
        i = jnp.arange(n)
        for d, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < n)
            out = out.at[i, jnp.clip(i + off, 0, n - 1)].add(
                jnp.where(valid, self.data[d], 0))
        return out

    def as_csr(self):
        raise TypeError("SparseDIA: stored matrix is not sparse CSR (convert explicitly)")

    def adjoint(self) -> "SparseDIA":
        """A^H as a SparseDIA (one-time transform): the diagonal at offset
        ``o`` becomes offset ``-o`` with conjugated values shifted by ``o``
        — build once for repeated ``rmatvec``-heavy algorithms instead of
        paying the shifted-pad path per call."""
        n = self.shape[0]
        new_offsets = tuple(sorted(-o for o in self.offsets))
        rows = []
        for no in new_offsets:
            src = self.data[self.offsets.index(-no)]
            c = jnp.conj(src)
            # adj[no][i] = conj(data[-no][i + no]), zero out of range
            if no >= 0:
                rows.append(jnp.pad(c[no:], (0, no)) if no else c)
            else:
                rows.append(jnp.pad(c[:no], (-no, 0)))
        return SparseDIA(data=jnp.stack(rows), offsets=new_offsets,
                         shape=self.shape)

    def spectral_bound(self):
        """Gershgorin bound on the spectral radius: max_i sum_j |A[i, j]|
        (the induced inf-norm) — deterministic, one pass over diagonals."""
        return jnp.max(jnp.sum(jnp.abs(self.data), axis=0))

    def gershgorin_interval(self):
        """(lo, hi) enclosing the spectrum of a SYMMETRIC operator:
        ``lo = min_i (a_ii - r_i)``, ``hi = max_i (a_ii + r_i)`` with
        ``r_i`` the off-diagonal absolute row sum. Used to seed Chebyshev
        filter intervals."""
        diag = jnp.real(self.diagonal())
        r = jnp.sum(jnp.abs(self.data), axis=0) - jnp.abs(self.diagonal())
        return jnp.min(diag - r), jnp.max(diag + r)

    def interleaved(self, tile_s: int | None = None,
                    dtype=None) -> "InterleavedDIA":
        """Convert to the lane-major interleaved layout (ops/dia.py); R is
        rounded up to a multiple of ``tile_s``. ``dtype`` optionally
        re-types the stored diagonals (bfloat16 halves the bytes read;
        accumulation stays f32)."""
        ts = DEFAULT_IL_TILE if tile_s is None else tile_s
        n = self.shape[0]
        data = self.data if dtype is None else self.data.astype(dtype)
        R = il_rows(n, ts)
        return InterleavedDIA(data_il=interleave_dia_vals(data, R),
                              offsets=self.offsets, shape=self.shape,
                              tile_s=ts)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InterleavedDIA(AbstractMatrix):
    """Banded matrix in the lane-major interleaved layout.

    ``matvec``/``matmat`` consume and produce vectors in the SAME layout
    ((R, 128) arrays via ``encode_vec``), so whole solver loops run without
    any layout conversion; norms and inner products are permutation-
    invariant, so the generic solver loops (solvers/power.py) work
    unchanged. Padding positions carry zero diagonal values and therefore
    stay zero through iterations.
    """

    data_il: jax.Array  # (k, R, 128)
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    tile_s: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return np.dtype(self.data_il.dtype)

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def R(self) -> int:
        return self.data_il.shape[1]

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    # --- layout codec (protocol hooks used by the solver drivers) ---
    def encode_vec(self, x):
        return interleave_vec(x, self.R)

    def decode_vec(self, x_il):
        return deinterleave_vec(x_il, self.shape[0])

    # --- compute (interleaved domain) ---
    def matvec(self, x_il):
        return dia_matvec_il(self.data_il, self.offsets, x_il)

    def matmat(self, xs_il):
        return dia_matmat_il(self.data_il, self.offsets, xs_il)

    def rmatvec(self, x_il):
        # correctness path: transpose via the natural layout (A^H shifts
        # diagonals the other way); adjoint-heavy algorithms should
        # pre-build ``self.adjoint()`` and call its ``matvec`` instead.
        return self.encode_vec(self.to_natural().rmatvec(self.decode_vec(x_il)))

    def adjoint(self) -> "InterleavedDIA":
        """A^H in the interleaved layout (one-time transform)."""
        return self.to_natural().adjoint().interleaved(self.tile_s)

    def spectral_bound(self):
        """Gershgorin bound on the spectral radius (inf-norm)."""
        return jnp.max(jnp.sum(jnp.abs(self.data_il), axis=0))

    def gershgorin_interval(self):
        """(lo, hi) spectrum enclosure for symmetric operators (cf.
        SparseDIA.gershgorin_interval); padding rows are all-zero and
        contribute the point 0, which is inside any symmetric operator's
        Gershgorin union anyway only if 0 is enclosed — mask them out."""
        return self.to_natural().gershgorin_interval()

    def to_natural(self) -> SparseDIA:
        k = self.data_il.shape[0]
        n = self.shape[0]
        data = self.data_il.transpose(0, 2, 1).reshape(k, -1)[:, :n]
        return SparseDIA(data=data, offsets=self.offsets, shape=self.shape)

    def diagonal(self):
        return self.to_natural().diagonal()

    def to_dense(self):
        return self.to_natural().to_dense()

    def as_csr(self):
        raise TypeError(
            "InterleavedDIA: stored matrix is not sparse CSR (convert explicitly)")
