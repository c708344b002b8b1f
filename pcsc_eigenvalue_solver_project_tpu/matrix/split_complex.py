"""Split-plane complex banded operator.

A complex banded operator stored as re/im diagonal planes ``(2, k, n)``
whose vectors are ``(2, n)`` real arrays. SpMV is the plane arithmetic of
ops/dia.py, and ``solvers.power.power_method_split_complex`` runs the
reference power iteration entirely in planes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dia import (DEFAULT_IL_TILE, deinterleave_vec, dia_matvec_il_planes,
                       dia_matvec_planes, il_rows, interleave_dia_vals,
                       interleave_vec)
from .dia import SparseDIA


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SplitComplexDIA:
    """Complex banded matrix as real diagonal planes (2, k, n)."""

    planes: jax.Array  # (2, k, n) real
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_complex_dia(m: SparseDIA, *, precision=np.float32) -> "SplitComplexDIA":
        data = np.asarray(m.data)
        planes = np.stack([data.real, data.imag]).astype(precision)
        return SplitComplexDIA(planes=jnp.asarray(planes), offsets=m.offsets,
                               shape=m.shape)

    @staticmethod
    def from_csr(m, *, precision=np.float32) -> "SplitComplexDIA":
        return SplitComplexDIA.from_complex_dia(SparseDIA.from_csr(m),
                                                precision=precision)

    @property
    def dtype(self):
        return np.dtype(self.planes.dtype)

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def nnz(self) -> int:
        p = np.asarray(self.planes)
        return int(np.count_nonzero((p[0] != 0) | (p[1] != 0)))

    def matvec(self, x_planes):
        """(2, n) real planes -> (2, n) real planes."""
        return dia_matvec_planes(self.planes, self.offsets, x_planes)

    def diagonal_planes(self):
        """Main diagonal as (2, n) planes (zeros if the offset is absent)."""
        if 0 in self.offsets:
            return self.planes[:, self.offsets.index(0), :]
        n = self.shape[0]
        return jnp.zeros((2, n), self.planes.dtype)

    def to_dense_planes(self):
        """Traced dense materialisation as (2, n, n) re/im planes."""
        n = self.shape[0]
        out = jnp.zeros((2, n, n), self.planes.dtype)
        i = jnp.arange(n)
        for d, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < n)
            col = jnp.clip(i + off, 0, n - 1)
            out = out.at[:, i, col].add(
                jnp.where(valid[None], self.planes[:, d], 0))
        return out

    # identity codec (protocol symmetry with the interleaved variant)
    def encode_vec(self, x_planes):
        return x_planes

    def decode_vec(self, x_planes):
        return x_planes

    def interleaved(self, tile_s: int | None = None) -> "InterleavedSplitComplexDIA":
        """Lane-major layout, as SparseDIA.interleaved()."""
        ts = DEFAULT_IL_TILE if tile_s is None else tile_s
        R = il_rows(self.shape[0], ts)
        planes_il = jax.vmap(lambda p: interleave_dia_vals(p, R))(self.planes)
        return InterleavedSplitComplexDIA(planes_il=planes_il,
                                          offsets=self.offsets,
                                          shape=self.shape, tile_s=ts)

    def to_complex_dense(self) -> np.ndarray:
        """Host-side dense complex materialisation (tests/oracles)."""
        p = np.asarray(self.planes)
        n = self.shape[0]
        out = np.zeros((n, n), np.complex128)
        i = np.arange(n)
        for d, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < n)
            out[i[valid], i[valid] + off] = p[0, d, valid] + 1j * p[1, d, valid]
        return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InterleavedSplitComplexDIA:
    """Split-plane complex banded matrix in the lane-major interleaved
    layout: planes (2, k, R, 128); vectors are (2, R, 128) plane arrays.
    The split-complex power loop (solvers/power.py) iterates entirely in
    this domain — its reductions are permutation-invariant."""

    planes_il: jax.Array  # (2, k, R, 128) real
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    tile_s: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return np.dtype(self.planes_il.dtype)

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def R(self) -> int:
        return self.planes_il.shape[2]

    def encode_vec(self, x_planes):
        """(2, n) plane vector -> (2, R, 128)."""
        return jax.vmap(lambda v: interleave_vec(v, self.R))(x_planes)

    def decode_vec(self, x_il_planes):
        return jax.vmap(lambda v: deinterleave_vec(v, self.shape[0]))(x_il_planes)

    def matvec(self, x_il_planes):
        return dia_matvec_il_planes(self.planes_il, self.offsets, x_il_planes)

    def to_natural(self) -> SplitComplexDIA:
        _, k, R, L = self.planes_il.shape
        n = self.shape[0]
        planes = self.planes_il.transpose(0, 1, 3, 2).reshape(2, k, R * L)[:, :, :n]
        return SplitComplexDIA(planes=planes, offsets=self.offsets,
                               shape=self.shape)

    def diagonal_planes(self):
        """Main diagonal as NATURAL (2, n) planes (encode for the solver
        domain with ``encode_vec``)."""
        if 0 in self.offsets:
            d = self.offsets.index(0)
            return self.decode_vec(self.planes_il[:, d])
        return jnp.zeros((2, self.shape[0]), self.planes_il.dtype)

    def to_complex_dense(self) -> np.ndarray:
        return self.to_natural().to_complex_dense()
