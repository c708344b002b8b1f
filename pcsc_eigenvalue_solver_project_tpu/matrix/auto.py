"""Automatic sparse-layout selection.

The reference dispatches dense/sparse at runtime
(reference src/power_method/power_method.hpp:141-147); here the
dispatch that matters is BETWEEN SPARSE LAYOUTS: a banded pattern runs as
interleaved DIA (fused slices, no index traffic), anything else as packed
gather-ELL. Which layout wins at which fill has not been measured on the
GPU yet (PERF.md, open questions).

``from_coo(..., layout="auto")`` inspects the COO pattern and picks the
fastest layout the structure admits; ``suggest_layout`` exposes the
decision rule (with its statistics) without building anything.  A
bandwidth-reducing reverse-Cuthill-McKee probe (scipy) converts
reducible "uniform-looking" inputs into the banded/local fast regimes:
a symmetric permutation P A P^T preserves the spectrum, so solvers run
entirely in the permuted domain and only the eigenVECTOR needs the
inverse permutation — which the operator's ``encode_vec``/``decode_vec``
codec hooks (matrix/protocol.py) apply exactly once per solve.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from .dia import SparseDIA
from .gell import SparseGELL
from .protocol import AbstractMatrix

# A diagonal layout stores n_offsets * n values; it wins when few enough
# diagonals cover the nnz (storage fill keeps the 9x kernel advantage
# over GELL ahead of the wasted zero reads).  128 offsets at fill 0.25
# reads 4 B/nnz of zeros vs GELL's ~11.6 B/nnz of index metadata.
MAX_DIAGS = 128
MIN_DIA_FILL = 0.20
# column-footprint probe: x in 16384-value chunks, per 128-row tile
_CHUNK = 16384
_TILE_ROWS = 128


@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """Outcome of ``suggest_layout``: the chosen ``kind`` ("dia_il" or
    "gell"), an optional symmetric RCM permutation (new-to-old row
    order), and the pattern statistics the rule used."""
    kind: str
    perm: np.ndarray | None
    stats: dict


def _dia_stats(r, c, n):
    offs = np.unique(c.astype(np.int64) - r.astype(np.int64))
    fill = len(r) / (max(len(offs), 1) * n)
    return len(offs), fill


def _chunk_footprint(r, c, n):
    """Mean distinct x-chunks touched per 128-row tile (the GELL
    kernel's per-tile gather-pass count)."""
    tiles = r // _TILE_ROWS
    chunks = c // _CHUNK
    keys = np.unique(tiles.astype(np.int64) * (n // _CHUNK + 2) + chunks)
    n_tiles = max(int(tiles.max()) + 1 if len(tiles) else 1, 1)
    return len(keys) / n_tiles


def _rcm_perm(r, c, n):
    """Reverse-Cuthill-McKee order of the symmetrised pattern."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ones = np.ones(len(r), np.int8)
    a = sp.coo_matrix((ones, (r, c)), shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a + a.T, symmetric_mode=True))


def suggest_layout(row, col, values, shape, *,
                   try_rcm: bool = True) -> LayoutDecision:
    """Pick the fastest layout for a COO pattern (see module docstring).

    Rule: (1) few distinct diagonals with adequate fill -> interleaved
    DIA; (2) else RCM-permute and re-test -> DIA with permutation;
    (3) else GELL, permuted when RCM meaningfully shrinks the per-tile
    column-chunk footprint (the pruned-gather fast regime), unpermuted
    otherwise."""
    n = int(shape[0])
    r = np.asarray(row, np.int64)
    c = np.asarray(col, np.int64)
    stats: dict = {"n": n, "nnz": int(len(r))}

    n_offs, fill = _dia_stats(r, c, n)
    stats["n_diagonals"] = int(n_offs)
    stats["dia_fill"] = float(fill)
    if n_offs <= MAX_DIAGS and fill >= MIN_DIA_FILL:
        return LayoutDecision("dia_il", None, stats)

    if not try_rcm or n < 2 * _TILE_ROWS:
        return LayoutDecision("gell", None, stats)

    perm = _rcm_perm(r, c, n)
    pos = np.empty(n, np.int64)
    pos[perm] = np.arange(n)
    rp, cp = pos[r], pos[c]

    n_offs_p, fill_p = _dia_stats(rp, cp, n)
    stats["n_diagonals_rcm"] = int(n_offs_p)
    stats["dia_fill_rcm"] = float(fill_p)
    if n_offs_p <= MAX_DIAGS and fill_p >= MIN_DIA_FILL:
        return LayoutDecision("dia_il", perm, stats)

    foot = _chunk_footprint(r, c, n)
    foot_p = _chunk_footprint(rp, cp, n)
    stats["chunks_per_tile"] = float(foot)
    stats["chunks_per_tile_rcm"] = float(foot_p)
    # keep the permutation only for a footprint cut of >= 25% (the pack's
    # gather passes grow with the footprint); below that it only costs
    # pack time
    if foot_p < 0.75 * foot:
        return LayoutDecision("gell", perm, stats)
    return LayoutDecision("gell", None, stats)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PermutedOperator(AbstractMatrix):
    """Symmetrically permuted operator P A P^T with the permutation
    folded into the vector codec: solvers iterate entirely in the
    (fast, permuted) domain — the spectrum is invariant — and
    ``decode_vec`` restores original indexing on the final eigenvector
    (protocol contract, matrix/protocol.py)."""

    inner: AbstractMatrix
    perm: jax.Array        # new-to-old: permuted[i] = original[perm[i]]
    inv_perm: jax.Array

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def is_dense(self):
        return False

    def encode_vec(self, x):
        return self.inner.encode_vec(x[..., self.perm])

    def decode_vec(self, x):
        return self.inner.decode_vec(x)[..., self.inv_perm]

    def matvec(self, x):
        return self.inner.matvec(x)

    def rmatvec(self, x):
        # (P A P^T)^H = P A^H P^T: same codec, conjugate-transposed core
        return self.inner.rmatvec(x)

    def matmat(self, xs):
        return self.inner.matmat(xs)

    def diagonal(self):
        # original-domain, like every protocol vector at the API
        # boundary: solvers re-encode it (inverse_power.py:116 does
        # ``encode_vec(diagonal())``), which re-applies the permutation
        return self.inner.diagonal()[self.inv_perm]

    def to_dense(self):
        import jax.numpy as jnp
        d = self.inner.to_dense()
        return d[self.inv_perm][:, self.inv_perm]


def from_coo(row, col, values, shape, *, layout: str = "auto",
             dtype=None, tile_rows: int | None = None,
             try_rcm: bool = True):
    """Build the fastest operator for COO data.

    ``layout``: "auto" (decide from the pattern), "dia_il", "gell", or
    "csr" (the plain layout, SparseCSR.from_coo).  Returns an
    ``AbstractMatrix`` — possibly a ``PermutedOperator`` wrapping the
    fast layout of the RCM-permuted matrix."""
    import jax.numpy as jnp

    from .sparse import SparseCSR

    n_rows, n_cols = map(int, shape)
    if layout == "csr":
        return SparseCSR.from_coo(row, col, values, shape, dtype=dtype)
    if n_rows != n_cols and layout in ("auto", "dia_il"):
        if layout == "dia_il":
            raise ValueError("from_coo: DIA layout requires a square matrix")
        return SparseGELL.from_coo(row, col, values, shape, dtype=dtype,
                                   tile_rows=tile_rows)

    r = np.asarray(row, np.int64)
    c = np.asarray(col, np.int64)
    v = np.asarray(values)
    if layout == "auto":
        dec = suggest_layout(r, c, v, shape, try_rcm=try_rcm)
        kind, perm = dec.kind, dec.perm
    elif layout in ("dia_il", "gell"):
        kind, perm = layout, None
    else:
        raise ValueError(f"from_coo: unknown layout {layout!r}")

    if perm is not None:
        pos = np.empty(n_rows, np.int64)
        pos[perm] = np.arange(n_rows)
        r, c = pos[r], pos[c]

    if kind == "dia_il":
        csr = SparseCSR.from_coo(r, c, v, shape, dtype=dtype)
        m: AbstractMatrix = SparseDIA.from_csr(csr).interleaved()
    else:
        m = SparseGELL.from_coo(r, c, v, shape, dtype=dtype,
                                tile_rows=tile_rows)
    if perm is None:
        return m
    inv = np.empty(n_rows, np.int64)
    inv[perm] = np.arange(n_rows)
    return PermutedOperator(inner=m, perm=jnp.asarray(perm),
                            inv_perm=jnp.asarray(inv))
