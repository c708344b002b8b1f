"""Row-partitioned sparse operators and the distributed SpMV.

This scales the reference's ``A * x`` hot op (power_method.hpp:69)
across devices (the reference has no parallelism
at all): the matrix rows are block-partitioned over a 1-D mesh in a padded
ELL layout, the iterate ``x`` is row-sharded, and each SpMV gathers the
needed ``x`` entries from the other shards.

Two exchange strategies (SURVEY.md §2 parallelism table):

- ``"all_gather"`` — general matrices: ``lax.all_gather(x, 'rows')``
  materialises the full vector per shard. O(n) comm, always correct.
- ``"halo"`` — banded matrices (column range of every local row block fits
  within the left/right neighbor blocks): only the two neighbor shards are
  exchanged via ``lax.ppermute``, O(2·n/p) comm — the domain's "context
  parallelism" halo exchange. Falls back automatically when the bandwidth
  check fails.

All functions are designed to run inside ``jax.shard_map`` over the mesh
from ``parallel.mesh`` and compose with ``lax.while_loop`` so whole solver
loops stay on device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..matrix.sparse import SparseCSR, SparseELL
from .mesh import ROW_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedELL:
    """A square operator row-partitioned over a 1-D mesh.

    ``data``/``indices`` are global (n_padded, width) arrays placed with a
    ``P(rows, None)`` sharding; ``n_orig`` rows are real, the rest are
    zero padding so every shard holds ``n_padded / n_shards`` rows. Padding
    rows are all-zero, so they contribute nothing to products or norms as
    long as the iterate's padding entries start at zero (they then stay 0).

    ``halo_ok`` records whether every row's column indices fall within the
    owning shard's block +/- one neighbor block, enabling the halo-exchange
    SpMV.
    """

    data: jax.Array     # (n_padded, width)
    indices: jax.Array  # (n_padded, width) int32
    n_orig: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    halo_ok: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def n_padded(self) -> int:
        return self.data.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.n_padded // self.n_shards

    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.data)))


def partition_ell(m: SparseCSR | SparseELL, mesh: Mesh, *,
                  axis: str = ROW_AXIS) -> PartitionedELL:
    """Pad + place a square sparse matrix row-partitioned over ``mesh``."""
    if isinstance(m, SparseCSR):
        ell = m.to_ell()
    else:
        ell = m
    n, n_cols = ell.shape
    if n != n_cols:
        raise ValueError("partition_ell: matrix must be square")
    n_shards = mesh.shape[axis]
    rows_per_shard = -(-n // n_shards)
    n_padded = rows_per_shard * n_shards

    data = np.zeros((n_padded, ell.data.shape[1]), dtype=ell.dtype)
    indices = np.zeros((n_padded, ell.data.shape[1]), dtype=np.int32)
    data[:n] = np.asarray(ell.data)
    indices[:n] = np.asarray(ell.indices)

    # halo feasibility: every structural entry's column within owner block
    # +/- one neighbor block
    row_block = np.arange(n_padded)[:, None] // rows_per_shard
    col_block = indices // rows_per_shard
    structural = data != 0
    diff = np.abs(row_block - col_block)
    diff = np.minimum(diff, n_shards - diff)  # cyclic distance: periodic bands OK
    halo_ok = bool(n_shards == 1 or not structural.any() or
                   (diff[structural].max() <= 1))

    sharding = NamedSharding(mesh, P(axis, None))
    return PartitionedELL(
        data=jax.device_put(jnp.asarray(data), sharding),
        indices=jax.device_put(jnp.asarray(indices), sharding),
        n_orig=n, n_shards=n_shards, halo_ok=halo_ok)


# --- local SpMV bodies (run inside shard_map; x arguments are per-shard) ---

def spmv_all_gather(data_local, indices_local, x_local, *, axis: str = ROW_AXIS):
    """y_local = A_local @ all_gather(x). General-purpose exchange."""
    x_full = jax.lax.all_gather(x_local, axis, tiled=True)
    return jnp.sum(data_local * jnp.take(x_full, indices_local, axis=0), axis=1)

def spmv_halo(data_local, indices_local, x_local, *, axis: str = ROW_AXIS):
    """y_local using only left/right neighbor x blocks via ppermute.

    Valid when ``halo_ok``: column indices of shard i fall in blocks
    i-1, i, i+1. The two permutes are independent, so XLA can overlap them
    with the local-block compute.
    """
    p = jax.lax.axis_size(axis)
    i = jax.lax.axis_index(axis)
    rps = x_local.shape[0]
    # neighbor exchange (cyclic; out-of-range contributions are masked away
    # because no structural entry points there)
    right_of_left = jax.lax.ppermute(x_local, axis,
                                     [(j, (j + 1) % p) for j in range(p)])
    left_of_right = jax.lax.ppermute(x_local, axis,
                                     [(j, (j - 1) % p) for j in range(p)])
    # window = [x_{i-1} | x_i | x_{i+1}] of length 3*rps; local columns
    # rebased to window coordinates
    window = jnp.concatenate([right_of_left, x_local, left_of_right])
    base = (i - 1) * rps
    local_idx = indices_local - base
    # cyclic wrap: shard 0's left neighbor is p-1 whose global indices are
    # high; map them into window slot 0. Same for the last shard's right.
    local_idx = jnp.where(local_idx < 0, local_idx + p * rps, local_idx)
    local_idx = jnp.where(local_idx >= 3 * rps, local_idx - p * rps, local_idx)
    # padding entries (data==0) may still carry index 0; clamp for safety
    local_idx = jnp.clip(local_idx, 0, 3 * rps - 1)
    return jnp.sum(data_local * jnp.take(window, local_idx, axis=0), axis=1)


def psum_norm(v_local, *, axis: str = ROW_AXIS):
    """Global 2-norm of a row-sharded vector."""
    local = jnp.sum(jnp.abs(v_local) ** 2)
    return jnp.sqrt(jax.lax.psum(local, axis))


def psum_vdot(a_local, b_local, *, axis: str = ROW_AXIS):
    """Global conjugating dot product of row-sharded vectors."""
    return jax.lax.psum(jnp.vdot(a_local, b_local), axis)


def distributed_matvec(A: PartitionedELL, x, mesh: Mesh, *,
                       axis: str = ROW_AXIS, exchange: str = "auto"):
    """One distributed SpMV: global sharded x -> global sharded y (jittable)."""
    if exchange == "auto":
        exchange = "halo" if A.halo_ok else "all_gather"
    elif exchange == "halo" and not A.halo_ok:
        # fail loudly: the halo window only covers blocks i-1, i, i+1 — a
        # wider operator through this path would silently clamp its columns
        # into the window and return wrong values
        raise ValueError(
            "distributed_matvec: exchange='halo' requested but the operator's "
            "column span exceeds the +/-1-block halo window (halo_ok=False); "
            "use exchange='all_gather'")
    body = spmv_halo if exchange == "halo" else spmv_all_gather

    def local(data, indices, x_local):
        return body(data, indices, x_local, axis=axis)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )(A.data, A.indices, x)
