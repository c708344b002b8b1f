"""Row-partitioned DIA (banded) operator — the bandwidth-optimal
distributed SpMV.

For banded operators the general ELL partition (parallel/sharded.py) pays
for a gather per nnz; the DIA layout keeps the distributed SpMV fully
gather-free: each shard holds its column-slice of the diagonal planes
``(k, rows_per_shard)``, exchanges only ``bandwidth`` halo entries of x
with each neighbor (``ppermute``), and multiplies shifted window
slices — unit-stride reads end to end. The two halo permutes are
independent of the local-band compute, so XLA overlaps them.

Zero padding rows keep the spectrum clean exactly as in PartitionedELL
(pads never excited when the iterate starts zero there).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.dia import SparseDIA
from ..ops.dia import (DEFAULT_IL_TILE, LANES, dia_matvec_il_window, il_rows,
                       il_window_halo)
from ..solvers.power import power_iteration_loop
from ..utils.prng import default_key, random_unit_vector
from .mesh import ROW_AXIS
from .sharded import psum_norm, psum_vdot


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedDIA:
    """Banded operator with diagonal planes column-sharded over the mesh."""

    data: jax.Array  # (k, n_padded) sharded P(None, rows)
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    n_orig: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_padded(self) -> int:
        return self.data.shape[1]

    @property
    def rows_per_shard(self) -> int:
        return self.n_padded // self.n_shards

    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.data)))


def partition_dia(m: SparseDIA, mesh: Mesh, *, axis: str = ROW_AXIS) -> PartitionedDIA:
    """Pad + place a banded operator over a 1-D mesh."""
    n = m.shape[0]
    n_shards = mesh.shape[axis]
    rows_per_shard = -(-n // n_shards)
    n_padded = rows_per_shard * n_shards
    bw = m.bandwidth
    if bw > rows_per_shard:
        raise ValueError(
            f"partition_dia: bandwidth ({bw}) exceeds rows per shard "
            f"({rows_per_shard}); use the ELL partition with all_gather instead")
    data = np.zeros((m.data.shape[0], n_padded), dtype=m.dtype)
    data[:, :n] = np.asarray(m.data)
    sharding = NamedSharding(mesh, P(None, axis))
    return PartitionedDIA(
        data=jax.device_put(jnp.asarray(data), sharding),
        offsets=m.offsets, n_orig=n, n_shards=n_shards, halo=max(bw, 1))


def dia_window_matvec(vals_local, offsets, x_window, halo):
    """Local banded matvec: y[i] = sum_d vals[d, i] * window[halo + i + off].

    ``x_window`` has ``halo`` neighbor entries on each side of the local
    block; offsets are static so every slice is static."""
    rps = vals_local.shape[1]
    y = jnp.zeros((rps,), vals_local.dtype)
    for d, off in enumerate(offsets):
        y = y + vals_local[d] * jax.lax.slice_in_dim(
            x_window, halo + off, halo + off + rps)
    return y


def dia_halo_window(x_local, halo, *, axis: str = ROW_AXIS):
    """Build [left-halo | x_local | right-halo] via two neighbor permutes."""
    p = jax.lax.axis_size(axis)
    perm_fwd = [(j, (j + 1) % p) for j in range(p)]   # j's tail -> j+1's left halo
    perm_bwd = [(j, (j - 1) % p) for j in range(p)]   # j's head -> j-1's right halo
    left = jax.lax.ppermute(x_local[-halo:], axis, perm_fwd)
    right = jax.lax.ppermute(x_local[:halo], axis, perm_bwd)
    return jnp.concatenate([left, x_local, right])


def distributed_dia_matvec(A: PartitionedDIA, x, mesh: Mesh, *,
                           axis: str = ROW_AXIS):
    """One distributed banded SpMV (jittable): sharded x -> sharded y."""

    def local(data, x_local):
        w = dia_halo_window(x_local, A.halo, axis=axis)
        return dia_window_matvec(data, A.offsets, w, A.halo)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=P(axis),
    )(A.data, x)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _distributed_dia_power(A: PartitionedDIA, x0: jax.Array,
                           max_iterations: jax.Array, tol: jax.Array,
                           mesh: Mesh, axis: str) -> EigenResult:
    def local_loop(data, x0_local):
        def matvec(x_local):
            w = dia_halo_window(x_local, A.halo, axis=axis)
            return dia_window_matvec(data, A.offsets, w, A.halo)

        return power_iteration_loop(
            matvec,
            lambda a, b: psum_vdot(a, b, axis=axis),
            lambda v: psum_norm(v, axis=axis),
            x0_local, max_iterations, tol)

    return jax.shard_map(
        local_loop, mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=EigenResult(eigenvalue=P(), eigenvector=P(axis),
                              iterations=P(), converged=P()),
    )(A.data, x0)


# --------------------------------------------------------------------------
# Interleaved distributed variant: each shard's diagonal block lives in the
# lane-major layout (ops/dia.py), the iterate stays interleaved ACROSS
# iterations, and the shard-boundary halo is exactly the seam-lane columns
# of the local window — two ppermutes of (pr, 1) arrays per matvec, zero
# layout conversions in the loop.
# --------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedILDIA:
    """Banded operator, row-partitioned, shards stored lane-major."""

    data_il: jax.Array  # (k, n_shards*R, 128) sharded P(None, rows, None)
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    n_orig: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    tile_s: int = dataclasses.field(metadata=dict(static=True))

    @property
    def R(self) -> int:
        """Interleaved rows per shard."""
        return self.data_il.shape[1] // self.n_shards

    @property
    def shard_capacity(self) -> int:
        return self.R * LANES

    @property
    def dtype(self):
        return np.dtype(self.data_il.dtype)


def partition_dia_il(m: SparseDIA, mesh: Mesh, *, axis: str = ROW_AXIS,
                     tile_s: int | None = None, dtype=None) -> PartitionedILDIA:
    """Pad + interleave + place a banded operator over a 1-D mesh."""
    ts = DEFAULT_IL_TILE if tile_s is None else tile_s
    n = m.shape[0]
    p = mesh.shape[axis]
    k = m.data.shape[0]
    R = il_rows(-(-n // p), ts)
    pr = il_window_halo(m.offsets)
    if pr > R:
        raise ValueError(
            f"partition_dia_il: halo ({pr}) exceeds rows per shard ({R})")
    cap = R * LANES
    dt = np.dtype(m.dtype) if dtype is None else np.dtype(dtype)
    data = np.zeros((k, p * cap), dt)
    data[:, :n] = np.asarray(m.data).astype(dt)
    # per-shard lane-major interleave
    data_il = data.reshape(k, p, LANES, R).transpose(0, 1, 3, 2).reshape(
        k, p * R, LANES)
    sharding = NamedSharding(mesh, P(None, axis, None))
    return PartitionedILDIA(data_il=jax.device_put(jnp.asarray(data_il), sharding),
                            offsets=m.offsets, n_orig=n, n_shards=p, tile_s=ts)


def encode_vec_il_sharded(x: np.ndarray, A: PartitionedILDIA,
                          mesh: Mesh, *, axis: str = ROW_AXIS) -> jax.Array:
    """Host (n,) vector -> sharded (p*R, 128) interleaved iterate."""
    p, R, cap = A.n_shards, A.R, A.shard_capacity
    xp = np.zeros(p * cap, x.dtype)
    xp[:A.n_orig] = x
    x_il = xp.reshape(p, LANES, R).transpose(0, 2, 1).reshape(p * R, LANES)
    return jax.device_put(jnp.asarray(x_il), NamedSharding(mesh, P(axis, None)))


def decode_vec_il_sharded(x_il, A: PartitionedILDIA) -> np.ndarray:
    """Sharded interleaved iterate -> host (n,) vector."""
    p, R = A.n_shards, A.R
    xh = np.asarray(jax.device_get(x_il)).reshape(p, R, LANES)
    return xh.transpose(0, 2, 1).reshape(-1)[:A.n_orig]


def dia_il_halo_window(x_il_local, pr, *, axis: str = ROW_AXIS):
    """Build the (R + 2*pr, 128) window: lane-shifted local halos plus the
    seam-lane columns exchanged with the neighbor shards (non-cyclic
    ppermute — edge shards read zeros, matching the matrix boundary)."""
    R = x_il_local.shape[0]
    top = jnp.pad(x_il_local[R - pr:, :-1], ((0, 0), (1, 0)))
    bot = jnp.pad(x_il_local[:pr, 1:], ((0, 0), (0, 1)))
    p = jax.lax.axis_size(axis)
    if p > 1:
        perm_fwd = [(j, j + 1) for j in range(p - 1)]
        perm_bwd = [(j + 1, j) for j in range(p - 1)]
        from_prev = jax.lax.ppermute(x_il_local[R - pr:, -1:], axis, perm_fwd)
        from_next = jax.lax.ppermute(x_il_local[:pr, :1], axis, perm_bwd)
        top = top.at[:, :1].set(from_prev)
        bot = bot.at[:, -1:].set(from_next)
    return jnp.concatenate([top, x_il_local, bot], axis=0)


def distributed_dia_il_matvec(A: PartitionedILDIA, x_il, mesh: Mesh, *,
                              axis: str = ROW_AXIS):
    """One distributed interleaved banded SpMV (jittable)."""
    pr = il_window_halo(A.offsets)

    def local(data_il, x_local):
        w = dia_il_halo_window(x_local, pr, axis=axis)
        return dia_matvec_il_window(data_il, A.offsets, w)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis, None), P(axis, None)),
        out_specs=P(axis, None),
    )(A.data_il, x_il)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _distributed_dia_il_power(A: PartitionedILDIA, x0_il: jax.Array,
                              max_iterations: jax.Array, tol: jax.Array,
                              mesh: Mesh, axis: str) -> EigenResult:
    pr = il_window_halo(A.offsets)

    def local_loop(data_il, x0_local):
        def matvec(x_local):
            w = dia_il_halo_window(x_local, pr, axis=axis)
            return dia_matvec_il_window(data_il, A.offsets, w)

        return power_iteration_loop(
            matvec,
            lambda a, b: psum_vdot(a, b, axis=axis),
            lambda v: psum_norm(v, axis=axis),
            x0_local, max_iterations, tol)

    return jax.shard_map(
        local_loop, mesh=mesh,
        in_specs=(P(None, axis, None), P(axis, None)),
        out_specs=EigenResult(eigenvalue=P(), eigenvector=P(axis, None),
                              iterations=P(), converged=P()),
    )(A.data_il, x0_il)


def distributed_dia_il_power_method(A: PartitionedILDIA, mesh: Mesh,
                                    opts: SolverOptions = SolverOptions(), *,
                                    axis: str = ROW_AXIS, key=None,
                                    x0=None) -> EigenResult:
    """Dominant eigenpair via the interleaved distributed fast path.

    The returned ``eigenvector`` is the sharded interleaved iterate;
    convert with ``decode_vec_il_sharded``."""
    vdt = np.dtype(jnp.promote_types(A.dtype, jnp.float32))
    if x0 is None:
        xh = np.asarray(random_unit_vector(key if key is not None else default_key(),
                                           A.n_orig, vdt))
    else:
        xh = np.asarray(x0, dtype=vdt)
        nrm = np.linalg.norm(xh)
        if nrm != 0:
            xh = xh / nrm
    x0_il = encode_vec_il_sharded(xh, A, mesh, axis=axis)
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return _distributed_dia_il_power(A, x0_il,
                                     jnp.asarray(opts.max_iterations, jnp.int32),
                                     jnp.asarray(opts.tolerance, ftype),
                                     mesh, axis)


def distributed_dia_power_method(A: PartitionedDIA, mesh: Mesh,
                                 opts: SolverOptions = SolverOptions(), *,
                                 axis: str = ROW_AXIS, key=None,
                                 x0=None) -> EigenResult:
    """Dominant eigenpair of a row-partitioned banded operator."""
    n, n_pad = A.n_orig, A.n_padded
    if x0 is None:
        xh = np.asarray(random_unit_vector(key if key is not None else default_key(),
                                           n, A.dtype))
    else:
        xh = np.asarray(x0, dtype=A.dtype)
        nrm = np.linalg.norm(xh)
        if nrm != 0:
            xh = xh / nrm
    xp = np.zeros(n_pad, dtype=A.dtype)
    xp[:n] = xh
    x0_sharded = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(axis)))
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return _distributed_dia_power(A, x0_sharded,
                                  jnp.asarray(opts.max_iterations, jnp.int32),
                                  jnp.asarray(opts.tolerance, ftype), mesh, axis)
