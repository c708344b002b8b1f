"""Row-partitioned packed gather-ELL — distributed general-sparse SpMV.

The distributed counterpart of ``matrix/gell.py``: the reference's
sparse ``A * x`` hot op (reference src/power_method/
power_method.hpp:69) for *unstructured* matrices, where no halo window
exists. Each shard owns a contiguous block of rows packed independently
into the gather-ELL tile layout (all shards share the same static tile
geometry); the iterate is all-gathered and each shard evaluates its local
pack (ops/gell.py).

Layouts: the per-shard packs are stacked so the shard axis folds into the
tile axis — ``seg/val``: (n_shards * tiles_per_shard, 128, 128) placed
``P(rows, None, None)``; inside ``shard_map`` each block IS the local
pack. Spill tails are padded to the max shard spill count (padding rows
carry value 0 and scatter harmlessly into row 0).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..matrix.sparse import SparseCSR
from ..ops.gell import GELLPack, auto_tile_rows, gell_matvec, pack_gell
from .mesh import ROW_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedGELL:
    """A square operator row-partitioned over a 1-D mesh in GELL packs."""

    seg_packed: jax.Array   # (n_shards * tiles_per_shard, 128, 128) int16|int32
    val: jax.Array          # same shape, scalar dtype
    inv: jax.Array          # (n_shards * tiles_per_shard, ng*128, 128) int8
    sp_rows: jax.Array      # (n_shards, max_spill) int32, shard-local row ids
    sp_cols: jax.Array      # (n_shards, max_spill) int32, global column ids
    sp_vals: jax.Array      # (n_shards, max_spill)
    n_orig: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    tile_rows: int = dataclasses.field(metadata=dict(static=True))
    scan_steps: int = dataclasses.field(default=3, metadata=dict(static=True))

    @property
    def rows_per_shard(self) -> int:
        return (self.seg_packed.shape[0] // self.n_shards) * self.tile_rows

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self):
        return np.dtype(self.val.dtype)


def partition_gell(m: SparseCSR, mesh: Mesh, *, axis: str = ROW_AXIS,
                   tile_rows: int | None = None) -> PartitionedGELL:
    """Pack + place a square sparse matrix row-partitioned over ``mesh``."""
    n, n_cols = m.shape
    if n != n_cols:
        raise ValueError("partition_gell: matrix must be square")
    n_shards = mesh.shape[axis]
    if tile_rows is None:
        tile_rows = auto_tile_rows(n, int(m.data.shape[0]))
    tiles_per_shard = -(-(-(-n // n_shards)) // tile_rows)
    rps = tiles_per_shard * tile_rows
    n_padded = rps * n_shards

    rows = np.asarray(m.rows, np.int64)
    cols = np.asarray(m.indices, np.int64)
    vals = np.asarray(m.data)
    if np.dtype(vals.dtype).kind == "c":
        raise ValueError("partition_gell: complex operators use the "
                         "split-complex partitions (parallel/split_complex.py)")
    shard_of = rows // rps

    segs, valss, invs, spills = [], [], [], []
    scan_steps = 0
    for s in range(n_shards):
        sel = shard_of == s
        p = pack_gell(rows[sel] - s * rps, cols[sel], vals[sel],
                      (rps, n), tile_rows=tile_rows)
        # max over shards: extra scan steps are gated by per-entry mask
        # bits, so the widest shard's depth is safe for all
        scan_steps = max(scan_steps, p.scan_steps)
        segs.append(np.asarray(p.seg_packed))
        valss.append(np.asarray(p.val))
        invs.append(np.asarray(p.inv))
        spills.append((np.asarray(p.sp_rows), np.asarray(p.sp_cols),
                       np.asarray(p.sp_vals)))

    max_spill = max((len(sp[0]) for sp in spills), default=0)
    sp_r = np.zeros((n_shards, max_spill), np.int32)
    sp_c = np.zeros((n_shards, max_spill), np.int32)
    sp_v = np.zeros((n_shards, max_spill), vals.dtype)
    for s, (r_, c_, v_) in enumerate(spills):
        sp_r[s, :len(r_)] = r_
        sp_c[s, :len(c_)] = c_
        sp_v[s, :len(v_)] = v_

    sh3 = NamedSharding(mesh, P(axis, None, None))
    sh2 = NamedSharding(mesh, P(axis, None))
    return PartitionedGELL(
        seg_packed=jax.device_put(jnp.asarray(np.concatenate(segs)), sh3),
        val=jax.device_put(jnp.asarray(np.concatenate(valss)), sh3),
        inv=jax.device_put(jnp.asarray(np.concatenate(invs)), sh3),
        sp_rows=jax.device_put(jnp.asarray(sp_r), sh2),
        sp_cols=jax.device_put(jnp.asarray(sp_c), sh2),
        sp_vals=jax.device_put(jnp.asarray(sp_v), sh2),
        n_orig=n, n_shards=n_shards, tile_rows=tile_rows,
        scan_steps=scan_steps)


def gell_local_matvec(seg, val, inv, sp_r, sp_c, sp_v, x_full, *,
                      rps: int, n_cols: int, tile_rows: int,
                      scan_steps: int = 3):
    """Local-block SpMV (runs inside shard_map; x_full is the gathered
    iterate). The local block IS a GELLPack over (rps, n_cols)."""
    pack = GELLPack(seg_packed=seg, val=val, inv=inv,
                    sp_rows=sp_r[0], sp_cols=sp_c[0], sp_vals=sp_v[0],
                    shape=(rps, n_cols), tile_rows=tile_rows,
                    scan_steps=scan_steps, is_complex=False)
    return gell_matvec(pack, x_full)


def distributed_gell_matvec(A: PartitionedGELL, x, mesh: Mesh, *,
                            axis: str = ROW_AXIS):
    """One distributed SpMV: global sharded x -> global sharded y (jittable).

    Exchange is all_gather — the correct choice for unstructured sparsity
    (any column may be referenced by any shard)."""
    rps, n = A.rows_per_shard, A.n_padded

    def local(seg, val, inv, sp_r, sp_c, sp_v, x_local):
        x_full = jax.lax.all_gather(x_local, axis, tiled=True)
        return gell_local_matvec(seg, val, inv, sp_r, sp_c, sp_v, x_full,
                                 rps=rps, n_cols=n, tile_rows=A.tile_rows,
                                 scan_steps=A.scan_steps)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None, None),
                  P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )(A.seg_packed, A.val, A.inv, A.sp_rows, A.sp_cols, A.sp_vals, x)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def _distributed_gell_power(A: PartitionedGELL, x0, max_iterations, tol,
                            mesh: Mesh, axis: str):
    from ..core.results import EigenResult
    from ..solvers.power import power_iteration_loop
    from .sharded import psum_norm, psum_vdot

    rps, n = A.rows_per_shard, A.n_padded

    def local_loop(seg, val, inv, sp_r, sp_c, sp_v, x0_local):
        def matvec(x_local):
            x_full = jax.lax.all_gather(x_local, axis, tiled=True)
            return gell_local_matvec(seg, val, inv, sp_r, sp_c, sp_v, x_full,
                                     rps=rps, n_cols=n, tile_rows=A.tile_rows,
                                     scan_steps=A.scan_steps)

        return power_iteration_loop(
            matvec,
            lambda a, b: psum_vdot(a, b, axis=axis),
            lambda v: psum_norm(v, axis=axis),
            x0_local, max_iterations, tol)

    from ..core.results import EigenResult as ER
    return jax.shard_map(
        local_loop, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None, None),
                  P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=ER(eigenvalue=P(), eigenvector=P(axis),
                     iterations=P(), converged=P()),
    )(A.seg_packed, A.val, A.inv, A.sp_rows, A.sp_cols, A.sp_vals, x0)


def distributed_gell_power_method(A: PartitionedGELL, mesh: Mesh, opts=None, *,
                                  axis: str = ROW_AXIS, key=None, x0=None):
    """Dominant eigenpair of a row-partitioned unstructured operator —
    same loop kernel as the single-chip solver (power_method.hpp:47-99
    semantics by construction)."""
    from ..core.options import SolverOptions
    from ..utils.prng import default_key, random_unit_vector
    if opts is None:
        opts = SolverOptions()
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
    return _distributed_gell_power(A, x0_sharded,
                                   jnp.asarray(opts.max_iterations, jnp.int32),
                                   jnp.asarray(opts.tolerance, ftype),
                                   mesh, axis)
