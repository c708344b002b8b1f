"""Segment-pruned distributed general-sparse SpMV with overlapped exchange.

SURVEY §2 maps the reference's sparse ``A * x``
(/root/reference/src/power_method/power_method.hpp:69) to "remote column
segments of x fetched via all_gather/collective_permute, overlapped with
local-block compute". ``parallel/gell.py`` implements the all_gather
fallback (O(n) bytes/step/device, correct for dense column coverage); THIS
module is the design the survey asks for:

- At partition time each shard records the set of 128-wide column
  **segments** its nonzeros actually touch outside its own row block (its
  *column footprint*). Comm scales with the footprint, not with n.
- The footprint is split by owning shard and exchanged with one
  ``lax.ppermute`` per mesh distance (only distances some shard actually
  needs — a banded-plus-long-range matrix on 8 shards typically uses 2 of
  7). Receivers scatter the segments into a compact footprint-ordered
  buffer consumed by the remote-column GELL pack.
- The local rows x local columns block is packed SEPARATELY and computes
  from the shard's own ``x`` slice with no communication dependency, so
  XLA's scheduler overlaps the permutes with the local-block SpMV (the
  survey's "overlapped with local-block compute").

Degenerate cases stay correct: a matrix whose every shard references every
segment simply exchanges everything (= all_gather volume); a block-diagonal
matrix exchanges nothing.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..matrix.sparse import SparseCSR
from ..ops.gell import LANES, auto_tile_rows, pack_gell
from .gell import gell_local_matvec
from .mesh import ROW_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PrunedGELL:
    """Row-partitioned operator: own-block pack + footprint remote pack +
    a static segment-exchange plan. All arrays are stacked over shards on
    axis 0 and placed ``P(rows, ...)``."""

    # own-block pack (columns owned by the shard; no comm dependency)
    own_seg: jax.Array      # (S*tiles, 128, 128) int16|int32
    own_val: jax.Array
    own_inv: jax.Array      # int8
    own_sp: tuple           # (sp_rows, sp_cols, sp_vals) each (S, max_spill)
    # remote pack (footprint-relabeled columns)
    rem_seg: jax.Array
    rem_val: jax.Array
    rem_inv: jax.Array
    rem_sp: tuple
    # exchange plan: one (send_idx, recv_pos) pair per active distance,
    # each (S, M_d) int32. send_idx = owner-local segment rows to extract;
    # recv_pos = rows of the compact footprint buffer to fill (padding
    # entries point at the dump row max_fp).
    plan: tuple
    n_orig: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    tile_rows: int = dataclasses.field(metadata=dict(static=True))
    scan_steps: int = dataclasses.field(default=3, metadata=dict(static=True))
    max_fp: int = dataclasses.field(default=0, metadata=dict(static=True))
    distances: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    has_remote: bool = dataclasses.field(default=True, metadata=dict(static=True))

    @property
    def rows_per_shard(self) -> int:
        return (self.own_seg.shape[0] // self.n_shards) * self.tile_rows

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self):
        return np.dtype(self.own_val.dtype)

    @property
    def comm_bytes_per_matvec(self) -> int:
        """Exact per-device collective-permute payload per SpMV (static):
        sum over active distances of M_d segment rows of 128 scalars."""
        item = self.dtype.itemsize
        return sum(int(p[0].shape[1]) * LANES * item for p in self.plan)


def _stack_packs(packs, mesh, axis):
    """Stack per-shard GELLPacks (same static geometry) into sharded
    arrays + padded spill triple; returns (seg, val, inv, sp, scan_steps)."""
    sh3 = NamedSharding(mesh, P(axis, None, None))
    sh2 = NamedSharding(mesh, P(axis, None))
    seg = np.concatenate([np.asarray(p.seg_packed) for p in packs])
    val = np.concatenate([np.asarray(p.val) for p in packs])
    inv = np.concatenate([np.asarray(p.inv) for p in packs])
    max_spill = max((p.n_spill for p in packs), default=0)
    S = len(packs)
    sp_r = np.zeros((S, max_spill), np.int32)
    sp_c = np.zeros((S, max_spill), np.int32)
    sp_v = np.zeros((S, max_spill), np.asarray(packs[0].sp_vals).dtype)
    for s, p in enumerate(packs):
        k = p.n_spill
        sp_r[s, :k] = np.asarray(p.sp_rows)
        sp_c[s, :k] = np.asarray(p.sp_cols)
        sp_v[s, :k] = np.asarray(p.sp_vals)
    steps = max(p.scan_steps for p in packs)
    return (jax.device_put(jnp.asarray(seg), sh3),
            jax.device_put(jnp.asarray(val), sh3),
            jax.device_put(jnp.asarray(inv), sh3),
            (jax.device_put(jnp.asarray(sp_r), sh2),
             jax.device_put(jnp.asarray(sp_c), sh2),
             jax.device_put(jnp.asarray(sp_v), sh2)),
            steps)


def partition_gell_pruned(m: SparseCSR, mesh: Mesh, *, axis: str = ROW_AXIS,
                          tile_rows: int | None = None) -> PrunedGELL:
    """Pack + place a square sparse matrix with the pruned-exchange plan."""
    n, n_cols = m.shape
    if n != n_cols:
        raise ValueError("partition_gell_pruned: matrix must be square")
    S = mesh.shape[axis]
    nnz_total = int(m.data.shape[0])
    if tile_rows is None:
        tile_rows = auto_tile_rows(n, nnz_total)
    tiles_per_shard = -(-(-(-n // S)) // tile_rows)
    rps = tiles_per_shard * tile_rows
    segs_per_shard = rps // LANES

    rows = np.asarray(m.rows, np.int64)
    cols = np.asarray(m.indices, np.int64)
    vals = np.asarray(m.data)
    if np.dtype(vals.dtype).kind == "c":
        raise ValueError("partition_gell_pruned: complex operators use the "
                         "split-complex partitions")
    shard_of = rows // rps

    # --- per-shard footprints ------------------------------------------
    fps = []          # sorted remote segment lists per shard
    shard_nnz = []    # (rows_local, cols_global, vals, own_mask)
    for s in range(S):
        sel = shard_of == s
        r_, c_, v_ = rows[sel] - s * rps, cols[sel], vals[sel]
        own = (c_ >= s * rps) & (c_ < (s + 1) * rps)
        fp = np.unique(c_[~own] // LANES)
        fps.append(fp)
        shard_nnz.append((r_, c_, v_, own))
    max_fp = max((len(f) for f in fps), default=0)
    has_remote = max_fp > 0

    # --- own-block packs ------------------------------------------------
    own_packs, rem_packs = [], []
    for s in range(S):
        r_, c_, v_, own = shard_nnz[s]
        own_packs.append(pack_gell(r_[own], c_[own] - s * rps, v_[own],
                                   (rps, rps), tile_rows=tile_rows))
        if has_remote:
            fp = fps[s]
            pos = {g: i for i, g in enumerate(fp)}
            cr = c_[~own]
            loc = (np.array([pos[g] for g in cr // LANES], np.int64) * LANES
                   + cr % LANES) if len(cr) else np.zeros(0, np.int64)
            rem_packs.append(pack_gell(r_[~own], loc, v_[~own],
                                       (rps, (max_fp + 1) * LANES),
                                       tile_rows=tile_rows))

    own = _stack_packs(own_packs, mesh, axis)
    scan_steps = own[4]
    if has_remote:
        rem = _stack_packs(rem_packs, mesh, axis)
        scan_steps = max(scan_steps, rem[4])
    else:
        # no shard references any remote column (block-diagonal): reuse
        # the own arrays as never-read placeholders of valid shape
        rem = own

    # --- exchange plan ----------------------------------------------------
    sh2 = NamedSharding(mesh, P(axis, None))
    plan = []
    distances = []
    for d in range(1, S):
        counts = []
        needs = []
        for s in range(S):
            # owner of segment g is g // segs_per_shard (segments never
            # straddle shard boundaries: rps is a multiple of 128)
            need = [g for g in fps[s] if g // segs_per_shard == (s - d) % S]
            needs.append(need)
            counts.append(len(need))
        M_d = max(counts, default=0)
        if M_d == 0:
            continue
        send_idx = np.zeros((S, M_d), np.int32)
        recv_pos = np.full((S, M_d), max_fp, np.int32)  # pad -> dump row
        for s in range(S):
            dst = (s + d) % S
            to_send = needs[dst]
            send_idx[s, :len(to_send)] = [g - s * segs_per_shard
                                          for g in to_send]
            pos = {g: i for i, g in enumerate(fps[s])}
            recv_pos[s, :counts[s]] = [pos[g] for g in needs[s]]
        plan.append((jax.device_put(jnp.asarray(send_idx), sh2),
                     jax.device_put(jnp.asarray(recv_pos), sh2)))
        distances.append(d)

    return PrunedGELL(
        own_seg=own[0], own_val=own[1], own_inv=own[2], own_sp=own[3],
        rem_seg=rem[0], rem_val=rem[1], rem_inv=rem[2], rem_sp=rem[3],
        plan=tuple(plan), n_orig=n, n_shards=S, tile_rows=tile_rows,
        scan_steps=scan_steps, max_fp=max_fp, distances=tuple(distances),
        has_remote=has_remote)


def _local_matvec_factory(A: PrunedGELL, axis: str):
    """The per-shard matvec body (closure over the static plan shape)."""
    rps = A.rows_per_shard
    S = A.n_shards
    segs_per_shard = rps // LANES

    def local(own_seg, own_val, own_inv, osp_r, osp_c, osp_v,
              rem_seg, rem_val, rem_inv, rsp_r, rsp_c, rsp_v,
              plan_flat, x_local):
        # 1) kick off the segment exchange (one ppermute per distance) —
        #    these depend only on x_local and fly while the own-block
        #    SpMV computes.
        xseg = x_local.reshape(segs_per_shard, LANES)
        received = []
        for d, (sidx, rpos) in zip(A.distances, plan_flat):
            send = jnp.take(xseg, sidx[0], axis=0)
            recv = jax.lax.ppermute(
                send, axis, [(i, (i + d) % S) for i in range(S)])
            received.append((rpos[0], recv))
        # 2) own-block SpMV — no communication dependency (overlap target)
        y = gell_local_matvec(own_seg, own_val, own_inv, osp_r, osp_c,
                              osp_v, x_local, rps=rps, n_cols=rps,
                              tile_rows=A.tile_rows,
                              scan_steps=A.scan_steps)
        # 3) scatter received segments into the compact footprint buffer
        #    and run the remote-column pack
        if A.has_remote:
            xc = jnp.zeros((A.max_fp + 1, LANES), x_local.dtype)
            for rpos, recv in received:
                xc = xc.at[rpos].set(recv)
            y = y + gell_local_matvec(
                rem_seg, rem_val, rem_inv, rsp_r, rsp_c, rsp_v,
                xc.reshape(-1), rps=rps, n_cols=(A.max_fp + 1) * LANES,
                tile_rows=A.tile_rows, scan_steps=A.scan_steps)
        return y

    return local


def _in_specs(A: PrunedGELL, axis: str, x_spec=None):
    p3 = P(axis, None, None)
    p2 = P(axis, None)
    return (p3, p3, p3, p2, p2, p2,
            p3, p3, p3, p2, p2, p2,
            tuple((p2, p2) for _ in A.plan),
            P(axis) if x_spec is None else x_spec)


def _args(A: PrunedGELL, x):
    return (A.own_seg, A.own_val, A.own_inv, *A.own_sp,
            A.rem_seg, A.rem_val, A.rem_inv, *A.rem_sp,
            A.plan, x)


def pruned_gell_matvec(A: PrunedGELL, x, mesh: Mesh, *,
                       axis: str = ROW_AXIS):
    """One distributed SpMV: sharded x -> sharded y (jittable); comm =
    ``A.comm_bytes_per_matvec`` per device instead of all_gather's O(n)."""
    local = _local_matvec_factory(A, axis)
    return jax.shard_map(local, mesh=mesh, in_specs=_in_specs(A, axis),
                         out_specs=P(axis))(*_args(A, x))


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def _pruned_gell_power(A: PrunedGELL, x0, max_iterations, tol,
                       mesh: Mesh, axis: str):
    from ..core.results import EigenResult as ER
    from ..solvers.power import power_iteration_loop
    from .sharded import psum_norm, psum_vdot

    body = _local_matvec_factory(A, axis)

    def local_loop(own_seg, own_val, own_inv, osp_r, osp_c, osp_v,
                   rem_seg, rem_val, rem_inv, rsp_r, rsp_c, rsp_v,
                   plan_flat, x0_local):
        def matvec(x_local):
            return body(own_seg, own_val, own_inv, osp_r, osp_c, osp_v,
                        rem_seg, rem_val, rem_inv, rsp_r, rsp_c, rsp_v,
                        plan_flat, x_local)

        return power_iteration_loop(
            matvec,
            lambda a, b: psum_vdot(a, b, axis=axis),
            lambda v: psum_norm(v, axis=axis),
            x0_local, max_iterations, tol)

    from ..core.results import EigenResult
    return jax.shard_map(
        local_loop, mesh=mesh, in_specs=_in_specs(A, axis),
        out_specs=EigenResult(eigenvalue=P(), eigenvector=P(axis),
                              iterations=P(), converged=P()),
    )(*_args(A, x0))


def distributed_gell_power_pruned(A: PrunedGELL, mesh: Mesh, opts=None, *,
                                  axis: str = ROW_AXIS, key=None, x0=None):
    """Dominant eigenpair via pruned-exchange power iteration (reference
    loop semantics: power_method.hpp:47-99, distributed reductions)."""
    from ..core.options import SolverOptions
    from ..utils.prng import default_key, random_unit_vector
    if opts is None:
        opts = SolverOptions()
    n, n_pad = A.n_orig, A.n_padded
    if x0 is None:
        xh = np.asarray(random_unit_vector(
            key if key is not None else default_key(), n, A.dtype))
    else:
        xh = np.asarray(x0, dtype=A.dtype)
        nrm = np.linalg.norm(xh)
        if nrm != 0:
            xh = xh / nrm
    xp = np.zeros(n_pad, dtype=A.dtype)
    xp[:n] = xh
    x0_sharded = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(axis)))
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return _pruned_gell_power(A, x0_sharded,
                              jnp.asarray(opts.max_iterations, jnp.int32),
                              jnp.asarray(opts.tolerance, ftype),
                              mesh, axis)
