"""Distributed Lanczos — top-k eigenvalues of a row-partitioned
symmetric/Hermitian operator.

Reuses the generic decomposition (solvers/lanczos.py) inside ONE jitted
``shard_map``: the basis is row-sharded, the matvec is the halo /
all-gather SpMV (or the interleaved seam-lane fast path for
``PartitionedILDIA``), inner products and the reorthogonalisation
projection are psum'd, and the m x m tridiagonal solve — replicated by
construction — happens once on host with Ritz residual bounds.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.precision import full_precision
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..ops.dia import dia_matvec_il_window, il_window_halo
from ..solvers.lanczos import (_default_project, _ritz_from_tridiag,
                               lanczos_decomposition)
from ..utils.prng import default_key, random_unit_vector
from .mesh import ROW_AXIS
from .sharded import (PartitionedELL, psum_norm, psum_vdot, spmv_all_gather,
                      spmv_halo)


@partial(jax.jit, static_argnames=("mesh", "axis", "exchange", "m", "reorth"))
def _distributed_lanczos(A, x0: jax.Array, m: int, mesh: Mesh, axis: str,
                         exchange: str, reorth: bool):
    from .dia import (PartitionedDIA, PartitionedILDIA, dia_halo_window,
                      dia_il_halo_window, dia_window_matvec)
    is_dia = isinstance(A, PartitionedDIA)
    is_il = isinstance(A, PartitionedILDIA)
    if is_il:
        pr = il_window_halo(A.offsets)
        vec_spec = P(axis, None)
    else:
        vec_spec = P(axis)
        if not is_dia:
            body = spmv_halo if exchange == "halo" else spmv_all_gather

    def local(data, extra, x0_local):
        def matvec(x_local):
            if is_il:
                w = dia_il_halo_window(x_local, pr, axis=axis)
                return dia_matvec_il_window(data, A.offsets, w)
            if is_dia:
                w = dia_halo_window(x_local, A.halo, axis=axis)
                return dia_window_matvec(data, A.offsets, w, A.halo)
            return body(data, extra, x_local, axis=axis)

        return lanczos_decomposition(
            matvec, x0_local, m,
            vdot=lambda a, b: psum_vdot(a, b, axis=axis),
            norm=lambda v: psum_norm(v, axis=axis),
            project=lambda V, w: jax.lax.psum(_default_project(V, w), axis),
            reorth=reorth)

    if is_il:
        in_specs = (P(None, axis, None), P(), vec_spec)
        extra = jnp.zeros((), A.dtype)
        v_out = P(None, axis, None)
    elif is_dia:
        in_specs = (P(None, axis), P(), vec_spec)
        extra = jnp.zeros((), A.dtype)
        v_out = P(None, axis)
    else:
        in_specs = (P(axis, None), P(axis, None), vec_spec)
        extra = A.indices
        v_out = P(None, axis)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=in_specs,
        out_specs=(v_out, P(), P(), P()),
    )(A.data_il if is_il else A.data, extra, x0)


@full_precision
def distributed_lanczos_eigenvalues(A, mesh: Mesh, k: int = 6, *,
                                    m: int | None = None,
                                    opts: SolverOptions = SolverOptions(),
                                    which: str = "LM", reorth: bool = True,
                                    axis: str = ROW_AXIS,
                                    exchange: str = "auto", key=None,
                                    x0=None) -> QRResult:
    """Top-``k`` eigenvalues of a row-partitioned Hermitian operator
    (``PartitionedELL``, ``PartitionedDIA`` or the interleaved
    ``PartitionedILDIA`` fast path)."""
    from .dia import PartitionedDIA, PartitionedILDIA, encode_vec_il_sharded
    if not isinstance(A, (PartitionedELL, PartitionedDIA, PartitionedILDIA)):
        raise ValueError(
            "distributed_lanczos_eigenvalues: operator must be a "
            "PartitionedELL, PartitionedDIA or PartitionedILDIA, got "
            f"{type(A).__name__}")
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"distributed_lanczos_eigenvalues: unknown which={which!r}")
    if exchange == "auto":
        exchange = "halo" if getattr(A, "halo_ok", True) else "all_gather"
    is_il = isinstance(A, PartitionedILDIA)
    n = A.n_orig
    if k < 1:
        raise ValueError("distributed_lanczos_eigenvalues: k must be >= 1")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(
            f"distributed_lanczos_eigenvalues: k ({k}) must be <= m ({m})")

    vdt = np.dtype(jnp.promote_types(A.dtype, jnp.float32))
    if x0 is None:
        xh = np.asarray(random_unit_vector(key if key is not None else default_key(),
                                           n, vdt))
    else:
        xh = np.asarray(x0, dtype=vdt)
    if is_il:
        x0_sharded = encode_vec_il_sharded(xh, A, mesh, axis=axis)
    else:
        xp = np.zeros(A.n_padded, dtype=vdt)
        xp[:n] = xh
        x0_sharded = jax.device_put(jnp.asarray(xp),
                                    NamedSharding(mesh, P(axis)))

    V, alpha, beta, brk = _distributed_lanczos(A, x0_sharded, m, mesh, axis,
                                               exchange, reorth)
    steps = int(np.asarray(brk)) if int(np.asarray(brk)) < m else m
    steps = max(steps, 1)
    ritz, converged, _ = _ritz_from_tridiag(
        np.asarray(alpha)[:steps], np.asarray(beta)[:steps],
        min(k, steps), which, float(opts.tolerance))
    return QRResult(eigenvalues=jnp.asarray(ritz),
                    iterations=jnp.asarray(steps, jnp.int32),
                    converged=jnp.asarray(converged))
