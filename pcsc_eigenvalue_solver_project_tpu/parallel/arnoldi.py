"""Distributed Arnoldi — top-k eigenvalues of a row-partitioned operator.

This is the BASELINE 1M-row 'distributed power iteration + QR' config made
concrete: the Krylov basis is row-sharded over the mesh (each device holds
its slice of every basis vector), the only O(n) operations are the
halo/all-gather SpMV and psum inner products, and the m x m Hessenberg
projection — replicated on every device by construction — is solved with
the accelerated shifted-QR kernel. The basis build runs as ONE jitted
``shard_map`` (reusing solvers/arnoldi.py's generic decomposition with
psum reductions injected); the small dense solve happens once afterwards.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.precision import full_precision
from ..core.dtypes import complex_dtype_of
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..solvers.arnoldi import arnoldi_decomposition
from ..solvers.qr_eigenvalues import _qr_eigenvalues_accel
from ..utils.prng import default_key, random_unit_vector
from .mesh import ROW_AXIS
from .sharded import (PartitionedELL, psum_norm, psum_vdot, spmv_all_gather,
                      spmv_halo)


@partial(jax.jit, static_argnames=("mesh", "axis", "exchange", "m"))
def _distributed_arnoldi(A, x0: jax.Array, m: int,
                         mesh: Mesh, axis: str, exchange: str):
    from .dia import PartitionedDIA, dia_halo_window, dia_window_matvec
    from .gell_pruned import (PrunedGELL, _args, _in_specs,
                              _local_matvec_factory)
    if isinstance(A, PrunedGELL):
        # segment-pruned unstructured operator: comm scales with the
        # column footprint (gell_pruned.py), basis build unchanged
        body_fn = _local_matvec_factory(A, axis)

        def local_pruned(*args):
            x0_local = args[-1]

            def matvec(x_local):
                return body_fn(*args[:-1], x_local)

            return arnoldi_decomposition(
                matvec, x0_local, m,
                vdot=lambda a, b: psum_vdot(a, b, axis=axis),
                norm=lambda v: psum_norm(v, axis=axis))

        return jax.shard_map(
            local_pruned, mesh=mesh, in_specs=_in_specs(A, axis),
            out_specs=(P(None, axis), P(), P()),
        )(*_args(A, x0))
    is_dia = isinstance(A, PartitionedDIA)
    if not is_dia:
        body = spmv_halo if exchange == "halo" else spmv_all_gather

    def local(data, extra, x0_local):
        def matvec(x_local):
            if is_dia:
                w = dia_halo_window(x_local, A.halo, axis=axis)
                return dia_window_matvec(data, A.offsets, w, A.halo)
            return body(data, extra, x_local, axis=axis)

        V, H, brk = arnoldi_decomposition(
            matvec, x0_local, m,
            vdot=lambda a, b: psum_vdot(a, b, axis=axis),
            norm=lambda v: psum_norm(v, axis=axis))
        return V, H, brk

    if is_dia:
        in_specs = (P(None, axis), P(), P(axis))
        extra = jnp.zeros((), A.dtype)
    else:
        in_specs = (P(axis, None), P(axis, None), P(axis))
        extra = A.indices
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, axis), P(), P()),
    )(A.data, extra, x0)


@full_precision
def distributed_arnoldi_eigenvalues(A: PartitionedELL, mesh: Mesh,
                                    k: int = 6, *, m: int | None = None,
                                    opts: SolverOptions = SolverOptions(),
                                    axis: str = ROW_AXIS,
                                    exchange: str = "auto", key=None,
                                    x0=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) of the partitioned operator
    (``PartitionedELL`` or the gather-free ``PartitionedDIA``)."""
    if exchange == "auto":
        exchange = "halo" if getattr(A, "halo_ok", True) else "all_gather"
    n, n_pad = A.n_orig, A.n_padded
    if k < 1:
        raise ValueError("distributed_arnoldi_eigenvalues: k must be >= 1")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(f"distributed_arnoldi_eigenvalues: k ({k}) must be <= m ({m})")

    if x0 is None:
        xh = np.asarray(random_unit_vector(key if key is not None else default_key(),
                                           n, A.dtype))
    else:
        xh = np.asarray(x0, dtype=A.dtype)
    xp = np.zeros(n_pad, dtype=A.dtype)
    xp[:n] = xh  # zero padding: spurious zero modes stay dark
    x0_sharded = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(axis)))

    V, H, brk = _distributed_arnoldi(A, x0_sharded, m, mesh, axis, exchange)

    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    Hm = H[:m, :m].astype(jnp.dtype(complex_dtype_of(H.dtype)))
    qr = _qr_eigenvalues_accel(Hm, jnp.asarray(opts.max_iterations, jnp.int32),
                               jnp.asarray(opts.tolerance, ftype))
    order = jnp.argsort(-jnp.abs(qr.eigenvalues))
    return QRResult(eigenvalues=qr.eigenvalues[order][:k],
                    iterations=qr.iterations, converged=qr.converged)


# ---------------------------------------------------------------------------
# distributed Krylov-Schur (nonsymmetric thick restart)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mesh", "axis", "exchange", "l", "m"))
def _distributed_arnoldi_extend(A, W0: jax.Array, l: int, m: int,
                                mesh: Mesh, axis: str, exchange: str):
    """Shard-mapped ``arnoldi_extend``: same operators as
    ``_distributed_arnoldi``, psum-reduced inner products and
    projection pass (VERDICT r3 task 7)."""
    from ..solvers.arnoldi import arnoldi_extend
    from ..solvers.lanczos import _default_project
    from .dia import PartitionedDIA, dia_halo_window, dia_window_matvec
    from .gell_pruned import (PrunedGELL, _args, _in_specs,
                              _local_matvec_factory)

    def kwargs(ax):
        return dict(
            norm=lambda v: psum_norm(v, axis=ax),
            project=lambda W, w: jax.lax.psum(_default_project(W, w), ax))

    if isinstance(A, PrunedGELL):
        body_fn = _local_matvec_factory(A, axis)

        def local_pruned(*args):
            W_local = args[-1]

            def matvec(x_local):
                return body_fn(*args[:-1], x_local)

            return arnoldi_extend(matvec, W_local, l, m, **kwargs(axis))

        return jax.shard_map(
            local_pruned, mesh=mesh,
            in_specs=_in_specs(A, axis, x_spec=P(None, axis)),
            out_specs=(P(None, axis), P(), P()),
        )(*_args(A, W0))
    is_dia = isinstance(A, PartitionedDIA)
    if not is_dia:
        body = spmv_halo if exchange == "halo" else spmv_all_gather

    def local(data, extra, W_local):
        def matvec(x_local):
            if is_dia:
                wnd = dia_halo_window(x_local, A.halo, axis=axis)
                return dia_window_matvec(data, A.offsets, wnd, A.halo)
            return body(data, extra, x_local, axis=axis)

        return arnoldi_extend(matvec, W_local, l, m, **kwargs(axis))

    if is_dia:
        in_specs = (P(None, axis), P(), P(None, axis))
        extra = jnp.zeros((), A.dtype)
    else:
        in_specs = (P(axis, None), P(axis, None), P(None, axis))
        extra = A.indices
    return jax.shard_map(
        local, mesh=mesh, in_specs=in_specs,
        out_specs=(P(None, axis), P(), P()),
    )(A.data, extra, W0)


@full_precision
def distributed_krylov_schur_eigenvalues(A, mesh: Mesh, k: int = 6, *,
                                         m: int | None = None,
                                         restarts: int = 60,
                                         opts: SolverOptions = SolverOptions(),
                                         axis: str = ROW_AXIS,
                                         exchange: str = "auto", key=None,
                                         x0=None) -> QRResult:
    """Distributed Krylov-Schur restarted Arnoldi: ARPACK-class
    convergence on clustered nonsymmetric spectra with a memory-bounded
    row-sharded basis. Host only ever sees the m x m projected matrix;
    basis extension and contraction stay sharded on the mesh."""
    from ..solvers.arnoldi import _ks_contract
    if exchange == "auto":
        exchange = "halo" if getattr(A, "halo_ok", True) else "all_gather"
    n, n_pad = A.n_orig, A.n_padded
    if k < 1:
        raise ValueError("distributed_krylov_schur_eigenvalues: k must be >= 1")
    if restarts < 1:
        raise ValueError(
            "distributed_krylov_schur_eigenvalues: restarts must be >= 1")
    if m is None:
        m = min(max(3 * k + 10, 20), n)
    m = min(m, n)
    if k + 2 > m:
        raise ValueError(
            f"distributed_krylov_schur_eigenvalues: m ({m}) too small for "
            f"k ({k}); need m >= k + 2")
    l_target = min(2 * k, m - 2)

    if x0 is None:
        xh = np.asarray(random_unit_vector(
            key if key is not None else default_key(), n, A.dtype))
    else:
        xh = np.asarray(x0, dtype=A.dtype)
    xp = np.zeros(n_pad, dtype=A.dtype)
    xp[:n] = xh
    sh_vec = NamedSharding(mesh, P(axis))
    sh_basis = NamedSharding(mesh, P(None, axis))
    x0_sharded = jax.device_put(jnp.asarray(xp), sh_vec)

    tol = float(opts.tolerance)
    V, H, brk = _distributed_arnoldi(A, x0_sharded, m, mesh, axis, exchange)
    steps = min(int(np.asarray(brk)), m)
    total_mv = steps
    Hnp = np.asarray(H)
    Hm = Hnp[:steps, :steps]
    beta = float(np.abs(Hnp[steps, steps - 1])) if steps == m else 0.0

    wanted = None
    for _ in range(restarts):
        wanted, resid, conv, Q_l, S_new, b_new = _ks_contract(
            Hm, beta, k, l_target, tol)
        if conv:
            return QRResult(eigenvalues=jnp.asarray(wanted),
                            iterations=jnp.asarray(total_mv, jnp.int32),
                            converged=jnp.asarray(True))
        l_eff = Q_l.shape[1]
        Qd = jnp.asarray(np.ascontiguousarray(Q_l), V.dtype)
        Y = jnp.tensordot(Qd, V[:steps], axes=[[0], [0]])
        W0 = jnp.zeros((m + 1,) + V.shape[1:], V.dtype)
        W0 = W0.at[:l_eff].set(Y).at[l_eff].set(V[steps])
        W0 = jax.device_put(W0, sh_basis)
        V, H2, brk2 = _distributed_arnoldi_extend(A, W0, l_eff, m, mesh,
                                                  axis, exchange)
        steps2 = min(int(np.asarray(brk2)), m)
        total_mv += max(steps2 - l_eff, 0)
        H2np = np.asarray(H2)
        cdt = S_new.dtype
        Hm = np.zeros((steps2, steps2), cdt)
        Hm[:, l_eff:] = H2np[:steps2, l_eff:steps2].astype(cdt)
        Hm[:l_eff, :l_eff] = S_new
        Hm[l_eff, :l_eff] = b_new
        beta = float(np.abs(H2np[steps2, steps2 - 1])) if steps2 == m \
            else 0.0
        steps = steps2

    return QRResult(eigenvalues=jnp.asarray(wanted),
                    iterations=jnp.asarray(total_mv, jnp.int32),
                    converged=jnp.asarray(False))
