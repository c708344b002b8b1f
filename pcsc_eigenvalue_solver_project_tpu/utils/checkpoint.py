"""Checkpoint / resume for long-running solves.

The reference runs to completion in memory with no serialisation
(SURVEY.md §5 — 'Checkpoint/resume: absent'). The long-running config
(1M-row distributed power iteration) warrants persistence: solver state is
a small tuple of arrays (x, lambda, k, flags), saved with
``numpy.savez`` every ``chunk`` iterations so a preempted job resumes where
it stopped instead of restarting thousands of SpMVs.

``power_method_checkpointed`` drives the standard loop kernel
(solvers/power.py) in chunks: each chunk is one on-device ``while_loop``
segment, with a host-side save between chunks. Semantics (stopping
rule, iteration counts) are identical to ``power_method`` because it IS
the same loop carry.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..ops.dia import dia_matvec_il_window, il_window_halo
from ..solvers.power import (carry_to_result, power_carry_loop,
                             power_init_carry)
from .prng import default_key, random_unit_vector


def _npz_path(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state) -> None:
    """Persist a solver state (a tuple of arrays); overwrites atomically."""
    target = _npz_path(path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, *[np.asarray(v) for v in jax.device_get(tuple(state))])
    os.replace(tmp, target)


def restore_state(path: str):
    """Load a solver state as a tuple of arrays, or None if absent."""
    target = _npz_path(path)
    if not os.path.exists(target):
        return None
    with np.load(target) as z:
        return tuple(z[f"arr_{i}"] for i in range(len(z.files)))


@jax.jit
def _power_chunk(M: AbstractMatrix, carry, k_end: jax.Array, tol: jax.Array):
    return power_carry_loop(M.matvec, jnp.vdot, jnp.linalg.norm, carry,
                            k_end, tol)


def power_method_checkpointed(M: AbstractMatrix,
                              opts: SolverOptions = SolverOptions(), *,
                              checkpoint_dir: str, chunk: int = 200,
                              key=None, x0=None) -> EigenResult:
    """Power iteration with periodic checkpoints and auto-resume.

    State layout: the loop carry of solvers/power.py plus nothing else —
    restoring and continuing produces the same iterate sequence as an
    uninterrupted run.
    """
    require_square(M, "power_method")
    require_nonempty(M, "power_method")
    path = os.path.join(os.path.abspath(checkpoint_dir), "power_state")

    restored = restore_state(path)
    if restored is not None:
        carry = tuple(jnp.asarray(v) for v in restored)
    else:
        if x0 is None:
            x0 = random_unit_vector(key if key is not None else default_key(),
                                    M.shape[0], M.dtype)
        else:
            x0 = jnp.asarray(x0, M.dtype)
            nrm = jnp.linalg.norm(x0)
            x0 = jnp.where(nrm == 0, x0, x0 / jnp.where(nrm == 0, 1, nrm).astype(M.dtype))
        carry = power_init_carry(M.matvec, x0)

    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    tol = jnp.asarray(opts.tolerance, ftype)
    while True:
        k = int(carry[0])
        done = bool(carry[7])
        if done or k >= opts.max_iterations:
            break
        k_end = jnp.asarray(min(k + chunk, opts.max_iterations), jnp.int32)
        carry = _power_chunk(M, carry, k_end, tol)
        save_state(path, carry)
    return carry_to_result(carry)


# --------------------------------------------------------------------------
# Distributed (interleaved) checkpointed power — the 1M-row long-running
# config: same loop carry, chunks run as one jitted shard_map while_loop
# segment, carry gathered to host for the save and re-placed with its
# shardings on restore. Single-controller scope: multi-controller jobs would
# have to save each host's addressable shards instead of device_get.
# --------------------------------------------------------------------------


def _dist_il_specs(axis):
    from jax.sharding import PartitionSpec as P
    return (P(), P(axis, None), P(axis, None), P(), P(), P(), P(), P())


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("mesh", "axis"))
def _dist_il_chunk(A, carry, k_end: jax.Array, tol: jax.Array, mesh, axis):
    from jax.sharding import PartitionSpec as P
    from ..parallel.dia import dia_il_halo_window
    from ..parallel.sharded import psum_norm, psum_vdot
    pr = il_window_halo(A.offsets)

    def local(data_il, carry, k_end, tol):
        def matvec(x):
            w = dia_il_halo_window(x, pr, axis=axis)
            return dia_matvec_il_window(data_il, A.offsets, w)

        return power_carry_loop(matvec,
                                lambda a, b: psum_vdot(a, b, axis=axis),
                                lambda v: psum_norm(v, axis=axis),
                                carry, k_end, tol)

    specs = _dist_il_specs(axis)
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, axis, None), specs, P(), P()),
                         out_specs=specs)(A.data_il, carry, k_end, tol)


@_partial(jax.jit, static_argnames=("mesh", "axis"))
def _dist_il_init(A, x0_il: jax.Array, mesh, axis):
    from jax.sharding import PartitionSpec as P
    from ..parallel.dia import dia_il_halo_window
    pr = il_window_halo(A.offsets)

    def local(data_il, x0_local):
        def matvec(x):
            w = dia_il_halo_window(x, pr, axis=axis)
            return dia_matvec_il_window(data_il, A.offsets, w)

        return power_init_carry(matvec, x0_local)

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, axis, None), P(axis, None)),
                         out_specs=_dist_il_specs(axis))(A.data_il, x0_il)


def distributed_dia_il_power_checkpointed(A, mesh, opts: SolverOptions = SolverOptions(),
                                          *, checkpoint_dir: str,
                                          chunk: int = 200, axis: str = "rows",
                                          key=None, x0=None) -> EigenResult:
    """Distributed interleaved power iteration with checkpoints.

    ``A`` is a ``parallel.dia.PartitionedILDIA``; the returned
    ``eigenvector`` is the sharded interleaved iterate (decode with
    ``parallel.dia.decode_vec_il_sharded``). Restoring mid-run reproduces
    the uninterrupted iterate sequence exactly — the checkpoint IS the
    loop carry.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.dia import encode_vec_il_sharded
    path = os.path.join(os.path.abspath(checkpoint_dir), "dist_power_state")

    restored = restore_state(path)
    if restored is not None:
        vec_sh = NamedSharding(mesh, P(axis, None))
        rep = NamedSharding(mesh, P())
        carry = tuple(
            jax.device_put(jnp.asarray(v), vec_sh if i in (1, 2) else rep)
            for i, v in enumerate(restored))
    else:
        vdt = np.dtype(jnp.promote_types(A.dtype, jnp.float32))
        if x0 is None:
            xh = np.asarray(random_unit_vector(
                key if key is not None else default_key(), A.n_orig, vdt))
        else:
            xh = np.asarray(x0, dtype=vdt)
            nrm = np.linalg.norm(xh)
            if nrm != 0:
                xh = xh / nrm
        x0_il = encode_vec_il_sharded(xh, A, mesh, axis=axis)
        carry = _dist_il_init(A, x0_il, mesh, axis)

    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    tol = jnp.asarray(opts.tolerance, ftype)
    while True:
        k = int(carry[0])
        done = bool(carry[7])
        if done or k >= opts.max_iterations:
            break
        k_end = jnp.asarray(min(k + chunk, opts.max_iterations), jnp.int32)
        carry = _dist_il_chunk(A, carry, k_end, tol, mesh, axis)
        save_state(path, carry)
    return carry_to_result(carry)
