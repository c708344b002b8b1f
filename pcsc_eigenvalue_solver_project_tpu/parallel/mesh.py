"""Device-mesh utilities.

The reference is single-process, single-threaded (main.cpp:41 onward; no
threads/MPI/CUDA anywhere — SURVEY.md §2). The scaling axis here is a
1-D device mesh over which sparse operators are row-partitioned; XLA
inserts the collectives (NCCL between GPUs) — no hand-rolled
communication layer, per SURVEY.md §5.

``initialize_distributed()`` wraps ``jax.distributed.initialize`` for
multi-host runs; single-host multi-device (and the CPU fake mesh used in
tests via ``--xla_force_host_platform_device_count``) need no init.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_row_mesh(n_devices: int | None = None, *, axis: str = ROW_AXIS) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` (default: all) devices."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"make_row_mesh: requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    import numpy as np
    return Mesh(np.array(devices), (axis,))


def row_sharding(mesh: Mesh, ndim: int = 1, *, axis: str = ROW_AXIS) -> NamedSharding:
    """NamedSharding partitioning axis 0 by the mesh rows axis."""
    spec = P(axis, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry: call once per process before building meshes."""
    jax.distributed.initialize(**kwargs)
