"""Multi-host execution entry points.

The reference has no distributed backend at all (SURVEY.md §2: a pthread
pool is its only parallelism). Here multi-host runs use
``jax.distributed`` + the same (rows, theta) mesh as a single multi-GPU
host: row blocks travel over NVLink between the cards of a host (all to
all) and over the network between hosts, through XLA's collectives (NCCL
underneath) — nothing to manage by hand.

Typical launch (same program on every host; JAX needs the coordinator's
address, the process count and this process's id spelled out):

    from fastsk_jax.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = multihost.global_mesh(rows=-1)   # all global devices on "rows"
    cfg = KernelConfig(mesh=mesh)
    FastSK(g, m, config=cfg).compute_kernel(...)

Every host must feed identical inputs (the usual jax SPMD contract);
results gather to every host.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .sharding import ROWS_AXIS, THETA_AXIS, default_mesh_shape


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize``; arguments left ``None`` are left to
    JAX's own cluster detection, which finds nothing on a plain GPU host —
    pass all three there."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(rows: int = -1, theta: int = 1) -> jax.sharding.Mesh:
    """A (rows, theta) mesh over ALL global devices.

    ``rows=-1`` consumes every device not taken by ``theta``; pass
    explicit factors to control the split. Device order follows
    ``jax.devices()`` so row blocks land host-local first (NVLink
    before the network).
    """
    devices = jax.devices()
    n = len(devices)
    if rows == -1:
        if n % theta:
            raise ValueError(f"{n} devices not divisible by theta={theta}")
        rows = n // theta
    if rows * theta != n:
        raise ValueError(f"mesh {rows}x{theta} != {n} global devices")
    arr = np.asarray(devices).reshape(rows, theta)
    return jax.sharding.Mesh(arr, (ROWS_AXIS, THETA_AXIS))


def auto_mesh() -> jax.sharding.Mesh:
    """Balanced (rows, theta) mesh over all global devices."""
    rows, theta = default_mesh_shape(len(jax.devices()))
    return global_mesh(rows, theta)
