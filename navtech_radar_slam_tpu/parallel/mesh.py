"""Device-mesh helpers.

The reference's "distributed" story is two ROS processes + five pthreads on
one CPU (SURVEY §2 parallelism table, §5.8).  Here the descriptor bank,
keyframe map, and pose graph shard over a `jax.sharding.Mesh`, with XLA
collectives (psum / all_gather) between the devices.  These helpers
standardize mesh construction for one device, one host's devices, or
several hosts (jax.distributed — same code path).  The mesh is 1-D: the
bank search and the pose graph need no device topology.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


BANK_AXIS = "bank"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize multi-host JAX (call once per host before make_mesh()).

    Pass coordinator "host:port", the process count, and this host's
    index; with no arguments JAX reads them from a cluster environment it
    recognises.  Returns the global device count.  After this,
    `make_mesh()` over `jax.devices()` spans every host and the
    collectives in sharded_bank/dist_pgo run unchanged."""
    import jax

    if coordinator is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


def make_mesh(
    num_devices: Optional[int] = None,
    axis: str = BANK_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the first `num_devices` devices (default: all).

    Raises ValueError when fewer than `num_devices` devices are present."""
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(
                f"mesh of {num_devices} devices requested but only "
                f"{len(devs)} present ({devs[0].platform if devs else 'none'})"
            )
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis,))


def bank_sharding(mesh: Mesh, axis: str = BANK_AXIS) -> NamedSharding:
    """Shard the leading (keyframe) dimension across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
