"""Multi-host runtime: the replacement for the reference's ZMQ
inter-process transport (SURVEY.md section 2.4, "Inter-process
distribution").

One SPMD program over (hosts x devices): ``init()`` wraps
``jax.distributed.initialize`` (explicit coordinator, process count
and id), ``pod_mesh`` builds the time mesh over every device, and ``host_feed`` converts each host's
locally-read IQ blocks into one globally-sharded array — per-host
file feeding with no cross-host byte shuffling (each host's file
chunk must correspond to its time slice).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init", "pod_mesh", "host_feed", "is_coordinator"]


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime.

    Pass the coordinator address (``localhost:<port>`` on one host),
    the process count and this process's id; on a cluster whose
    environment JAX can read, they may be omitted.  Idempotent.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def is_coordinator() -> bool:
    return jax.process_index() == 0


def pod_mesh(name: str = "time") -> Mesh:
    """1-D mesh over every device of every host (links within and
    between hosts are handled by XLA's collective lowering)."""
    return Mesh(np.array(jax.devices()), (name,))


def host_feed(local_block: np.ndarray, mesh: Mesh,
              axis: str = "time") -> jax.Array:
    """Assemble a globally-sharded array from per-host local blocks.

    Each host reads its own slice of the stream (its shard of the
    global block, in time order by process index) and calls this with
    the local [n_local, ...] array; the result is one global jax.Array
    of shape [n_local * num_processes, ...] sharded over ``axis``.
    """
    sharding = NamedSharding(mesh, P(axis))
    global_shape = (local_block.shape[0] * jax.process_count(),
                    *local_block.shape[1:])
    local_devices = [d for d in mesh.devices.flat
                     if d.process_index == jax.process_index()]
    if local_block.shape[0] % len(local_devices):
        raise ValueError(
            f"local block length {local_block.shape[0]} must divide "
            f"evenly over {len(local_devices)} local devices"
        )
    per_dev = np.array_split(local_block, len(local_devices), axis=0)
    arrays = [jax.device_put(chunk, d)
              for chunk, d in zip(per_dev, local_devices)]
    return jax.make_array_from_single_device_arrays(
        global_shape, sharding, arrays
    )
