"""Multi-host support for the distributed sort.

The reference is strictly single-process/single-GPU (SURVEY.md §1); this
layer extends the distributed sort to several GPU hosts, each with one or
more cards. It is deliberately thin: JAX's runtime owns process bootstrap
and cross-host collectives, so all this module does is

  * initialize the distributed runtime exactly once per process
    (``ensure_initialized`` — a no-op under a single process),
  * build the canonical 1-D global mesh over every device of every host,
    host-major so each host's cards sit contiguously on the axis,
  * assemble a global sharded array from per-host shards
    (``global_array_from_host_data``).

``parallel.distributed.sort_sharded`` then works unchanged over the global
mesh: XLA hands the same ``lax.all_to_all``/``all_gather`` to NCCL, over
NVLink within a host and over the network between hosts.

The logic that can be tested without a cluster (splitters, shuffle,
stability) runs on a virtual CPU mesh (tests/test_distributed.py), exactly
as SURVEY.md §4 prescribes.
"""

from __future__ import annotations

import os

import jax
import numpy as np

_INITIALIZED = False


def ensure_initialized(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize ``jax.distributed`` once; returns True if multi-process.

    Initializes when a coordinator is given, as an argument or through
    ``JAX_COORDINATOR_ADDRESS``; explicit arguments follow
    ``jax.distributed.initialize``. Safe to call repeatedly and from
    single-process runs.
    """
    global _INITIALIZED
    # Decide from args/env BEFORE touching any jax backend query:
    # jax.process_count() instantiates the local backend, after which
    # jax.distributed.initialize() raises ("must be called before backends
    # are initialized") — probing first would make explicit multi-host
    # init impossible.
    want_multi = (
        coordinator_address is not None
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if want_multi and not _INITIALIZED:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except RuntimeError as e:  # pragma: no cover - needs a live cluster
            # a launcher may have initialized the distributed service
            # already; "already initialized" is success
            if "already" not in str(e).lower():
                raise
    _INITIALIZED = True
    return jax.process_count() > 1


def global_mesh_1d(axis_name: str = "x") -> jax.sharding.Mesh:
    """1-D mesh over all devices of all processes, host-major order.

    Host-major ordering keeps each host's cards contiguous on the axis, so
    the bulk of ``sort_sharded``'s all-to-all volume rides NVLink and only
    the inter-host remainder crosses the network.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return jax.sharding.Mesh(np.asarray(devs), (axis_name,))


def global_array_from_host_data(
    local_data: np.ndarray, mesh: jax.sharding.Mesh, axis_name: str = "x"
) -> jax.Array:
    """Assemble the global sharded array from this host's shard of keys.

    ``local_data`` is this process's contiguous chunk (equal length on every
    host). The resulting global array is sharded over ``axis_name`` and
    feeds ``sort_sharded`` directly.
    """
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(axis_name)
    )
    return jax.make_array_from_process_local_data(sharding, local_data)
