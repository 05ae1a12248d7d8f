"""Multi-host initialisation and multi-host mesh construction.

The cross-host tier of SURVEY.md §5: pair-batches shard across hosts over
the network while row tiles stay on each host's cards (NVLink).  This
wraps ``jax.distributed.initialize`` (which bootstraps the JAX distributed
runtime over the coordinator address) and builds the (pairs, rows) mesh
with the pairs axis spanning processes — so the embarrassingly-parallel
batch dimension crosses hosts and the halo-exchange axis stays local.

Single-process environments (tests, one-card rigs) pass through untouched.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def distributed_config(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None
                       ) -> Tuple[Optional[str], Dict[str, int]]:
    """Resolve the distributed-runtime configuration.

    Explicit arguments win; otherwise JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID are read.  Returns
    ``(coordinator_address_or_None, kwargs_for_initialize)`` — split out of
    :func:`initialize_distributed` so the parsing is testable without
    bootstrapping a real coordination service."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    kw: Dict[str, int] = {}
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    return coordinator_address, kw


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Bootstrap the JAX distributed runtime if configured.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    arguments are omitted.  Returns True if multi-process mode is active."""
    coordinator_address, kw = distributed_config(
        coordinator_address, num_processes, process_id)
    if not coordinator_address:
        return False
    jax.distributed.initialize(coordinator_address, **kw)
    return jax.process_count() > 1


def pod_mesh(rows_per_host: Optional[int] = None, *,
             devices: Optional[Sequence] = None,
             n_local: Optional[int] = None) -> Mesh:
    """Build a ('pairs', 'rows') mesh for the current (possibly multi-host)
    topology: the rows axis spans cards within one host, the pairs axis
    spans hosts x any leftover local factor.

    ``devices`` / ``n_local`` default to the live topology
    (``jax.devices()`` / ``jax.local_device_count()``); tests inject
    synthetic grids.  ``rows_per_host`` is clamped to the largest divisor
    of ``n_local`` not exceeding it, so the rows axis never crosses a host
    boundary."""
    devices = list(jax.devices()) if devices is None else list(devices)
    # jax.devices() id order is NOT guaranteed host-contiguous on every
    # topology — group by the owning process first (stable by id within a
    # host) so the reshape below cannot mix chips from different hosts
    # into one rows-group.  Objects without process metadata (synthetic
    # test grids) keep their given order.
    if devices and all(hasattr(d, "process_index") for d in devices):
        devices.sort(key=lambda d: (d.process_index, getattr(d, "id", 0)))
    if n_local is None:
        n_local = jax.local_device_count()
    n_local = max(1, min(n_local, len(devices)))
    n_hosts = max(1, len(devices) // n_local)
    # guard against ragged topologies: use exactly n_hosts * n_local devices
    n_total = n_hosts * n_local
    devices = devices[:n_total]
    if rows_per_host is None:
        rows_per_host = n_local
    rows_per_host = max(1, min(rows_per_host, n_local))
    while n_local % rows_per_host:  # must divide the local device count
        rows_per_host -= 1
    pairs = n_total // rows_per_host
    # order devices host-major so the rows axis stays in one host: each
    # mesh row is rows_per_host consecutive devices of a single host
    arr = np.array(devices).reshape(n_hosts, n_local)
    arr = arr.reshape(n_hosts * (n_local // rows_per_host), rows_per_host)
    return Mesh(arr[:pairs], axis_names=("pairs", "rows"))
