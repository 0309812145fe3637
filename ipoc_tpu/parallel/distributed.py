"""Multi-host initialization and mesh construction.

The reference has no distributed backend of any kind (SURVEY §5.8).  This
module provides the multi-host entry: ``jax.distributed`` initialization
plus a global mesh over {batch, time} laid out so that the inner-solve
collectives (cross-shard scan combines, ``psum`` merit reductions) stay
among the GPUs of one host, joined by NVLink, while only batch sharding
crosses hosts.

On a single host these are no-ops / local meshes, so the same driver script
runs everywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize multi-host JAX (no-op if single-process).

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly: nothing is inferred on a plain GPU host.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)


def global_mesh(time: int = 1) -> Mesh:
    """Mesh over all devices: ('batch', 'time') with time sharding kept
    inside a host (NVLink) and batch spanning hosts.

    Device order: jax.devices() enumerates host-major, so reshaping to
    (n_devices // time, time) keeps each solve's time shards on one host's
    GPUs — cross-shard scan combines never leave the host.
    """
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % time != 0:
        raise ValueError(f"device count {n} not divisible by time={time}")
    local = jax.local_device_count()
    if time > local:
        raise ValueError(
            f"time={time} shards would span hosts (local devices: {local})"
        )
    if local % time != 0:
        # Host-major rows of length ``time`` stay within one host only
        # when ``time`` divides the per-host device count — e.g. 8 local
        # devices with time=6 would put devices 6..11 (two hosts) in one
        # time group, silently moving every scan-combine collective onto
        # the network between hosts.
        raise ValueError(
            f"time={time} does not divide the per-host device count "
            f"{local}; time groups would straddle hosts"
        )
    return Mesh(devices.reshape(n // time, time), ("batch", "time"))


def scaling_report(solves_per_sec: float, n_chips: int,
                   single_chip_rate: float) -> dict:
    """Multi-chip scaling-efficiency record (BASELINE target >= 80%)."""
    ideal = single_chip_rate * n_chips
    return {
        "chips": n_chips,
        "solves_per_sec": solves_per_sec,
        "ideal": ideal,
        "efficiency": solves_per_sec / ideal if ideal else float("nan"),
    }
