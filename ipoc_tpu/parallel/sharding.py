"""Device-mesh utilities and the cross-shard associative scan.

The reference is single-device (SURVEY §5.8: no pmap/pjit/shard_map, no
collectives of any kind).  This module supplies the scaling layer:

* :func:`make_mesh` — build a ``jax.sharding.Mesh`` over {batch, time}.
* :func:`sharded_associative_scan` — a two-level associative scan for use
  inside ``shard_map``: local O(log T_local) scan per shard, one
  ``all_gather`` of per-shard aggregate elements over the mesh axis
  (NVLink between the GPUs of one host), and a local fixup combine.  This is blockwise/ring-style sequence
  parallelism transplanted to Riccati/costate elements (SURVEY §5.7).

The combine convention everywhere is ``fn(earlier, later)`` where "earlier"
means earlier in the scanned (time) direction; direction handling is
internal.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(batch: int = 1, time: int = 1,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Mesh over ('batch', 'time').

    ``batch`` shards independent scenarios (data parallelism);
    ``time`` shards the horizon of each solve (sequence parallelism).
    Total must equal the device count used.  The device list is reshaped
    in order, which suits the GPUs of one host: NVLink joins them all to
    all, so no placement is better than another.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = batch * time
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(batch, time)
    return Mesh(dev_array, ("batch", "time"))


def _index_in(tree, i):
    return jax.tree.map(lambda a: lax.dynamic_index_in_dim(a, i, 0, False), tree)


def sharded_associative_scan(
    fn: Callable, elems, axis_name: str, reverse: bool = False
):
    """Associative scan over the concatenation of per-shard element slices.

    Must be called inside ``shard_map`` with ``axis_name`` bound.  Each shard
    holds a contiguous (time-ordered) slice of the element array along axis
    0; the result equals ``lax.associative_scan(fn', full_array)`` restricted
    to the local slice, where ``fn'`` is ``fn`` with the direction-dependent
    argument order.

    Three phases: (1) local associative scan; (2) ``all_gather`` of each
    shard's total aggregate over ``axis_name`` followed by a tiny scan over
    the (n_shards,) aggregate array; (3) one broadcast combine applying the
    external prefix (or suffix) to every local element.
    """
    idx = lax.axis_index(axis_name)
    n_shards = lax.axis_size(axis_name)

    if reverse:
        local = lax.associative_scan(
            lambda a, b: fn(b, a), elems, reverse=True, axis=0
        )
        # This shard's aggregate spans its whole slice: element 0 of the
        # local suffix scan.
        agg = jax.tree.map(lambda a: a[0], local)
        aggs = lax.all_gather(agg, axis_name)  # (n_shards, ...)
        suffixes = lax.associative_scan(
            lambda a, b: fn(b, a), aggs, reverse=True, axis=0
        )
        # External suffix for shard i combines shards i+1..S-1.
        ext = _index_in(suffixes, jnp.minimum(idx + 1, n_shards - 1))
        combined = fn(local, ext)
        is_last = idx == n_shards - 1
        return jax.tree.map(
            lambda l, c: jnp.where(is_last, l, c), local, combined
        )
    else:
        local = lax.associative_scan(fn, elems, axis=0)
        agg = jax.tree.map(lambda a: a[-1], local)
        aggs = lax.all_gather(agg, axis_name)
        prefixes = lax.associative_scan(fn, aggs, axis=0)
        # External prefix for shard i combines shards 0..i-1.
        ext = _index_in(prefixes, jnp.maximum(idx - 1, 0))
        combined = fn(ext, local)
        is_first = idx == 0
        return jax.tree.map(
            lambda l, c: jnp.where(is_first, l, c), local, combined
        )


def batch_sharding(mesh: Mesh, *specs):
    """NamedSharding helpers for batch-leading arrays."""
    return tuple(NamedSharding(mesh, P(*s)) for s in specs)
