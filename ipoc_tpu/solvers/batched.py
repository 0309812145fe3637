"""Batched and mesh-sharded interior-point solves.

The throughput path (SURVEY §7 L5): the reference solves one problem at a
time on one GPU; here thousands of scenarios
(initial states, warm starts) are vmapped into one XLA program and sharded
over a device mesh with ``shard_map``.

Under ``vmap`` the solvers' data-dependent ``lax.while_loop``s batch
automatically: the loop runs until every lane's predicate is false and
per-lane updates are masked, so early-converged lanes idle until the slowest
lane finishes — use the iteration caps in SolverConfig to bound tail latency.
Cross-shard communication is one ``psum`` for aggregate iteration stats;
each solve is otherwise shard-local (batch parallelism crosses devices only
at dispatch boundaries).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ipoc_tpu.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu.problem import OCP
from ipoc_tpu.solvers.ip_ddp import interior_point_ddp
from ipoc_tpu.solvers.ip_newton import (
    par_interior_point_optimal_control,
    seq_interior_point_optimal_control,
)

_SOLVERS = {
    "par": par_interior_point_optimal_control,
    "seq": seq_interior_point_optimal_control,
    "ddp": interior_point_ddp,
}


class BatchSolution(NamedTuple):
    controls: jax.Array    # (B, T, nu)
    iterations: jax.Array  # (B,) total Newton iterations per scenario


def solve_batch(
    ocp: OCP,
    controls,       # (B, T, nu) warm starts
    initial_states,  # (B, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    method: str = "par",
) -> BatchSolution:
    """vmap a full IP solve over a batch of scenarios (one XLA program)."""
    solver = _SOLVERS[method]

    def one(u0, x0):
        u, iters = solver(ocp, u0, x0, cfg)
        return u, iters

    u, iters = jax.vmap(one)(controls, initial_states)
    return BatchSolution(u, iters)


def solve_batch_sharded(
    ocp: OCP,
    controls,
    initial_states,
    mesh: Mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    method: str = "par",
    axis_name: str = "batch",
) -> BatchSolution:
    """Shard the scenario batch over a mesh axis; vmapped solves per shard.

    The batch dimension must divide evenly by the axis size.  Solves are
    embarrassingly parallel across shards; keeping them inside ``shard_map``
    (rather than relying on ``jit`` auto-sharding) guarantees no accidental
    resharding of the while-loop carries mid-solve.
    """

    def shard_fn(u0, x0):
        sol = solve_batch(ocp, u0, x0, cfg, method)
        return sol.controls, sol.iterations

    u, iters = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name, None, None), P(axis_name, None)),
        out_specs=(P(axis_name, None, None), P(axis_name)),
        check_vma=False,
    )(controls, initial_states)
    return BatchSolution(u, iters)


def make_batch(key, base_state, n: int, horizon: int, nu: int,
               state_scale=0.0, control_scale=0.1, dtype=jnp.float32):
    """Random scenario batch: perturbed initial states + noise warm starts."""
    k1, k2 = jax.random.split(key)
    x0 = base_state[None, :] + state_scale * jax.random.normal(
        k1, (n, base_state.shape[0]), dtype
    )
    u0 = control_scale * jax.random.normal(k2, (n, horizon, nu), dtype)
    return u0.astype(dtype), x0.astype(dtype)
