"""Streaming batched interior-point solves: refill converged lanes.

The vmapped batch solvers (solvers/batched.py) pay the LOCKSTEP MAXIMUM of
per-scenario iteration counts: every lane idles until the slowest lane of the
batch finishes (and, in staged barrier mode, at every stage boundary).  On
cold-started batches the lockstep maximum is a multiple of the median
iteration count, and that factor is pure idle work.

``solve_stream`` processes a POOL of N scenarios with B resident lanes in a
two-level loop: an inner ``lax.while_loop`` advances every live lane by up
to ``refill_every`` flat-mode Newton iterations (solvers/ip_newton.py
flat_lane_iter — per-scenario semantics identical to
``barrier_mode="flat"``), then the outer loop scatters converged lanes'
solutions to the output buffer and gathers fresh scenarios from the pool.
The batch therefore pays ~mean(iterations) per scenario plus one drain tail
for the whole stream, instead of max(iterations) per batch — the "batched
re-fill of fresh scenarios into converged lanes" throughput strategy
(SURVEY §7 "Hard parts": amortizing whole IP solves without idling
early-converged lanes).

The reference has no batching of any kind (SURVEY §2: one solve per call,
single GPU); this module is new surface.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ipoc_tpu.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu.problem import OCP
from ipoc_tpu.solvers.ip_newton import (
    flat_lane_init,
    flat_lane_iter,
    flat_total_cap,
)


class StreamSolution(NamedTuple):
    controls: jax.Array    # (N, T, nu) per-scenario solutions
    iterations: jax.Array  # (N,) Newton iterations per scenario
    steps: jax.Array       # () i32 lockstep loop steps taken


def _select(mask, new, old):
    """Per-lane pytree select; mask is (B,), leaves are (B, ...)."""
    return jax.tree_util.tree_map(
        lambda n, o: jnp.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
        new, old,
    )


def solve_stream(
    ocp: OCP,
    controls,        # (N, T, nu) per-scenario warm starts
    initial_states,  # (N, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    bp_init=None,    # optional (N,) per-scenario barrier start (else cfg's)
    rp_init=None,    # optional (N,) per-scenario initial LM damping
    inner_unroll: int = 1,
) -> StreamSolution:
    """Solve N scenarios with B = min(lanes, N) resident lanes, refilling.

    Per-scenario results (controls, iterations) are exactly those of the
    flat-mode solver (``cfg.barrier_mode`` is ignored; the stream is
    inherently flat): the same trial sequence, the same stage transitions
    — only the lane scheduling differs.  Requires
    ``cfg.globalization == "single"`` (the retry loop is itself a lockstep
    barrier; see SolverConfig.barrier_mode).

    Structure: a two-level loop.  The inner loop runs up to ``refill_every``
    bare Newton-advance steps (exiting early if every lane is finished); the
    outer loop then captures finished scenarios to the output buffer and
    refills those lanes from the pool.  Capture/refill (full-batch output
    scatter, pool gathers, fresh-lane rollouts) is thus amortized over
    ``refill_every`` steps, and the hot inner step carries no conditional.
    A finished lane idles at most
    ``refill_every - 1`` steps; every other lane still advances, so
    per-scenario results are schedule-independent.
    """
    if cfg.globalization != "single":
        raise ValueError(
            "solve_stream requires globalization='single' "
            "(the retry loop is a lockstep barrier across lanes)"
        )
    N, T, nu = controls.shape
    B = min(lanes, N)
    dtype = controls.dtype

    if bp_init is None:
        bp_init = jnp.full((N,), cfg.bp_init, dtype)
    if rp_init is None:
        rp_init = jnp.full((N,), cfg.reg_init, dtype)
    init = jax.vmap(
        lambda u, x, b, r: flat_lane_init(ocp, u, x, cfg, bp0=b, rp0=r))
    step = jax.vmap(lambda ln, adv: flat_lane_iter(ocp, ln, cfg, adv))

    lanes0 = init(controls[:B], initial_states[:B], bp_init[:B],
                  rp_init[:B])
    sid0 = jnp.arange(B, dtype=jnp.int32)
    # Output buffers have one dummy row (index N) absorbing masked scatters.
    out_u0 = jnp.zeros((N + 1, T, nu), dtype)
    out_it0 = jnp.zeros((N + 1,), jnp.int32)
    gens = (N + B - 1) // B
    K = max(1, refill_every)
    unroll = max(1, min(inner_unroll, K))
    # Outer-iteration backstop: every outer round either advances at least
    # one lane-iteration (inner ran >= 1 step; total bounded by the flat cap
    # per scenario-generation, with one idle generation of slack for
    # deferred captures) or, with zero advance possible, captures/retires at
    # least one scenario (bounded by N).
    max_outer = flat_total_cap(cfg) * (gens + 1) + N + gens + 1

    def outer_body(carry):
        lanes, sid, active, pool_next, out_u, out_it, t, r = carry

        # Inner loop: up to K bare Newton-advance steps (no capture/refill
        # machinery on this path), exiting early once every live lane is
        # finished.  `active` is constant within the round.  The body can
        # advance ``inner_unroll`` masked sub-steps per while iteration
        # (per-lane results unchanged; early-exit granularity coarsens).
        def inner_cond(c):
            ln, s = c
            # s + unroll <= K: never overshoot the K-step budget (an
            # unrolled body advances `unroll` sub-steps per iteration)
            return jnp.logical_and(
                s + unroll <= K,
                jnp.any(jnp.logical_and(active, jnp.logical_not(ln.done))),
            )

        def inner_body(c):
            ln, s = c
            for _ in range(unroll):
                adv = jnp.logical_and(active, jnp.logical_not(ln.done))
                # The advance mask is folded into flat_lane_iter's own
                # selects (adv=False lanes come back exactly unchanged), so
                # no second whole-tree lane select is paid here.
                ln = step(ln, adv)
            return ln, s + unroll

        lanes, dt = lax.while_loop(
            inner_cond, inner_body, (lanes, jnp.asarray(0, jnp.int32))
        )

        fin = jnp.logical_and(lanes.done, active)

        # 1. Capture finished scenarios (dummy row N absorbs the rest; all
        #    unfinished lanes collide there harmlessly).
        wsid = jnp.where(fin, sid, N)
        out_u = out_u.at[wsid].set(lanes.u)
        out_it = out_it.at[wsid].set(lanes.it)

        # 2. Refill from the pool: the k-th finished lane (in lane order)
        #    takes scenario pool_next + k, while the pool lasts.  A freshly
        #    refilled lane with a non-finite warm start has done=True from
        #    init and is captured on the next outer round with it=0,
        #    matching the flat solver.
        rank = jnp.cumsum(fin, dtype=jnp.int32) - 1
        new_sid = pool_next + rank
        take = jnp.logical_and(fin, new_sid < N)
        src = jnp.where(take, new_sid, 0)
        fresh = init(controls[src], initial_states[src], bp_init[src],
                     rp_init[src])
        lanes = _select(take, fresh, lanes)
        sid = jnp.where(take, new_sid, sid)
        active = jnp.logical_and(
            active, jnp.logical_or(jnp.logical_not(fin), take)
        )
        pool_next = pool_next + jnp.sum(take, dtype=jnp.int32)
        return lanes, sid, active, pool_next, out_u, out_it, t + dt, r + 1

    def outer_cond(carry):
        _, _, active, _, _, _, _, r = carry
        return jnp.logical_and(jnp.any(active), r < max_outer)

    carry = (
        lanes0,
        sid0,
        jnp.ones((B,), bool),
        jnp.asarray(B, jnp.int32),
        out_u0,
        out_it0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    _, _, _, _, out_u, out_it, steps, _ = lax.while_loop(
        outer_cond, outer_body, carry)
    return StreamSolution(out_u[:N], out_it[:N], steps)


class MultigridSolution(NamedTuple):
    controls: jax.Array           # (N, T, nu) per-scenario solutions
    iterations: jax.Array         # (N,) fine-level Newton iterations
    iterations_coarse: jax.Array  # (N,) coarse-level Newton iterations
    steps: jax.Array              # () fine-level lockstep steps
    steps_coarse: jax.Array       # () coarse-level lockstep steps


def solve_stream_multigrid(
    ocp: OCP,
    ocp_coarse: OCP,
    coarsen: int,
    controls,        # (N, T, nu) per-scenario warm starts (T % coarsen == 0)
    initial_states,  # (N, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    fine_bp_init: float = 0.02,
    fine_reg_init: float = 1.0,
    inner_unroll: int = 1,
    coarse_impl: str | None = None,
    fine_impl: str | None = None,
    coarse_solver=None,
) -> MultigridSolution:
    """Coarse-to-fine (multigrid-in-time) streaming solve.

    Cold-start interior-point work is dominated by the first barrier stage
    (about two thirds of cartpole H=100 iterations), and a Newton iteration
    costs O(T).  So: solve every scenario on a ``coarsen``-x
    coarser time grid first (``ocp_coarse`` must be the same continuous
    problem discretized at ``coarsen * dt``; iterations cost 1/coarsen as
    much), zero-order-hold interpolate the coarse solution, and re-enter the
    barrier schedule on the fine grid at ``fine_bp_init`` (a moderately
    small bp: warm-started IP re-centers quickly, while re-entering at the
    tightest bp crawls along a possibly-different active set).  An
    interpolated start that is infeasible on the fine grid (rare: measured
    0% on the benchmark models) falls back to the original ``controls`` and
    the FULL barrier schedule for that scenario via a per-scenario
    ``bp_init``.

    Solutions satisfy the same final-stage convergence criteria as
    :func:`solve_stream`; on nonconvex problems a small fraction of
    scenarios converges to a different local basin than the single-grid
    path.  The basin choice is decided at the COARSE level: with the
    same-evaluator coarse solve the switched lanes land at higher raw cost
    on average, while ``coarse_impl="ddp"`` (DDP's nonlinear closed-loop
    re-rollouts) lands them in quality-neutral basins; the bench mg mode
    defaults to it.  Use :func:`solve_stream` (single grid) when
    per-scenario reference semantics matter more than throughput.

    This is new surface (no reference analogue; the reference solves one
    problem per call, SURVEY §2).
    """
    N, T, nu = controls.shape
    if T % coarsen != 0:
        raise ValueError(f"horizon {T} not divisible by coarsen={coarsen}")
    from ipoc_tpu.utils.integrators import rollout

    # The coarse level only needs to reach the fine re-entry bp: solving it
    # further down the schedule is wasted work (measured: the fine-level
    # iteration count is unchanged whether the coarse solve stops at
    # fine_bp_init or runs to bp_min — the hard fine lanes are intrinsically
    # hard scenarios, not central-path-distance victims).
    coarse_bp_min = max(cfg.bp_min, fine_bp_init * (1.0 - 1e-6))
    # ``coarse_impl``/``fine_impl`` override the per-level trial evaluator
    # (e.g. a DDP fine re-entry under a Newton coarse solve — the r3
    # verdict's candidate mechanism for quality-neutral switched lanes:
    # DDP's NONLINEAR closed-loop re-rollout evaluates trial steps at
    # their true cost, where the Newton deviation step can walk a
    # linearization into a slightly worse basin).
    c_cfg = cfg.replace(bp_min=coarse_bp_min)
    if coarse_impl is not None:
        c_cfg = c_cfg.replace(newton_impl=coarse_impl)
    f_cfg = cfg if fine_impl is None else cfg.replace(newton_impl=fine_impl)
    # ``coarse_solver`` overrides the coarse-level solve — e.g. ANOTHER
    # multigrid driver, composing a cascadic multi-level scheme (the
    # coarsest level solves the cold barrier stages, intermediate levels
    # advance the barrier at 1/coarsen cost).
    # Signature: (ocp_c, u_c, x0, cfg_c, lanes, refill_every,
    # inner_unroll) -> solution with .controls/.iterations.
    if coarse_solver is None:
        sol_c = solve_stream(ocp_coarse, controls[:, ::coarsen],
                             initial_states, c_cfg, lanes=lanes,
                             refill_every=refill_every,
                             inner_unroll=inner_unroll)
    else:
        sol_c = coarse_solver(ocp_coarse, controls[:, ::coarsen],
                              initial_states, c_cfg, lanes,
                              refill_every, inner_unroll)
    u_warm = jnp.repeat(sol_c.controls, coarsen, axis=1)

    fine_bp = jnp.asarray(fine_bp_init, controls.dtype)

    def usable(u, x0):
        # Gate on a FINITE barrier cost at the re-entry bp: this subsumes
        # strict feasibility (c = 0 gives log(0) -> Inf), non-finite
        # controls, AND a fine-grid rollout that overflows to Inf/NaN —
        # a plain constraint check misses the latter two for control-only
        # constraint models, and a lane admitted with a non-finite cost
        # would be retired unconverged by flat_lane_init's guard instead of
        # falling back.
        x = rollout(ocp.dynamics, u, x0)
        return jnp.isfinite(ocp.total_cost(x, u, fine_bp)) & jnp.all(
            jnp.isfinite(u))

    ok = jax.vmap(usable)(u_warm, initial_states)
    okb = ok.reshape((-1, 1, 1))
    u_start = jnp.where(okb, u_warm, controls)
    bp0 = jnp.where(ok, jnp.asarray(fine_bp_init, controls.dtype),
                    jnp.asarray(cfg.bp_init, controls.dtype))
    rp0 = jnp.where(ok, jnp.asarray(fine_reg_init, controls.dtype),
                    jnp.asarray(cfg.reg_init, controls.dtype))
    sol_f = solve_stream(ocp, u_start, initial_states, f_cfg, lanes=lanes,
                         refill_every=refill_every, bp_init=bp0,
                         rp_init=rp0, inner_unroll=inner_unroll)
    return MultigridSolution(
        controls=sol_f.controls,
        iterations=sol_f.iterations,
        iterations_coarse=sol_c.iterations,
        steps=sol_f.steps,
        steps_coarse=sol_c.steps,
    )


def solve_stream_sharded(
    ocp: OCP,
    controls,        # (N, T, nu) pool, N divisible by the mesh axis
    initial_states,  # (N, nx)
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    axis_name: str = "batch",
    **stream_kwargs,
) -> StreamSolution:
    """Shard the scenario pool over a mesh axis; one stream per shard.

    Streams are embarrassingly parallel (each device drains its own pool
    slice with ``lanes`` resident lanes); the only collective cost is the
    final gather of per-shard outputs.  ``steps`` returns the MAXIMUM
    lockstep step count over shards (the slowest shard bounds wall clock).
    Extra keyword arguments (``inner_unroll``, ...) forward to
    :func:`solve_stream` per shard; the per-scenario ``bp_init``/``rp_init``
    overrides are not forwardable here (they would need their own
    ``in_specs``) — pre-fold them into ``cfg`` or use the unsharded entry.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    bad = {"bp_init", "rp_init"} & set(stream_kwargs)
    if bad:
        raise ValueError(
            f"solve_stream_sharded: {sorted(bad)} cannot be forwarded — a "
            "per-scenario array closed over the shard_map body would be "
            "sliced identically on every shard (wrong per-scenario values); "
            "pre-fold the override into cfg or use solve_stream"
        )

    def shard_fn(u0, x0):
        sol = solve_stream(ocp, u0, x0, cfg, lanes=lanes,
                           refill_every=refill_every, **stream_kwargs)
        steps = jax.lax.pmax(sol.steps, axis_name)
        return sol.controls, sol.iterations, steps

    u, iters, steps = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name, None, None), P(axis_name, None)),
        out_specs=(P(axis_name, None, None), P(axis_name), P()),
        check_vma=False,
    )(controls, initial_states)
    return StreamSolution(u, iters, steps)


def solve_stream_multigrid_sharded(
    ocp: OCP,
    ocp_coarse: OCP,
    coarsen: int,
    controls,        # (N, T, nu) pool, N divisible by the mesh axis
    initial_states,  # (N, nx)
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    axis_name: str = "batch",
    **mg_kwargs,
) -> MultigridSolution:
    """Shard the scenario pool over a mesh axis; one multigrid stream per
    shard (coarse solve, interpolation, fine re-entry and the per-scenario
    fallback all stay shard-local — embarrassingly parallel like
    :func:`solve_stream_sharded`).  Extra keyword arguments
    (``coarse_impl="ddp"`` — the switched-lane quality fix the bench mg
    mode defaults to — ``fine_impl``, ``fine_bp_init``, ``fine_reg_init``,
    ``coarse_solver``, ``inner_unroll``) forward to
    :func:`solve_stream_multigrid` per shard."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def shard_fn(u0, x0):
        sol = solve_stream_multigrid(
            ocp, ocp_coarse, coarsen, u0, x0, cfg, lanes=lanes,
            refill_every=refill_every, **mg_kwargs)
        steps = jax.lax.pmax(sol.steps, axis_name)
        steps_c = jax.lax.pmax(sol.steps_coarse, axis_name)
        return (sol.controls, sol.iterations, sol.iterations_coarse,
                steps, steps_c)

    u, it, itc, steps, steps_c = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name, None, None), P(axis_name, None)),
        out_specs=(P(axis_name, None, None), P(axis_name), P(axis_name),
                   P(), P()),
        check_vma=False,
    )(controls, initial_states)
    return MultigridSolution(u, it, itc, steps, steps_c)
