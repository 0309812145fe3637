"""Receding-horizon MPC drivers.

First-class version of the reference's inlined MPC loop
(examples/linear_mpc_parallel.py:67-81): at every simulation step re-solve
the horizon subproblem and apply the first control.  The whole closed-loop
simulation is one ``lax.scan`` — a single XLA program.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ipoc_tpu.parallel.lqt import (
    LQT,
    par_bwd_pass,
    par_fwd_pass,
    seq_bwd_pass,
    seq_fwd_pass,
)


def lqt_mpc_loop(lqt: LQT, x0, n_steps: int, mode: str = "par",
                 plant: Callable | None = None):
    """Closed-loop MPC with a fixed LQT subproblem re-solved every step.

    ``mode`` selects the parallel (associative-scan) or sequential LQT
    passes (reference linear_mpc_parallel.py:67-76).  ``plant`` optionally
    overrides the simulation dynamics (defaults to the LQT's stage-0 model).
    Returns ``(states, controls)`` with shapes (n_steps, nx) / (n_steps, nu).
    """
    if mode == "par":
        bwd = lambda: par_bwd_pass(lqt)[:2]
        fwd = lambda x, K, d: par_fwd_pass(lqt, x, K, d)
    elif mode == "seq":
        bwd = lambda: seq_bwd_pass(lqt)[:2]
        fwd = lambda x, K, d: seq_fwd_pass(lqt, x, K, d)
    else:
        raise ValueError(f"unknown mode: {mode}")

    if plant is None:
        plant = lambda x, u: lqt.A[0] @ x + lqt.B[0] @ u + lqt.c[0]

    def step(x, _):
        K, d = bwd()
        u_plan, x_plan = fwd(x, K, d)
        u0 = u_plan[0]
        x_next = plant(x, u0)
        return x_next, (x_next, u0)

    _, (xs, us) = lax.scan(step, x0, xs=None, length=n_steps)
    return xs, us


def nmpc_loop(solve: Callable, plant: Callable, x0, u_init, n_steps: int):
    """Nonlinear MPC: ``solve(u_warm, x) -> u_plan`` re-solved each step with
    warm starting (shift-free, matching the reference's warm-start-by-resolve
    pattern); applies ``u_plan[0]`` through ``plant``.

    ``solve`` is typically a partial of an interior-point solver.  Returns
    ``(states, controls)``.
    """

    def step(carry, _):
        x, u_warm = carry
        u_plan = solve(u_warm, x)
        u0 = u_plan[0]
        x_next = plant(x, u0)
        return (x_next, u_plan), (x_next, u0)

    (_, _), (xs, us) = lax.scan(step, (x0, u_init), xs=None, length=n_steps)
    return xs, us


def nmpc_loop_batched(solve_batch: Callable, plant: Callable, x0s, u_init,
                      n_steps: int):
    """Batched nonlinear MPC: B controllers in lockstep, ONE resolve per
    step for the whole batch (``solve_batch(u_warm (B,T,nu), xs (B,nx)) ->
    u_plans (B,T,nu)``), warm-start-by-resolve semantics as
    :func:`nmpc_loop` (reference linear_mpc_parallel.py:67-81).

    The payoff over ``vmap(nmpc_loop)`` is that ``solve_batch`` can be a
    batch-NATIVE solver (for example a lockstep flat-mode batch solver)
    instead of a vmapped per-controller program.  Returns
    ``(states (n_steps,B,nx), controls (n_steps,B,nu))``.
    """
    vplant = jax.vmap(plant)

    def step(carry, _):
        xs, u_warm = carry
        u_plans = solve_batch(u_warm, xs)
        u0 = u_plans[:, 0]
        x_next = vplant(xs, u0)
        return (x_next, u_plans), (x_next, u0)

    (_, _), (xs, us) = lax.scan(step, (x0s, u_init), xs=None,
                                length=n_steps)
    return xs, us


def nmpc_loop_batched_warm(solve_cold: Callable, solve_warm: Callable,
                           plant: Callable, x0s, u_init, n_steps: int):
    """Batched NMPC with warm barrier re-entry.

    The FIRST resolve (cold ``u_init``, no plan to continue) runs
    ``solve_cold`` — the full barrier schedule; every subsequent resolve
    warm-starts from the controller's own previous plan and runs
    ``solve_warm`` — typically a batch solver that re-enters the barrier
    one decade in (bp=0.02) instead of replaying the cold homotopy (plan
    continuity: same scenario, same basin; infeasible warm starts fall
    back to the cold schedule per lane inside the resolver).  Same return layout as :func:`nmpc_loop_batched`:
    ``(states (n_steps,B,nx), controls (n_steps,B,nu))``.
    """
    if n_steps < 1:
        raise ValueError(
            "nmpc_loop_batched_warm needs n_steps >= 1 (the first step "
            "is the cold resolve)"
        )
    vplant = jax.vmap(plant)
    u_plans0 = solve_cold(u_init, x0s)
    u0 = u_plans0[:, 0]
    x1 = vplant(x0s, u0)

    def step(carry, _):
        xs, u_warm = carry
        u_plans = solve_warm(u_warm, xs)
        uk = u_plans[:, 0]
        x_next = vplant(xs, uk)
        return (x_next, u_plans), (x_next, uk)

    (_, _), (xs_t, us_t) = lax.scan(step, (x1, u_plans0), xs=None,
                                    length=n_steps - 1)
    xs = jnp.concatenate([x1[None], xs_t], axis=0)
    us = jnp.concatenate([u0[None], us_t], axis=0)
    return xs, us
