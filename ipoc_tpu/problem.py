"""Problem specification layer.

Re-design of the reference problem containers
(reference: noc/optimal_control_problem.py:5-30).

Differences from the reference, by design:

* The log-barrier is a *first-class solver concern*: `barrier_ocp` synthesizes
  the barrier-augmented stage cost and the total cost from raw
  (cost, constraints) callables, instead of requiring every user to embed
  ``- bp * sum(log(-c))`` in their own stage cost
  (cf. reference examples/pendulum_runtime.py:49-50 which embeds it by hand).
* `OCP` keeps the exact five-callable interface of the reference
  (dynamics, constraints, stage_cost, final_cost, total_cost) so problems
  written against the reference API port over unchanged.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class OCP(NamedTuple):
    """Discrete-time optimal control problem, as five pure callables.

    Same interface as the reference (noc/optimal_control_problem.py:5-10):

    * ``dynamics(x, u) -> x_next``
    * ``constraints(x, u) -> c`` with the convention ``c <= 0`` elementwise
      iff (x, u) is feasible
    * ``stage_cost(x, u, bp) -> float`` — must include the log-barrier term
      ``- bp * sum(log(-constraints(x, u)))`` (use :func:`barrier_ocp` to
      synthesize it instead of writing it by hand)
    * ``final_cost(xT) -> float``
    * ``total_cost(X, U, bp) -> float`` over a ``(T+1, nx)`` state trajectory
      and ``(T, nu)`` control trajectory
    """

    dynamics: Callable
    constraints: Callable
    stage_cost: Callable
    final_cost: Callable
    total_cost: Callable


class Derivatives(NamedTuple):
    """Stacked per-stage derivatives over the horizon.

    Shapes (T = horizon, nx = state dim, nu = control dim), matching the
    reference (noc/optimal_control_problem.py:13-23):

    cx (T,nx), cu (T,nu), cxx (T,nx,nx), cuu (T,nu,nu), cxu (T,nx,nu),
    fx (T,nx,nx), fu (T,nx,nu), fxx (T,nx,nx,nx), fuu (T,nx,nu,nu),
    fxu (T,nx,nx,nu).
    """

    cx: jax.Array
    cu: jax.Array
    cxx: jax.Array
    cuu: jax.Array
    cxu: jax.Array
    fx: jax.Array
    fu: jax.Array
    fxx: jax.Array
    fuu: jax.Array
    fxu: jax.Array


class LinearizedOCP(NamedTuple):
    """Newton-step stage quantities (reference: optimal_control_problem.py:26-30).

    ``r`` is the control-gradient of the Hamiltonian, ``Q/R/M`` the
    costate-contracted stage Hessian blocks.
    """

    r: jax.Array
    Q: jax.Array
    R: jax.Array
    M: jax.Array


def log_barrier(constraints: Callable) -> Callable:
    """Return ``b(x, u) = -sum(log(-c(x, u)))`` for constraint function c.

    Feasible iff ``c < 0`` strictly; on the boundary the barrier is +inf,
    which reproduces the reference's implicit handling (SURVEY §2.4:
    boundary points pass the ``<= 0`` feasibility check but get infinite
    cost through ``log(0)``).
    """

    def barrier(x, u):
        return -jnp.sum(jnp.log(-constraints(x, u)))

    return barrier


def barrier_ocp(
    dynamics: Callable,
    constraints: Callable,
    stage_cost: Callable,
    final_cost: Callable,
) -> OCP:
    """Build an :class:`OCP` with the log-barrier synthesized automatically.

    ``stage_cost(x, u)`` here is the *raw* cost without barrier; the returned
    OCP's ``stage_cost(x, u, bp)`` adds ``bp * barrier`` and ``total_cost``
    sums stage costs plus the final cost, exactly as the reference examples
    do by hand (pendulum_runtime.py:40-57).
    """

    bar = log_barrier(constraints)

    def stage_cost_bp(x, u, bp):
        return stage_cost(x, u) + bp * bar(x, u)

    def total_cost(states, controls, bp):
        ct = jax.vmap(stage_cost_bp, in_axes=(0, 0, None))(
            states[:-1], controls, bp
        )
        return jnp.sum(ct) + final_cost(states[-1])

    return OCP(dynamics, constraints, stage_cost_bp, final_cost, total_cost)


def unconstrained_ocp(
    dynamics: Callable, stage_cost: Callable, final_cost: Callable
) -> OCP:
    """OCP with a vacuous constraint (always feasible), no barrier term.

    Mirrors the reference's linear demo pattern (linear_demo_cuda.py:30-37)
    where ``constraints`` returns a negative constant and the stage cost
    ignores ``bp``.
    """

    def constraints(x, u):
        return jnp.array([-1.0], dtype=jnp.result_type(x))

    def stage_cost_bp(x, u, bp):
        del bp
        return stage_cost(x, u)

    def total_cost(states, controls, bp):
        ct = jax.vmap(stage_cost_bp, in_axes=(0, 0, None))(
            states[:-1], controls, bp
        )
        return jnp.sum(ct) + final_cost(states[-1])

    return OCP(dynamics, constraints, stage_cost_bp, final_cost, total_cost)
