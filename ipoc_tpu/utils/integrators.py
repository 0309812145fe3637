"""Integrators and trajectory rollout.

Equivalents of reference noc/utils.py:8-63.  The rollout fixes the
reference's double-evaluation quirk (utils.py:58-59 calls ``dynamics`` twice
per step and relies on XLA CSE to dedupe).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def wrap_angle(x):
    """Wrap angle into [0, 2*pi) (reference utils.py:8-10)."""
    return x % (2.0 * jnp.pi)


def runge_kutta(state, action, ode: Callable, step: float):
    """Classic RK4 step with zero-order-hold action (reference utils.py:13-23)."""
    k1 = ode(state, action)
    k2 = ode(state + 0.5 * step * k1, action)
    k3 = ode(state + 0.5 * step * k2, action)
    k4 = ode(state + step * k3, action)
    return state + (step / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discretize_dynamics(ode: Callable, simulation_step: float, downsampling: int = 1):
    """RK4 discretizer with sub-stepping (reference utils.py:26-47)."""

    def dynamics(state, action):
        def substep(_, x):
            return runge_kutta(x, action, ode, simulation_step)

        return lax.fori_loop(0, downsampling, substep, state)

    return dynamics


def euler(ode: Callable, simulation_step: float):
    """Forward-Euler discretizer (reference utils.py:50-54)."""

    def dynamics(state, action):
        return state + simulation_step * ode(state, action)

    return dynamics


def rollout(dynamics: Callable, controls, initial_state):
    """Open-loop rollout; returns the (T+1, nx) state trajectory.

    Single dynamics evaluation per step (the reference evaluates twice,
    utils.py:58-59 — deliberate fix, same output).
    """

    def body(x, u):
        x_next = dynamics(x, u)
        return x_next, x_next

    _, states = lax.scan(body, initial_state, controls)
    return jnp.concatenate([initial_state[None], states], axis=0)


def closed_loop_rollout(dynamics: Callable, gain, ffgain, nominal_states, nominal_controls):
    """Nonlinear closed-loop rollout ``u = u_nom + k + K (x - x_nom)``.

    Single shared implementation of the reference's duplicated
    ``nonlin_rollout`` (par_interior_point_newton.py:87-104,
    differential_dynamic_programming.py:73-90).
    """

    def body(x_hat, inp):
        K, k, x, u = inp
        u_hat = u + k + K @ (x_hat - x)
        return dynamics(x_hat, u_hat), (x_hat, u_hat)

    final_state, (states, controls) = lax.scan(
        body, nominal_states[0], (gain, ffgain, nominal_states[:-1], nominal_controls)
    )
    states = jnp.concatenate([states, final_state[None]], axis=0)
    return states, controls
