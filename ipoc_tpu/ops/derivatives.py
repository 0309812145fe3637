"""The single derivative engine.

The reference triplicates ``compute_derivatives`` verbatim in all three
solver files (par_interior_point_newton.py:13-28 ==
seq_interior_point_newton.py:10-25 == differential_dynamic_programming.py:10-25)
and duplicates ``compute_lqr_params`` and the feasibility check.  This module
is the one shared implementation (SURVEY §2.9).

Notes: Hessians use forward-over-reverse (``jacfwd(jacrev(.))``) which is
the cheap order for the small state/control dims here; everything is vmapped
over the horizon so XLA sees one batched program, not T small ones.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import grad, jacfwd, jacrev

from ipoc_tpu.problem import OCP, Derivatives, LinearizedOCP


def compute_derivatives(ocp: OCP, states, controls, bp) -> Derivatives:
    """Stage derivatives of cost and dynamics along the trajectory.

    Returns first/second cost derivatives and first/second dynamics
    derivatives at every stage (x_k, u_k), k = 0..T-1 (reference semantics:
    par_interior_point_newton.py:13-28).
    """

    def stage(x, u):
        cx = grad(ocp.stage_cost, 0)(x, u, bp)
        cu = grad(ocp.stage_cost, 1)(x, u, bp)
        cxx = jacfwd(grad(ocp.stage_cost, 0), 0)(x, u, bp)
        cuu = jacfwd(grad(ocp.stage_cost, 1), 1)(x, u, bp)
        # cxu[i, j] = d^2 c / dx_i du_j  (matches reference
        # jacrev(jacrev(stage_cost, 0), 1), par:19)
        cxu = jacfwd(grad(ocp.stage_cost, 0), 1)(x, u, bp)
        fx = jacrev(ocp.dynamics, 0)(x, u)
        fu = jacrev(ocp.dynamics, 1)(x, u)
        fxx = jacfwd(jacrev(ocp.dynamics, 0), 0)(x, u)
        fuu = jacfwd(jacrev(ocp.dynamics, 1), 1)(x, u)
        fxu = jacfwd(jacrev(ocp.dynamics, 0), 1)(x, u)
        return Derivatives(cx, cu, cxx, cuu, cxu, fx, fu, fxx, fuu, fxu)

    return jax.vmap(stage)(states[:-1], controls)


def compute_lqr_params(costates, d: Derivatives) -> LinearizedOCP:
    """Newton stage quantities with costate-contracted dynamics curvature.

    ``ru = cu + fu^T lam``, ``Q = cxx + lam . fxx``, ``R = cuu + lam . fuu``,
    ``M = cxu + lam . fxu`` using the *shifted* costates ``lam[1:]``
    (reference par_interior_point_newton.py:31-42).

    Implemented as batched einsums over the whole horizon — no per-stage
    Python, one fused XLA op per quantity.
    """

    lam = costates[1:]
    ru = d.cu + jnp.einsum("tiu,ti->tu", d.fu, lam)
    Q = d.cxx + jnp.einsum("ti,tijk->tjk", lam, d.fxx)
    R = d.cuu + jnp.einsum("ti,tijk->tjk", lam, d.fuu)
    M = d.cxu + jnp.einsum("ti,tijk->tjk", lam, d.fxu)
    return LinearizedOCP(ru, Q, R, M)


def first_order_stages(ocp: OCP, stage_states, controls, bp) -> Derivatives:
    """:func:`compute_first_order` on explicit stage states ``x_0..x_{T-1}``
    (no terminal row) — the form the time-sharded solver consumes, where
    each shard holds only its local stage slice."""

    def stage(x, u):
        cx = grad(ocp.stage_cost, 0)(x, u, bp)
        cu = grad(ocp.stage_cost, 1)(x, u, bp)
        fx = jacrev(ocp.dynamics, 0)(x, u)
        fu = jacrev(ocp.dynamics, 1)(x, u)
        return Derivatives(cx, cu, None, None, None, fx, fu, None, None,
                           None)

    return jax.vmap(stage)(stage_states, controls)


def compute_first_order(ocp: OCP, states, controls, bp) -> Derivatives:
    """First-order stage derivatives only (cx, cu, fx, fu).

    Everything the costate recursion and the trial-step kernels consume;
    the second-order fields are ``None``.  Pairs with
    :func:`compute_hamiltonian_lqr`, which produces the Newton stage data
    without ever materializing the ``(T, nx, nx, nx)`` dynamics-curvature
    tensors.
    """
    return first_order_stages(ocp, states[:-1], controls, bp)


def compute_hamiltonian_lqr(ocp: OCP, states, controls, costates, bp
                            ) -> LinearizedOCP:
    """Newton stage data as Hessians of the stage Hamiltonian.

    Mathematically identical to
    ``compute_lqr_params(costates, compute_derivatives(...))`` (reference
    par_interior_point_newton.py:31-42): with ``H_k(x, u) =
    stage_cost(x, u, bp) + lam_{k+1}^T dynamics(x, u)``,

    * ``ru = dH/du = cu + fu^T lam``
    * ``Q  = d2H/dx2 = cxx + lam . fxx``
    * ``R  = d2H/du2 = cuu + lam . fuu``
    * ``M  = d2H/dxdu = cxu + lam . fxu``

    but computed as ONE scalar Hessian per stage instead of ``nx`` per-output
    Hessians contracted afterwards — nx-fold less second-order work and no
    ``(T, nx, nx, nx)`` intermediates hitting HBM (the tensors dominate the
    derivative phase's memory traffic for batched solves).
    """

    return hamiltonian_lqr_stages(ocp, states[:-1], controls, costates[1:],
                                  bp)


def hamiltonian_lqr_stages(ocp: OCP, stage_states, controls, next_costates,
                           bp) -> LinearizedOCP:
    """:func:`compute_hamiltonian_lqr` on explicit per-stage inputs
    (states x_k, controls u_k, costates lam_{k+1} — all T rows, no terminal
    slots), for callers holding sharded local slices."""

    def stage(x, u, lam_next):
        def ham(xx, uu):
            return ocp.stage_cost(xx, uu, bp) + lam_next @ ocp.dynamics(
                xx, uu
            )

        ru = grad(ham, 1)(x, u)
        Q = jacfwd(grad(ham, 0), 0)(x, u)
        R = jacfwd(grad(ham, 1), 1)(x, u)
        M = jacfwd(grad(ham, 0), 1)(x, u)
        return ru, Q, R, M

    ru, Q, R, M = jax.vmap(stage)(stage_states, controls, next_costates)
    return LinearizedOCP(ru, Q, R, M)


def check_feasibility(ocp: OCP, states, controls):
    """All stage constraints satisfied (``<= 0``) along the trajectory.

    Boundary points count as feasible, matching the reference
    (par_interior_point_newton.py:45-47; the log barrier then yields an
    infinite cost for exactly-on-boundary points).
    """

    cons = jax.vmap(ocp.constraints)(states[:-1], controls)
    return jnp.all(cons <= 0)
