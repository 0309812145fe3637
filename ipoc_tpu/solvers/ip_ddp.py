"""Interior-point differential dynamic programming (IP-DDP) baseline.

Re-implementation of reference
noc/differential_dynamic_programming.py:28-208.  DDP differs from the Newton
solvers in two ways: the second-order dynamics terms are contracted with the
*value gradient* ``Vx`` (not the costates), and the trial trajectory comes
from a *nonlinear* closed-loop re-rollout through the true dynamics
(ddp:73-90) rather than a linear update.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import grad, hessian, lax

from ipoc_tpu.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu.ops import linalg
from ipoc_tpu.ops.derivatives import check_feasibility, compute_derivatives
from ipoc_tpu.problem import OCP, Derivatives
from ipoc_tpu.solvers.barrier import barrier_loop
from ipoc_tpu.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu.utils.integrators import closed_loop_rollout, rollout


def ddp_bwd_pass(final_cost, final_state, d: Derivatives, reg_param,
                 scale_floor: float = 1e-6):
    """DDP backward pass (reference ddp:28-70).

    Value-gradient-contracted curvature: ``Qxx = cxx + fx^T Vxx fx + Vx.fxx``
    etc.; regularization scaled by ``||cu||`` then added to ``Quu``
    (ddp:34-35, 46) — floored like the Newton solver (see
    SolverConfig.reg_scale_floor).  Returns
    ``(ffgain, gain, pred_reduction, feasible, Qu)``.
    """
    rp = reg_param * jnp.maximum(
        jnp.linalg.norm(d.cu), jnp.asarray(scale_floor, d.cu.dtype)
    )
    return ddp_bwd_core(final_cost, final_state, d, rp)


def ddp_bwd_core(final_cost, final_state, d: Derivatives, rp):
    """:func:`ddp_bwd_pass` with the Levenberg parameter ``rp`` already
    scaled (the fused DDP kernel computes the ``||cu||`` scale outside the
    launch, like the fused Newton path — ip_newton._trial_eval)."""

    def step(carry, inp):
        Vx, Vxx = carry
        cx, cu, cxx, cuu, cxu, fx, fu, fxx, fuu, fxu = inp
        fxT, fuT = fx.T, fu.T

        Qx = cx + fxT @ Vx
        Qu = cu + fuT @ Vx
        Qxx = cxx + fxT @ Vxx @ fx + jnp.tensordot(Vx, fxx, axes=1)
        Qxu = cxu + fxT @ Vxx @ fu + jnp.tensordot(Vx, fxu, axes=1)
        Quu = cuu + fuT @ Vxx @ fu + jnp.tensordot(Vx, fuu, axes=1)
        Quu = Quu + rp * jnp.eye(Quu.shape[0], dtype=Quu.dtype)

        pos_def = linalg.is_posdef(Quu)
        sol = linalg.cholesky_solve(
            Quu, jnp.concatenate([Qu[:, None], Qxu.T], axis=1)
        )
        k = -sol[:, 0]
        K = -sol[:, 1:]

        dV = 0.5 * Qu @ k  # = -1/2 Qu^T Quu^{-1} Qu (ddp:53)
        Vx_new = Qx + Qxu @ k
        Vxx_new = linalg.sym(Qxx + Qxu @ K)
        return (Vx_new, Vxx_new), (k, K, dV, pos_def, Qu)

    VxN = grad(final_cost)(final_state)
    VxxN = hessian(final_cost)(final_state)
    _, (ffgain, gain, dV, pos_def, Qu) = lax.scan(
        step,
        (VxN, VxxN),
        (d.cx, d.cu, d.cxx, d.cuu, d.cxu, d.fx, d.fu, d.fxx, d.fuu, d.fxu),
        reverse=True,
    )
    return ffgain, gain, jnp.sum(dV), jnp.all(pos_def), Qu


def _ddp_stage(ocp: OCP, controls, initial_state, bp, cfg: SolverConfig):
    """One barrier stage of IP-DDP (reference ddp:98-186): outer Newton loop
    with derivatives computed once per iteration, inner trust-region loop
    retrying the backward pass + nonlinear rollout with growing
    regularization."""
    dtype = controls.dtype
    states = rollout(ocp.dynamics, controls, initial_state)
    # Infeasible / non-finite warm start: refuse to iterate
    # (see solvers/ip_newton.py).
    start_ok = jnp.isfinite(ocp.total_cost(states, controls, bp))
    init_norm = jnp.where(start_ok, jnp.asarray(1.0, dtype),
                          jnp.asarray(jnp.nan, dtype))

    def outer(val):
        x, u, it, rp, r_inc, _ = val
        cost = ocp.total_cost(x, u, bp)
        d = compute_derivatives(ocp, x, u, bp)

        def trial(inner):
            _, _, _, _, rp, r_inc, k, _ = inner
            ffgain, gain, pred, bwd_feasible, Qu = ddp_bwd_pass(
                ocp.final_cost, x[-1], d, rp, cfg.reg_scale_floor
            )
            temp_x, temp_u = closed_loop_rollout(
                ocp.dynamics, gain, ffgain, x, u
            )
            Hu_norm = jnp.max(jnp.abs(Qu))
            new_cost = jnp.where(
                check_feasibility(ocp, temp_x, temp_u),
                ocp.total_cost(temp_x, temp_u, bp),
                jnp.inf,
            )
            rho = gain_ratio(new_cost, cost, pred)
            success = jnp.logical_and(rho > 0, bwd_feasible)
            stalled = jnp.logical_and(
                jnp.logical_not(success), rp >= cfg.reg_max
            ) & bool(cfg.stall_exit)
            rp, r_inc = lm_update(rp, r_inc, rho, success, cfg)
            return temp_x, temp_u, success, Hu_norm, rp, r_inc, k + 1, stalled

        def trial_cond(inner):
            _, _, success, Hu_norm, _, _, k, stalled = inner
            stop = jnp.logical_or(success, k > cfg.max_inner_iters)
            stop = jnp.logical_or(stop, stalled)
            # Robustness guard: non-finite gradients never recover.
            stop = jnp.logical_or(
                stop,
                jnp.logical_and(k > 0, jnp.logical_not(jnp.isfinite(Hu_norm))),
            )
            return jnp.logical_not(stop)

        new_x, new_u, _, Hu_norm, rp, r_inc, _, stalled = lax.while_loop(
            trial_cond,
            trial,
            (x, u, jnp.bool_(False), jnp.asarray(0.0, dtype), rp, r_inc,
             jnp.asarray(0, jnp.int32), jnp.bool_(False)),
        )
        trial_ok = (
            jnp.isfinite(jnp.sum(new_u))
            & jnp.isfinite(jnp.sum(new_x))
            & jnp.logical_not(stalled)
        )
        x = jnp.where(trial_ok, new_x, x)
        u = jnp.where(trial_ok, new_u, u)
        Hu_norm = jnp.where(stalled, jnp.asarray(jnp.nan, dtype), Hu_norm)
        return x, u, it + 1, rp, r_inc, Hu_norm

    def outer_cond(val):
        _, _, it, _, _, Hu_norm = val
        done = jnp.logical_or(Hu_norm < cfg.tol, it > cfg.max_ddp_iters)
        done = jnp.logical_or(done, jnp.logical_not(jnp.isfinite(Hu_norm)))
        return jnp.logical_not(done)

    x, u, iters, _, _, _ = lax.while_loop(
        outer_cond,
        outer,
        (
            states,
            controls,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(cfg.reg_init, dtype),
            jnp.asarray(cfg.reg_inc_init, dtype),
            init_norm,
        ),
    )
    return x, u, iters


def interior_point_ddp(
    ocp: OCP, controls, initial_state, cfg: SolverConfig = DEFAULT_CONFIG
):
    """IP-DDP entry point (reference ddp:189-208): returns
    ``(optimal_controls, total_iterations)``."""

    def stage(u, bp):
        _, u, iters = _ddp_stage(ocp, u, initial_state, bp, cfg)
        return u, iters

    return barrier_loop(stage, controls, cfg)
