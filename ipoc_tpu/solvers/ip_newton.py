"""Interior-point Newton solvers: parallel-in-time and sequential.

Re-implementations of the reference solvers with identical
numerical semantics (reference: noc/par_interior_point_newton.py and
noc/seq_interior_point_newton.py) but one shared derivative engine
(ops/derivatives.py), one shared LM update (solvers/globalization.py), one
shared barrier driver (solvers/barrier.py), and the in-repo LQT scan algebra
(parallel/lqt.py) instead of the external ``paroc``.

Structure of the flagship parallel solver (matching reference par:127-254):

* outer ``lax.while_loop`` over barrier stages (bp: 0.1 -> /5 -> 1e-4)
* per stage, ``lax.while_loop`` over Newton iterations; each iteration
  computes cost, derivatives, parallel costates and Newton stage data once
* inner ``lax.while_loop`` of trust-region retries: build the Newton LQT
  with Levenberg regularization scaled by ||cu|| (par:116-118), run the
  O(log T) parallel backward/forward passes, accept on positive gain ratio
  and convex backward pass (par:164-166)

Everything is jit-closed: one XLA program per solve.

Deliberate deviations (documented, gated by SolverConfig):

* ``jnp.linalg.eigh`` convexity checks -> Cholesky-success flags
* explicit inverses -> Cholesky solves
* the LQT terminal weight defaults to the exact ``hessian(final_cost)``
  instead of the reference's ``Q[0]`` placeholder (par:74); set
  ``terminal_hessian="reference"`` to replicate the quirk
* the sequential solver gains an iteration cap (the reference has none,
  seq:157-161, and can loop forever)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import grad, hessian, lax

from ipoc_tpu.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu.ops import linalg
from ipoc_tpu.ops.derivatives import (
    check_feasibility,
    compute_first_order,
    compute_hamiltonian_lqr,
)
from ipoc_tpu.parallel.costates import par_costates, seq_costates
from ipoc_tpu.parallel.lqt import newton_lqt, par_bwd_pass, par_fwd_pass
from ipoc_tpu.problem import OCP, Derivatives, LinearizedOCP
from ipoc_tpu.solvers.barrier import barrier_loop, n_barrier_stages
from ipoc_tpu.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu.utils.integrators import rollout


def _regularized(lin: LinearizedOCP, d: Derivatives, rp, scale_by_grad: bool,
                 scale_floor: float = 1e-6):
    """Levenberg regularization of the control Hessian block.

    Reference par:116-118: ``R += rp * ||cu||_F * I`` (the seq solver adds
    ``rp`` unscaled inside its backward pass instead, seq:51).  The scale is
    floored (see SolverConfig.reg_scale_floor) so that points with
    identically vanishing ``cu`` can still be regularized.
    """
    if scale_by_grad:
        rp = rp * jnp.maximum(
            jnp.linalg.norm(d.cu), jnp.asarray(scale_floor, d.cu.dtype)
        )
    nu = lin.R.shape[-1]
    R = lin.R + rp * jnp.eye(nu, dtype=lin.R.dtype)
    return LinearizedOCP(lin.r, lin.Q, R, lin.M)


def _seq_trial_scan(lin_reg: LinearizedOCP, d: Derivatives, XT):
    """Sequential Newton trial as reverse/forward ``lax.scan``s.

    The reference recursion (seq_interior_point_newton.py:42-90) with the
    terminal Hessian passed explicitly.  Returns ``(du, dx,
    pred_reduction, feasible)``.
    """

    def step(carry, inp):
        Vxx, Vx = carry
        r, Q, R, M, fx, fu = inp
        fxT, fuT = fx.T, fu.T
        Vfx = Vxx @ fx
        Vfu = Vxx @ fu
        Qxx = Q + fxT @ Vfx
        Quu = R + fuT @ Vfu
        Qxu = M + fxT @ Vfu
        Qu = r + fuT @ Vx
        Qx = fxT @ Vx
        convex = jnp.logical_and(linalg.is_posdef(Quu), linalg.is_posdef(R))
        sol = linalg.cholesky_solve(
            Quu, jnp.concatenate([Qu[:, None], Qxu.T], axis=1)
        )
        k = -sol[:, 0]
        K = -sol[:, 1:]
        Vx_new = Qx + Qxu @ k
        Vxx_new = linalg.sym(Qxx + Qxu @ K)
        dV = k @ Qu + 0.5 * k @ (Quu @ k)
        return (Vxx_new, Vx_new), (K, k, dV, convex)

    VxN = jnp.zeros((XT.shape[-1],), XT.dtype)
    _, (K, k, dV, convex) = lax.scan(
        step, (XT, VxN), (lin_reg.r, lin_reg.Q, lin_reg.R, lin_reg.M,
                          d.fx, d.fu),
        reverse=True,
    )
    du, dx = seq_fwd_newton(K, k, d)
    return du, dx, jnp.sum(dV), jnp.all(convex)


def _costates(ocp: OCP, x_last, d: Derivatives, cfg: SolverConfig):
    """Costate recursion matched to the step evaluator: parallel-in-time
    scan for ``newton_impl="par"``, reverse scan for ``"seq"`` — identical
    values either way."""
    if cfg.newton_impl == "seq":
        return seq_costates(ocp, x_last, d)
    return par_costates(ocp, x_last, d)


def par_newton_step(ocp: OCP, x, d: Derivatives, rp, lin: LinearizedOCP,
                    cfg: SolverConfig):
    """One regularized Newton trial step (reference par:107-124).

    Returns ``(dx, du, pred_reduction, feasible, Hu)``; the forward pass
    starts from zero deviation, so (dx, du) are additive updates.

    Step evaluator (cfg.newton_impl):

    * ``"par"`` — parallel-in-time, O(log T) span: the newton_lqt ->
      par_bwd_pass -> par_fwd_pass pipeline of associative scans.  For
      single solves, where the horizon is the only parallelism.
    * ``"seq"`` — sequential-in-time, O(T) work: reverse/forward scans.
      For batched solves, where the scenario batch fills the device.
    """
    if cfg.newton_impl == "fused":
        raise ValueError(
            "newton_impl='fused' evaluates the whole trial in one fused "
            "kernel and requires globalization='single' (the single-trial "
            "staged or flat drivers); the retry loop re-solves with new "
            "regularization, which the fused evaluation covers via "
            "_trial_eval instead"
        )
    if cfg.newton_impl == "ddp":
        raise ValueError(
            "newton_impl='ddp' evaluates the whole trial (derivatives + "
            "Vx-contracted backward pass + nonlinear re-rollout) per "
            "iteration and requires globalization='single'; use "
            "interior_point_ddp for the reference retry-loop structure"
        )
    lin_reg = _regularized(
        lin, d, rp, cfg.scale_reg_by_grad, cfg.reg_scale_floor
    )
    if cfg.terminal_hessian == "reference":
        XT = lin.Q[0]  # reference quirk, par:74
    else:
        XT = hessian(ocp.final_cost)(x[-1])

    if cfg.newton_impl == "seq":
        du, dx, pred_reduction, feasible = _seq_trial_scan(lin_reg, d, XT)
        return dx, du, pred_reduction, feasible, lin.r

    lqt = newton_lqt(lin_reg, d, XT)
    Kx, kff, _, _, pred_reduction, feasible = par_bwd_pass(lqt)
    du, dx = par_fwd_pass(lqt, jnp.zeros_like(x[0]), Kx, kff)
    return dx, du, pred_reduction, feasible, lin.r


def _newton_stage_par(ocp: OCP, controls, initial_state, bp, cfg: SolverConfig):
    """One barrier stage of the parallel Newton method (reference par:127-225)."""
    dtype = controls.dtype
    states = rollout(ocp.dynamics, controls, initial_state)
    # Robustness guard (the reference has no such check and burns its whole
    # 500x1000-iteration budget on NaN costs): an infeasible / non-finite
    # warm start makes the barrier objective NaN and no step can ever be
    # accepted — refuse to iterate, returning the inputs unchanged.
    start_ok = jnp.isfinite(ocp.total_cost(states, controls, bp))
    init_norm = jnp.where(start_ok, jnp.asarray(1.0, dtype),
                          jnp.asarray(jnp.nan, dtype))

    def newton_iter(val):
        x, u, it, rp, r_inc, _ = val

        cost = ocp.total_cost(x, u, bp)
        d = compute_first_order(ocp, x, u, bp)
        costates = _costates(ocp, x[-1], d, cfg)
        lin = compute_hamiltonian_lqr(ocp, x, u, costates, bp)

        def trial(inner):
            _, _, _, _, rp, r_inc, k, _ = inner
            dx, du, pred, bwd_feasible, Hu = par_newton_step(
                ocp, x, d, rp, lin, cfg
            )
            temp_x = x + dx
            temp_u = u + du
            Hu_norm = jnp.max(jnp.abs(Hu))
            new_cost = jnp.where(
                check_feasibility(ocp, temp_x, temp_u),
                ocp.total_cost(temp_x, temp_u, bp),
                jnp.inf,
            )
            rho = gain_ratio(new_cost, cost, pred)
            success = jnp.logical_and(rho > 0.0, bwd_feasible)
            # Stall: a rejected trial at maximum regularization — no later
            # retry can do better (cfg.stall_exit).
            stalled = jnp.logical_and(
                jnp.logical_not(success), rp >= cfg.reg_max
            ) & bool(cfg.stall_exit)
            rp, r_inc = lm_update(rp, r_inc, rho, success, cfg)
            return temp_x, temp_u, success, Hu_norm, rp, r_inc, k + 1, stalled

        def trial_cond(inner):
            _, _, success, Hu_norm, _, _, k, stalled = inner
            stop = jnp.logical_or(success, k > cfg.max_inner_iters)
            stop = jnp.logical_or(stop, stalled)
            # Robustness guard (deviation from the reference, which spins
            # through its full 500x1000 iteration budget on NaN costs, e.g.
            # for an infeasible warm start): a non-finite gradient norm can
            # never recover, so bail out of the retry loop immediately.
            stop = jnp.logical_or(
                stop,
                jnp.logical_and(k > 0, jnp.logical_not(jnp.isfinite(Hu_norm))),
            )
            return jnp.logical_not(stop)

        # NOTE: like the reference (par:175,184-188), the trial state is
        # adopted unconditionally on inner-loop exit — except on the stall
        # and non-finite paths (where the trial is known-bad).
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
        # Signal the outer loop via a NaN gradient norm on stall.
        Hu_norm = jnp.where(stalled, jnp.asarray(jnp.nan, dtype), Hu_norm)
        return x, u, it + 1, rp, r_inc, Hu_norm

    tol = jnp.maximum(
        jnp.asarray(cfg.tol, dtype), cfg.stage_tol_scale * bp
    )

    def newton_cond(val):
        _, _, it, _, _, Hu_norm = val
        done = jnp.logical_or(Hu_norm < tol, it > cfg.max_newton_iters)
        # Non-finite gradient norm -> unrecoverable; stop (robustness guard).
        done = jnp.logical_or(done, jnp.logical_not(jnp.isfinite(Hu_norm)))
        return jnp.logical_not(done)

    x, u, iters, _, _, _ = lax.while_loop(
        newton_cond,
        newton_iter,
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


def _trial_eval(ocp: OCP, x, u, bp, rp, cfg: SolverConfig):
    """One Newton trial evaluation: ``(cost, temp_x, temp_u, pred,
    bwd_feasible, Hu_norm, new_cost)``.

    Shared by the single-trial staged stage and the flat-mode lane iteration
    (the reference computes this block inline in every solver, seq:121-131).

    ``cfg.newton_impl == "fused"`` routes the WHOLE evaluation — model
    derivatives, costates, Riccati, trial rollout, both cost evaluations,
    and the feasibility check — through one per-lane op
    (ops/pallas/fused_iter_kernel.py make_fused_iter): under vmap on the
    GPU in float32 two Triton launches that re-derive the model in-kernel,
    elsewhere the identical plain composition.
    """
    if cfg.newton_impl == "ddp":
        # DDP as a throughput path: the flat/stream executors drive DDP
        # lanes through this evaluator (reference ships DDP as a peer
        # solver, ddp:98-186; here it gets the same batched machinery as
        # the Newton step): ip_ddp semantics with the reg scale hoisted out.
        from ipoc_tpu.ops.pallas.fused_iter_kernel import _fused_ddp_reference

        cu = jax.vmap(
            lambda xx, uu: grad(ocp.stage_cost, 1)(xx, uu, bp)
        )(x[:-1], u)
        # DDP scales the Levenberg parameter by ||cu|| unconditionally
        # (reference ddp:34-35).
        reg = rp * jnp.maximum(
            jnp.linalg.norm(cu),
            jnp.asarray(cfg.reg_scale_floor, cu.dtype),
        )
        (temp_x, temp_u, cost, nc_raw, max_c, pred, bwd_feasible,
         Hu_norm) = _fused_ddp_reference(ocp, x, u, bp, reg)
        new_cost = jnp.where(max_c <= 0.0, nc_raw, jnp.inf)
        return cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost

    if cfg.newton_impl == "fused":
        from ipoc_tpu.ops.pallas.fused_iter_kernel import make_fused_iter

        if cfg.terminal_hessian != "exact":
            raise ValueError(
                "newton_impl='fused' computes the terminal Hessian "
                "in-kernel and requires terminal_hessian='exact'"
            )
        # Levenberg scale (reference par:116-118): ||cu||_F of the RAW cost
        # gradient — the only stage quantity needed before the backward
        # sweep, so it stays outside the kernel.
        cu = jax.vmap(
            lambda xx, uu: grad(ocp.stage_cost, 1)(xx, uu, bp)
        )(x[:-1], u)
        if cfg.scale_reg_by_grad:
            reg = rp * jnp.maximum(
                jnp.linalg.norm(cu),
                jnp.asarray(cfg.reg_scale_floor, cu.dtype),
            )
        else:
            reg = rp
        fused = make_fused_iter(ocp)
        (temp_x, temp_u, cost, nc_raw, max_c, pred, bwd_feasible,
         Hu_norm) = fused(x, u, bp, reg)
        new_cost = jnp.where(max_c <= 0.0, nc_raw, jnp.inf)
        return cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost

    cost = ocp.total_cost(x, u, bp)
    d = compute_first_order(ocp, x, u, bp)
    costates = _costates(ocp, x[-1], d, cfg)
    lin = compute_hamiltonian_lqr(ocp, x, u, costates, bp)
    dx, du, pred, bwd_feasible, Hu = par_newton_step(ocp, x, d, rp, lin, cfg)
    Hu_norm = jnp.max(jnp.abs(Hu))
    temp_x = x + dx
    temp_u = u + du
    new_cost = jnp.where(
        check_feasibility(ocp, temp_x, temp_u),
        ocp.total_cost(temp_x, temp_u, bp),
        jnp.inf,
    )
    return cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost


def _newton_stage_par_single(ocp: OCP, controls, initial_state, bp,
                             cfg: SolverConfig):
    """One barrier stage, parallel evaluator, single-trial globalization.

    Same Newton step as :func:`_newton_stage_par`, but one trial per
    iteration with explicit accept/reject (the structure of the reference's
    sequential solver, seq:108-177) — no inner retry loop, so vmapped lanes
    never pay lockstep retries.
    """
    dtype = controls.dtype
    states = rollout(ocp.dynamics, controls, initial_state)
    start_ok = jnp.isfinite(ocp.total_cost(states, controls, bp))
    init_norm = jnp.where(start_ok, jnp.asarray(1.0, dtype),
                          jnp.asarray(jnp.nan, dtype))
    tol = jnp.maximum(
        jnp.asarray(cfg.tol, dtype), cfg.stage_tol_scale * bp
    )

    def body(val):
        x, u, t, rp, r_inc, _ = val
        cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost = (
            _trial_eval(ocp, x, u, bp, rp, cfg)
        )
        rho = gain_ratio(new_cost, cost, pred)
        accept = jnp.logical_and(rho > 0.0, bwd_feasible)
        stalled = jnp.logical_and(
            jnp.logical_not(accept), rp >= cfg.reg_max
        ) & bool(cfg.stall_exit)
        rp, r_inc = lm_update(rp, r_inc, rho, accept, cfg)
        x = jnp.where(accept, temp_x, x)
        u = jnp.where(accept, temp_u, u)
        Hu_norm = jnp.where(stalled, jnp.asarray(jnp.nan, dtype), Hu_norm)
        if cfg.pred_floor > 0.0:
            # Negligible predicted reduction at a convex step: numerically
            # stationary for this precision — signal convergence.
            tiny = jnp.logical_and(
                bwd_feasible,
                jnp.abs(pred) < cfg.pred_floor * (1.0 + jnp.abs(cost)),
            )
            Hu_norm = jnp.where(tiny, jnp.zeros((), dtype), Hu_norm)
        return x, u, t + 1, rp, r_inc, Hu_norm

    def cond(val):
        _, _, t, _, _, Hu_norm = val
        done = jnp.logical_or(Hu_norm < tol, t > cfg.max_newton_iters)
        done = jnp.logical_or(done, jnp.logical_not(jnp.isfinite(Hu_norm)))
        return jnp.logical_not(done)

    x, u, iters, _, _, _ = lax.while_loop(
        cond,
        body,
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


class FlatLane(NamedTuple):
    """Per-scenario state of a flat-mode IP solve (one while-loop lane).

    Shared between the flat barrier driver (:func:`_newton_flat_single`) and
    the streaming batched executor (solvers/stream.py), which refills
    finished lanes with fresh scenarios from a pool.
    """

    x0: jax.Array        # (nx,) scenario initial state
    x: jax.Array         # (T+1, nx) current trajectory
    u: jax.Array         # (T, nu) current controls
    u_prev: jax.Array    # (T, nu) previous stage's converged controls
    it: jax.Array        # i32 total Newton iterations on this scenario
    stage_it: jax.Array  # i32 iterations within the current barrier stage
    rp: jax.Array        # LM regularization
    r_inc: jax.Array     # LM growth factor
    bp: jax.Array        # barrier parameter
    bp0: jax.Array       # the lane's STARTING barrier parameter (predictor gate)
    done: jax.Array      # bool — solve complete (u holds the solution)


def _lane_transition(ocp: OCP, u, up, x0, bp):
    """Two-candidate stage transition: rollouts and barrier costs of the
    plain warm start ``u`` and the central-path prediction ``up``."""
    xa = rollout(ocp.dynamics, u, x0)
    xb = rollout(ocp.dynamics, up, x0)
    return xa, xb, ocp.total_cost(xa, u, bp), ocp.total_cost(xb, up, bp)


def flat_lane_init(ocp: OCP, controls, initial_state, cfg: SolverConfig,
                   bp0=None, rp0=None) -> FlatLane:
    """Open a flat-mode solve: rollout + non-finite warm-start guard.

    ``bp0``/``rp0`` optionally override ``cfg.bp_init``/``cfg.reg_init`` per
    lane (the multigrid stream re-enters the barrier schedule at a smaller
    bp with light LM damping for scenarios with a feasible interpolated
    warm start, while infeasible ones keep the cold-start settings,
    solvers/stream.py)."""
    dtype = controls.dtype
    if bp0 is None:
        bp0 = jnp.asarray(cfg.bp_init, dtype)
    if rp0 is None:
        rp0 = jnp.asarray(cfg.reg_init, dtype)
    x0_traj = rollout(ocp.dynamics, controls, initial_state)
    start_ok = jnp.isfinite(
        ocp.total_cost(x0_traj, controls, bp0)
    )
    return FlatLane(
        x0=initial_state,
        x=x0_traj,
        u=controls,
        u_prev=controls,
        it=jnp.asarray(0, jnp.int32),
        stage_it=jnp.asarray(0, jnp.int32),
        rp=jnp.asarray(rp0, dtype),
        r_inc=jnp.asarray(cfg.reg_inc_init, dtype),
        bp=jnp.asarray(bp0, dtype),
        bp0=jnp.asarray(bp0, dtype),
        done=jnp.logical_not(start_ok),
    )


def flat_lane_iter(ocp: OCP, lane: FlatLane, cfg: SolverConfig,
                   adv=None) -> FlatLane:
    """One Newton iteration (plus any stage transition) of a flat-mode solve.

    Per lane this replays exactly the staged single-trial solve
    (:func:`_newton_stage_par_single` under :func:`barrier_loop`): the same
    trial sequence, the same per-stage regularization resets, the same
    rollout at each stage start, the same stage tolerances.  Callers must
    only apply it to lanes with ``done == False`` — or pass ``adv`` (scalar
    bool per lane): with ``adv=False`` the lane is returned EXACTLY
    unchanged, the mask folded into the iteration's own selects so batched
    callers need no separate whole-tree lane select on top (the streaming
    executor's inner step previously paid a second full (x, u, u_prev)
    select per iteration just to freeze finished lanes).

    One (documented) deviation from the staged driver: a lane whose
    cost/gradient goes non-finite is retired immediately instead of burning
    one no-op stage per remaining barrier value.
    """
    x, u, bp = lane.x, lane.u, lane.bp
    rp, r_inc = lane.rp, lane.r_inc
    dtype = u.dtype
    if adv is None:
        adv = jnp.asarray(True)
    cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost = (
        _trial_eval(ocp, x, u, bp, rp, cfg)
    )
    rho = gain_ratio(new_cost, cost, pred)
    accept = jnp.logical_and(rho > 0.0, bwd_feasible)
    stalled = jnp.logical_and(
        jnp.logical_not(accept), rp >= cfg.reg_max
    ) & bool(cfg.stall_exit)
    rp_new, r_inc_new = lm_update(rp, r_inc, rho, accept, cfg)
    rp = jnp.where(adv, rp_new, rp)
    r_inc = jnp.where(adv, r_inc_new, r_inc)
    accept = jnp.logical_and(accept, adv)
    x = jnp.where(accept, temp_x, x)
    u = jnp.where(accept, temp_u, u)

    tol_s = jnp.maximum(jnp.asarray(cfg.tol, dtype),
                        cfg.stage_tol_scale * bp)
    conv = Hu_norm < tol_s
    if cfg.pred_floor > 0.0:
        conv = jnp.logical_or(
            conv,
            jnp.logical_and(
                bwd_feasible,
                jnp.abs(pred) < cfg.pred_floor * (1.0 + jnp.abs(cost)),
            ),
        )
    bad = jnp.logical_or(
        jnp.logical_not(jnp.isfinite(Hu_norm)),
        jnp.logical_not(jnp.isfinite(cost)),
    )
    bad = jnp.logical_and(bad, adv)
    # Stage ends on convergence, stall, or the per-stage iteration cap
    # (staged parity: _newton_stage_par_single runs while t <= cap).
    advance = jnp.logical_or(
        jnp.logical_or(conv, stalled), lane.stage_it + 1 > cfg.max_newton_iters
    )
    advance = jnp.logical_and(advance, jnp.logical_not(bad))
    advance = jnp.logical_and(advance, adv)
    bp_next = bp / cfg.bp_decay
    done_now = jnp.logical_or(
        bad, jnp.logical_and(advance, bp_next <= cfg.bp_min)
    )
    # Stage transition: decay bp, reset the LM state, re-rollout the
    # nonlinear trajectory from the warm-started controls (staged parity:
    # each stage opens with `rollout`, par:133).
    roll = jnp.logical_and(advance, jnp.logical_not(done_now))
    u_prev = jnp.where(roll, u, lane.u_prev)
    if cfg.stage_predictor:
        # Continuation predictor (SolverConfig.stage_predictor): extrapolate
        # the central path, keep whichever candidate has the lower barrier
        # cost at the new bp.  NaN/Inf predicted cost (infeasible or
        # diverging rollout) loses every comparison; the plain warm start is
        # feasible by construction (feasibility is bp-independent).
        gamma = jnp.asarray(1.0 / cfg.bp_decay, dtype)
        u_pred = u + gamma * (u - lane.u_prev)
        x_plain, x_pred, c_plain, c_pred = _lane_transition(
            ocp, u, u_pred, lane.x0, bp_next
        )
        # Only from the second transition on: at the first, u_prev is the
        # initial guess, which is not a central-path point.  Compare against
        # the LANE's starting bp (not cfg.bp_init): lanes opened with a
        # per-lane bp0 override (multigrid fine re-entry) would otherwise
        # fire the predictor on their first transition against the
        # interpolated warm start.
        on_path = bp < lane.bp0
        take = jnp.logical_and(
            roll, jnp.logical_and(on_path, c_pred < c_plain)
        )
        x = jnp.where(take, x_pred, jnp.where(roll, x_plain, x))
        u = jnp.where(take, u_pred, u)
    else:
        x = jnp.where(roll, rollout(ocp.dynamics, u, lane.x0), x)
    bp = jnp.where(advance, bp_next, bp)
    stage_reg = (cfg.reg_init if cfg.reg_stage_init is None
                 else cfg.reg_stage_init)
    rp = jnp.where(advance, jnp.asarray(stage_reg, dtype), rp)
    r_inc = jnp.where(advance, jnp.asarray(cfg.reg_inc_init, dtype), r_inc)
    tick = adv.astype(jnp.int32)
    stage_it = jnp.where(advance, jnp.asarray(0, jnp.int32),
                         lane.stage_it + tick)
    return FlatLane(
        x0=lane.x0, x=x, u=u, u_prev=u_prev, it=lane.it + tick,
        stage_it=stage_it,
        rp=rp, r_inc=r_inc, bp=bp, bp0=lane.bp0,
        done=jnp.logical_or(lane.done, done_now),
    )


def flat_total_cap(cfg: SolverConfig) -> int:
    """Upper bound on flat-mode iterations (staged parity: every stage may
    run to its cap)."""
    return n_barrier_stages(cfg) * (cfg.max_newton_iters + 1)


def _newton_flat_single(ocp: OCP, controls, initial_state, cfg: SolverConfig):
    """Whole IP solve as ONE while_loop: the barrier parameter is per-lane
    loop state (cfg.barrier_mode="flat").

    The payoff is under ``vmap``: stage transitions no longer synchronize
    across lanes, so a batch pays ``max_lanes(total iterations)`` in lockstep
    instead of ``sum_stages max_lanes(stage iterations)`` — a pure
    tail-latency win for the batched-throughput path.
    See :func:`flat_lane_iter` for the per-iteration semantics.
    """
    total_cap = jnp.asarray(flat_total_cap(cfg), jnp.int32)

    def body(lane):
        return flat_lane_iter(ocp, lane, cfg)

    def cond(lane):
        return jnp.logical_and(jnp.logical_not(lane.done), lane.it < total_cap)

    lane = lax.while_loop(
        cond, body, flat_lane_init(ocp, controls, initial_state, cfg)
    )
    return lane.u, lane.it


def par_interior_point_optimal_control(
    ocp: OCP, controls, initial_state, cfg: SolverConfig = DEFAULT_CONFIG
):
    """Parallel-in-time interior-point Newton solve — the flagship entry point.

    Same signature and return convention as the reference
    (par_interior_point_newton.py:228-254): returns
    ``(optimal_controls, total_newton_iterations)``.
    """
    if cfg.barrier_mode == "flat":
        if cfg.globalization != "single":
            raise ValueError(
                "barrier_mode='flat' requires globalization='single' "
                "(the retry loop is itself a lockstep barrier under vmap)"
            )
        return _newton_flat_single(ocp, controls, initial_state, cfg)

    stage_fn = (
        _newton_stage_par_single
        if cfg.globalization == "single"
        else _newton_stage_par
    )

    def stage(u, bp):
        _, u, iters = stage_fn(ocp, u, initial_state, bp, cfg)
        return u, iters

    return barrier_loop(stage, controls, cfg)


# ---------------------------------------------------------------------------
# Sequential Newton solver (validation spine)
# ---------------------------------------------------------------------------


def seq_bwd_newton(final_cost, xN, lin: LinearizedOCP, d: Derivatives, rp):
    """Sequential Riccati backward pass on Newton stage data.

    Reference seq_interior_point_newton.py:42-75, with Cholesky solves in
    place of explicit inverses and a Cholesky-success convexity flag in place
    of ``eigh``.  Terminal condition: ``Vxx = hessian(final_cost)(xN)``,
    ``Vx = 0`` — the costates carry the gradient part (seq:66-67).
    """

    def step(carry, inp):
        Vxx, Vx = carry
        r, Q, R, M, fx, fu = inp
        fxT, fuT = fx.T, fu.T

        Qxx = Q + fxT @ Vxx @ fx
        Quu = R + fuT @ Vxx @ fu + rp * jnp.eye(R.shape[0], dtype=R.dtype)
        Qxu = M + fxT @ Vxx @ fu
        Qu = r + fuT @ Vx
        Qx = fxT @ Vx

        convex = linalg.is_posdef(Quu)
        # One factorization for both gains: Quu [k | K] = -[Qu | Qxu^T].
        sol = linalg.cholesky_solve(
            Quu, jnp.concatenate([Qu[:, None], Qxu.T], axis=1)
        )
        k = -sol[:, 0]
        K = -sol[:, 1:]

        Vx_new = Qx + Qxu @ k
        Vxx_new = linalg.sym(Qxx + Qxu @ K)
        dV = k @ Qu + 0.5 * k @ (Quu @ k)
        return (Vxx_new, Vx_new), (K, k, dV, convex)

    VxxN = hessian(final_cost)(xN)
    VxN = jnp.zeros_like(xN)
    _, (K, k, dV, convex) = lax.scan(
        step, (VxxN, VxN), (lin.r, lin.Q, lin.R, lin.M, d.fx, d.fu),
        reverse=True,
    )
    return K, k, jnp.sum(dV), jnp.all(convex)


def seq_fwd_newton(K, k, d: Derivatives):
    """Linear deviation rollout (reference seq:78-90): ``dx0 = 0``,
    ``dx+ = (fx + fu K) dx + fu k``, ``du = K dx + k``."""
    dx0 = jnp.zeros((K.shape[-1],), dtype=K.dtype)

    def step(dx, inp):
        K_t, k_t, fx, fu = inp
        dx_next = (fx + fu @ K_t) @ dx + fu @ k_t
        return dx_next, dx_next

    _, dxs = lax.scan(step, dx0, (K, k, d.fx, d.fu))
    dx = jnp.concatenate([dx0[None], dxs], axis=0)
    du = jnp.einsum("tij,tj->ti", K, dx[:-1]) + k
    return du, dx


def _newton_stage_seq(ocp: OCP, controls, initial_state, bp, cfg: SolverConfig):
    """One barrier stage of the sequential Newton method (reference seq:108-177):
    a single while loop with one trial step per iteration and explicit
    accept/reject via ``jnp.where``."""
    dtype = controls.dtype
    states = rollout(ocp.dynamics, controls, initial_state)
    # Infeasible / non-finite warm start: refuse to iterate (see par stage).
    start_ok = jnp.isfinite(ocp.total_cost(states, controls, bp))
    init_norm = jnp.where(start_ok, jnp.asarray(1.0, dtype),
                          jnp.asarray(jnp.nan, dtype))

    def body(val):
        x, u, t, mu, nu_, _, _ = val
        cost = ocp.total_cost(x, u, bp)

        d = compute_first_order(ocp, x, u, bp)
        costates = seq_costates(ocp, x[-1], d)
        lin = compute_hamiltonian_lqr(ocp, x, u, costates, bp)
        K, k, pred, bp_feasible = seq_bwd_newton(
            ocp.final_cost, x[-1], lin, d, mu
        )
        du, dx = seq_fwd_newton(K, k, d)
        Hu_norm = jnp.max(jnp.abs(lin.r))

        temp_x = x + dx
        temp_u = u + du
        new_cost = jnp.where(
            check_feasibility(ocp, temp_x, temp_u),
            ocp.total_cost(temp_x, temp_u, bp),
            jnp.inf,
        )
        rho = gain_ratio(new_cost, cost, pred)
        accept = jnp.logical_and(rho > 0, bp_feasible)
        # Stall: rejected at maximum regularization (cfg.stall_exit) — signal
        # the loop exit via a NaN gradient norm.
        stalled = jnp.logical_and(
            jnp.logical_not(accept), mu >= cfg.reg_max
        ) & bool(cfg.stall_exit)
        mu, nu_ = lm_update(mu, nu_, rho, accept, cfg)
        x = jnp.where(accept, temp_x, x)
        u = jnp.where(accept, temp_u, u)
        Hu_norm = jnp.where(stalled, jnp.asarray(jnp.nan, dtype), Hu_norm)
        return x, u, t + 1, mu, nu_, Hu_norm, bp_feasible

    tol = jnp.maximum(
        jnp.asarray(cfg.tol, dtype), cfg.stage_tol_scale * bp
    )

    def cond(val):
        _, _, t, _, _, Hu_norm, bp_feasible = val
        converged = jnp.logical_and(Hu_norm < tol, bp_feasible)
        # The reference seq solver has no cap (seq:157-161); we bound it,
        # and bail on non-finite gradients (robustness guard).
        stop = jnp.logical_or(converged, t >= cfg.max_newton_iters)
        stop = jnp.logical_or(stop, jnp.logical_not(jnp.isfinite(Hu_norm)))
        return jnp.logical_not(stop)

    x, u, iters, _, _, _, _ = lax.while_loop(
        cond,
        body,
        (
            states,
            controls,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(cfg.reg_init, dtype),
            jnp.asarray(cfg.reg_inc_init, dtype),
            init_norm,
            jnp.bool_(True),
        ),
    )
    return x, u, iters


def seq_interior_point_optimal_control(
    ocp: OCP, controls, initial_state, cfg: SolverConfig = DEFAULT_CONFIG
):
    """Sequential interior-point Newton solve (validation path).

    Reference entry point: seq_interior_point_newton.py:180-202.
    """

    def stage(u, bp):
        _, u, iters = _newton_stage_seq(ocp, u, initial_state, bp, cfg)
        return u, iters

    return barrier_loop(stage, controls, cfg)
