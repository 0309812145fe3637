"""Solver-level tests: analytic LQR oracle, cross-solver agreement,
constraint satisfaction, robustness (SURVEY §4 test strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import double_integrator, pendulum
from ipoc_tpu.utils.integrators import rollout


@pytest.fixture(scope="module")
def linear_problem():
    ocp = double_integrator.make_ocp(0.1)
    x0 = jnp.array([2.0, 1.0])
    u0 = jnp.zeros((40, 1))
    return ocp, u0, x0


@pytest.fixture(scope="module")
def pendulum_problem():
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (50, 1))
    return ocp, u0, x0


def _riccati_lqr_oracle(ocp, H, x0):
    """Closed-form discrete LQR via backward Riccati on the exact
    linearization (the dynamics are linear, so this is the global optimum)."""
    A = jax.jacfwd(ocp.dynamics, 0)(x0, jnp.zeros(1))
    B = jax.jacfwd(ocp.dynamics, 1)(x0, jnp.zeros(1))
    Q = np.diag(double_integrator.STATE_WEIGHTS).astype(np.float64)
    R = np.array([[double_integrator.ACTION_WEIGHT]])
    P = Q.copy()
    Ks = []
    for _ in range(H):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ A - A.T @ P @ B @ K
        Ks.append(K)
    Ks = Ks[::-1]
    x = np.asarray(x0)
    us = []
    for K in Ks:
        u = -K @ x
        us.append(u)
        x = np.asarray(A) @ x + np.asarray(B) @ u
    return np.stack(us)


def test_linear_matches_lqr_oracle(linear_problem):
    """Unconstrained LQR: the Newton method must find the closed-form
    optimum (linear_demo_cuda semantics, SURVEY §4 item 3)."""
    ocp, u0, x0 = linear_problem
    u_star = _riccati_lqr_oracle(ocp, 40, x0)
    u, iters = ipoc_tpu.par_interior_point_optimal_control(ocp, u0, x0)
    np.testing.assert_allclose(np.asarray(u), u_star, atol=1e-6)
    assert int(iters) <= 15  # Newton on a quadratic: ~1 iter per barrier stage


def test_linear_three_solver_agreement(linear_problem):
    ocp, u0, x0 = linear_problem
    u_par, _ = ipoc_tpu.par_interior_point_optimal_control(ocp, u0, x0)
    u_seq, _ = ipoc_tpu.seq_interior_point_optimal_control(ocp, u0, x0)
    u_ddp, _ = ipoc_tpu.interior_point_ddp(ocp, u0, x0)
    np.testing.assert_allclose(u_par, u_seq, atol=1e-5)
    np.testing.assert_allclose(u_par, u_ddp, atol=1e-5)


@pytest.mark.smoke
def test_pendulum_three_solver_agreement(pendulum_problem):
    """Cross-method agreement on a constrained nonlinear problem
    (SURVEY §4 item 2)."""
    ocp, u0, x0 = pendulum_problem
    u_par, it_par = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(ocp, u, x)
    )(u0, x0)
    u_seq, _ = jax.jit(
        lambda u, x: ipoc_tpu.seq_interior_point_optimal_control(ocp, u, x)
    )(u0, x0)
    u_ddp, _ = jax.jit(
        lambda u, x: ipoc_tpu.interior_point_ddp(ocp, u, x)
    )(u0, x0)
    assert int(it_par) > 0
    np.testing.assert_allclose(u_par, u_ddp, atol=1e-4)
    # At the loose default tol=1e-4 the seq solver may stop in a slightly
    # different spot along flat directions; test_pendulum_par_seq_tight_tol
    # asserts 1e-4 agreement at tol=1e-7.
    np.testing.assert_allclose(u_par, u_seq, atol=2e-2)


def test_pendulum_par_seq_tight_tol(pendulum_problem):
    """At tight tolerance the two Newton evaluators converge to the same
    point (the associative-scan pass is exact, SURVEY §4 item 1)."""
    ocp, u0, x0 = pendulum_problem
    cfg = ipoc_tpu.SolverConfig(tol=1e-7)
    u_par, _ = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(ocp, u, x, cfg)
    )(u0, x0)
    u_seq, _ = jax.jit(
        lambda u, x: ipoc_tpu.seq_interior_point_optimal_control(ocp, u, x, cfg)
    )(u0, x0)
    np.testing.assert_allclose(u_par, u_seq, atol=1e-4)


def test_constraints_respected(pendulum_problem):
    ocp, u0, x0 = pendulum_problem
    u, _ = ipoc_tpu.par_interior_point_optimal_control(ocp, u0, x0)
    assert float(jnp.abs(u).max()) <= pendulum.CONTROL_BOUND
    # strictly interior (log barrier keeps iterates off the boundary)
    assert float(jnp.abs(u).max()) < pendulum.CONTROL_BOUND


def test_stationarity_at_solution(pendulum_problem):
    """|grad_u H|_inf < tol at the returned solution for the final barrier."""
    from ipoc_tpu.ops.derivatives import compute_derivatives, compute_lqr_params
    from ipoc_tpu.parallel.costates import seq_costates

    ocp, u0, x0 = pendulum_problem
    u, _ = ipoc_tpu.par_interior_point_optimal_control(ocp, u0, x0)
    x = rollout(ocp.dynamics, u, x0)
    bp_final = 0.1 / 5**4  # last barrier stage actually solved
    d = compute_derivatives(ocp, x, u, bp_final)
    lam = seq_costates(ocp, x[-1], d)
    lin = compute_lqr_params(lam, d)
    assert float(jnp.abs(lin.r).max()) < 1e-4


def test_infeasible_warm_start_returns_input(pendulum_problem):
    """Robustness guard: NaN-cost starts exit in 0 iterations unchanged."""
    ocp, _, x0 = pendulum_problem
    u_bad = 10.0 * jnp.ones((50, 1))
    for solver in (
        ipoc_tpu.par_interior_point_optimal_control,
        ipoc_tpu.seq_interior_point_optimal_control,
        ipoc_tpu.interior_point_ddp,
    ):
        u, iters = solver(ocp, u_bad, x0)
        assert int(iters) == 0
        np.testing.assert_array_equal(np.asarray(u), np.asarray(u_bad))


def test_terminal_hessian_quirk_mode(pendulum_problem):
    """The reference-quirk terminal weight (par:74) still converges to a
    stationary point of the same barrier problem."""
    ocp, u0, x0 = pendulum_problem
    cfg = ipoc_tpu.SolverConfig(terminal_hessian="reference")
    u_q, it_q = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(ocp, u, x, cfg)
    )(u0, x0)
    u_e, _ = ipoc_tpu.par_interior_point_optimal_control(ocp, u0, x0)
    assert int(it_q) > 0
    np.testing.assert_allclose(u_q, u_e, atol=2e-2)


def test_f32_solve_finite(pendulum_problem):
    """The accelerator dtype path (f32) converges NaN-free."""
    ocp, u0, x0 = pendulum_problem
    u32, it = ipoc_tpu.par_interior_point_optimal_control(
        ocp, u0.astype(jnp.float32), x0.astype(jnp.float32),
        ipoc_tpu.FAST_CONFIG,
    )
    assert u32.dtype == jnp.float32
    assert bool(jnp.all(jnp.isfinite(u32)))
    assert float(jnp.abs(u32).max()) <= pendulum.CONTROL_BOUND


def test_zero_warm_start_with_reg_floor(pendulum_problem):
    """A zero warm start makes cu vanish identically (R u = 0, symmetric
    barrier gradients cancel), which multiplies the reference's
    ||cu||-scaled regularization to zero and wedges the stage.  The
    reg_scale_floor in the FAST/BATCH presets restores LM behavior; the
    pure-parity DEFAULT_CONFIG instead stall-exits quickly and returns the
    input."""
    ocp, _, x0 = pendulum_problem
    u0 = jnp.zeros((50, 1))
    u, iters = ipoc_tpu.par_interior_point_optimal_control(
        ocp, u0, x0, ipoc_tpu.FAST_CONFIG
    )
    assert float(jnp.abs(u).max()) > 1.0  # actually solved the swing-up
    assert float(jnp.abs(u).max()) < 5.0
    # parity config: bounded exit, input returned unchanged
    u_d, it_d = ipoc_tpu.par_interior_point_optimal_control(ocp, u0, x0)
    assert int(it_d) <= 10
    np.testing.assert_array_equal(np.asarray(u_d), np.asarray(u0))


@pytest.mark.smoke
def test_flat_barrier_matches_staged(pendulum_problem):
    """barrier_mode='flat' replays the staged single-trial solve per lane:
    same controls, same total iteration count."""
    ocp, u0, x0 = pendulum_problem
    cfg = ipoc_tpu.DEFAULT_CONFIG.replace(globalization="single")
    u_staged, it_staged = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
            ocp, u, x, cfg
        )
    )(u0, x0)
    u_flat, it_flat = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
            ocp, u, x, cfg.replace(barrier_mode="flat")
        )
    )(u0, x0)
    np.testing.assert_allclose(np.asarray(u_flat), np.asarray(u_staged),
                               rtol=0, atol=1e-12)
    assert int(it_flat) == int(it_staged)


@pytest.mark.slow
def test_flat_barrier_batched(pendulum_problem):
    """Flat mode under vmap: per-lane results match per-lane staged solves."""
    from ipoc_tpu.solvers.batched import make_batch, solve_batch

    ocp, _, x0 = pendulum_problem
    cfg = ipoc_tpu.DEFAULT_CONFIG.replace(
        globalization="single", max_newton_iters=150
    )
    u0, x0b = make_batch(jax.random.PRNGKey(3), x0, 2, 30, 1,
                         state_scale=0.05, dtype=jnp.float64)
    sol_flat = solve_batch(ocp, u0, x0b, cfg.replace(barrier_mode="flat"))
    for i in range(2):
        u_i, it_i = ipoc_tpu.par_interior_point_optimal_control(
            ocp, u0[i], x0b[i], cfg
        )
        np.testing.assert_allclose(np.asarray(sol_flat.controls[i]),
                                   np.asarray(u_i), rtol=0, atol=1e-10)
        assert int(sol_flat.iterations[i]) == int(it_i)


def test_flat_barrier_requires_single():
    ocp = pendulum.make_ocp(0.02)
    with pytest.raises(ValueError):
        ipoc_tpu.par_interior_point_optimal_control(
            ocp, jnp.zeros((10, 1)), jnp.zeros(2),
            ipoc_tpu.DEFAULT_CONFIG.replace(barrier_mode="flat"),
        )
