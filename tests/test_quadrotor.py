"""Planar quadrotor (nx=6, nu=2): the first multi-input model — exercises
nu > 1 through the solvers and every kernel path (the reference's problems
are all single-input; SURVEY §2.7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import quadrotor
from ipoc_tpu.solvers.batched import make_batch, solve_batch
from ipoc_tpu.utils.integrators import rollout

DT, H = 0.05, 40


@pytest.fixture(scope="module")
def solved():
    ocp = quadrotor.make_ocp(DT)
    x0 = quadrotor.initial_state(jnp.float64)
    u0 = quadrotor.hover_controls(H, jnp.float64)
    u, iters = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
            ocp, u, x, ipoc_tpu.FAST_CONFIG)
    )(u0, x0)
    return ocp, x0, u0, u, iters


def test_converges_to_goal(solved):
    ocp, x0, _, u, iters = solved
    assert int(iters) > 0
    X = rollout(ocp.dynamics, u, x0)
    np.testing.assert_allclose(np.asarray(X[-1, :2]), [1.0, 1.0], atol=0.02)


def test_thrust_box_active_and_respected(solved):
    _, _, _, u, _ = solved
    u = np.asarray(u)
    assert u.min() > quadrotor.F_MIN
    assert u.max() < quadrotor.F_MAX
    assert u.max() > 0.9 * quadrotor.F_MAX  # the box binds (transient)


def test_cross_solver_agreement(solved):
    ocp, x0, u0, u_par, _ = solved
    u_seq, _ = jax.jit(
        lambda u, x: ipoc_tpu.seq_interior_point_optimal_control(
            ocp, u, x, ipoc_tpu.FAST_CONFIG)
    )(u0, x0)
    u_ddp, _ = jax.jit(
        lambda u, x: ipoc_tpu.interior_point_ddp(
            ocp, u, x, ipoc_tpu.FAST_CONFIG)
    )(u0, x0)
    np.testing.assert_allclose(np.asarray(u_seq), np.asarray(u_par),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(u_ddp), np.asarray(u_par),
                               atol=2e-3)


@pytest.mark.slow
def test_fused_kernel_interpret_nu2():
    """The fused-iteration kernel handles nu=2 / nx=6 (interpret mode)."""
    from ipoc_tpu.ops.pallas.fused_iter_kernel import (
        _fused_reference,
        fused_newton_iter_batched,
    )

    T, B = 16, 3
    ocp = quadrotor.make_ocp(DT)
    x0 = quadrotor.initial_state(jnp.float32)
    u0 = jnp.broadcast_to(quadrotor.hover_controls(T, jnp.float32),
                          (B, T, 2))
    u0 = u0 + 0.1 * jax.random.normal(jax.random.PRNGKey(0), u0.shape,
                                      jnp.float32)
    x0b = jnp.broadcast_to(x0, (B, 6)) + 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), (B, 6), jnp.float32)
    X = jax.vmap(lambda u, x: rollout(ocp.dynamics, u, x))(u0, x0b)
    bp = jnp.full((B,), 0.1, jnp.float32)
    reg = jnp.full((B,), 3.0, jnp.float32)
    with jax.enable_x64(False):
        ker = fused_newton_iter_batched(ocp, X, u0, bp, reg, block_lanes=4,
                                        interpret=True)
        ref = jax.vmap(lambda x, u, b, r: _fused_reference(ocp, x, u, b, r)
                       )(X, u0, bp, reg)
    for nm, a, b in zip(
        ["temp_x", "temp_u", "cost", "new_cost", "max_c", "pred", "ok",
         "hu"], ker, ref,
    ):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                       err_msg=nm)


def test_batched_fused_solver_nu2():
    """Batched flat-mode solve with newton_impl='fused' (CPU fallback) on
    the multi-input model matches the 'seq' evaluator bit-for-bit."""
    ocp = quadrotor.make_ocp(DT)
    x0 = quadrotor.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(7), x0, 3, 24, 2,
        state_scale=0.02, control_scale=0.0, dtype=jnp.float64,
    )
    u0 = u0 + quadrotor.HOVER
    cfg = ipoc_tpu.FAST_CONFIG.replace(
        globalization="single", barrier_mode="flat")
    s_seq = jax.jit(lambda u, x: solve_batch(
        ocp, u, x, cfg.replace(newton_impl="seq")))(u0, x0b)
    s_fus = jax.jit(lambda u, x: solve_batch(
        ocp, u, x, cfg.replace(newton_impl="fused")))(u0, x0b)
    np.testing.assert_array_equal(np.asarray(s_seq.iterations),
                                  np.asarray(s_fus.iterations))
    np.testing.assert_array_equal(np.asarray(s_seq.controls),
                                  np.asarray(s_fus.controls))
