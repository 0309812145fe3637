"""Coarse-to-fine (multigrid-in-time) streaming solve tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import pendulum
from ipoc_tpu.solvers.batched import make_batch
from ipoc_tpu.solvers.stream import solve_stream, solve_stream_multigrid
from ipoc_tpu.utils.integrators import rollout

CFG = ipoc_tpu.BATCH_CONFIG


def _setup(n=6, T=40):
    ocp = pendulum.make_ocp(1.0 / T)
    ocp_c = pendulum.make_ocp(4.0 / T)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(7), x0, n, T, 1,
        state_scale=0.05, control_scale=0.1, dtype=jnp.float64,
    )
    return ocp, ocp_c, u0, x0b


@pytest.mark.smoke
def test_multigrid_matches_single_grid_optimum():
    """Multigrid solutions satisfy the same final-stage criteria: raw costs
    match the single-grid stream (pendulum swing-up is basin-stable)."""
    ocp, ocp_c, u0, x0b = _setup()
    ref = jax.jit(lambda u, x: solve_stream(ocp, u, x, CFG, lanes=3))(
        u0, x0b)
    mg = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, CFG, lanes=3))(u0, x0b)

    def raw_cost(u, x0s):
        x = rollout(ocp.dynamics, u, x0s)
        return ocp.total_cost(x, u, 1e-9)

    c_ref = np.asarray(jax.jit(jax.vmap(raw_cost))(ref.controls, x0b))
    c_mg = np.asarray(jax.jit(jax.vmap(raw_cost))(mg.controls, x0b))
    np.testing.assert_allclose(c_mg, c_ref, rtol=1e-4)
    assert np.isfinite(np.asarray(mg.controls)).all()
    # the fine level must do less work than the single grid (the big wins
    # show on cold-start cartpole H=100; this tiny f64 pendulum only checks
    # the mechanism end-to-end)
    assert (np.asarray(mg.iterations).mean()
            < np.asarray(ref.iterations).mean())


def test_multigrid_infeasible_warmstart_falls_back():
    """A scenario whose interpolated coarse start is infeasible on the fine
    grid must fall back to the original controls + full schedule (exercised
    here by making EVERY coarse solution infeasible via a doctored fine
    OCP whose bound is tighter than the coarse one)."""
    ocp, _, u0, x0b = _setup()
    # Coarse problem with a LOOSER bound: its solutions ride |u|<=5, which
    # violates the fine problem's |u|<=2.5 box whenever the bound is active.
    from ipoc_tpu.problem import barrier_ocp
    from ipoc_tpu.utils.integrators import euler

    T = u0.shape[1]
    ocp_loose = pendulum.make_ocp(4.0 / T)

    def tight_constraints(state, control):
        return jnp.concatenate([control - 2.5, -control - 2.5])

    ocp_tight = barrier_ocp(
        euler(pendulum.ode, 1.0 / T), tight_constraints,
        pendulum.stage_cost, pendulum.final_cost,
    )
    mg = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp_tight, ocp_loose, 4, u, x, CFG, lanes=3))(u0, x0b)
    ref = jax.jit(lambda u, x: solve_stream(ocp_tight, u, x, CFG, lanes=3))(
        u0, x0b)
    # fallback scenarios replay the plain cold solve exactly
    it_mg = np.asarray(mg.iterations)
    it_ref = np.asarray(ref.iterations)
    u_mg = np.asarray(mg.controls)
    u_ref = np.asarray(ref.controls)
    fell_back = it_mg == it_ref
    assert fell_back.any()
    np.testing.assert_allclose(u_mg[fell_back], u_ref[fell_back],
                               rtol=1e-12, atol=1e-12)


def test_multigrid_rejects_bad_horizon():
    ocp, ocp_c, u0, x0b = _setup(T=42)
    try:
        solve_stream_multigrid(ocp, ocp_c, 4, u0, x0b, CFG, lanes=3)
    except ValueError as e:
        assert "divisible" in str(e)
    else:
        raise AssertionError("expected ValueError")


@pytest.mark.slow
def test_multigrid_sharded_matches_local():
    """Per-shard multigrid streams over a 2-device mesh reproduce the local
    multigrid solutions (shard-major pool order)."""
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.solvers.stream import solve_stream_multigrid_sharded

    ocp, ocp_c, u0, x0b = _setup(n=6)
    mesh = make_mesh(batch=2)
    sh = jax.jit(lambda u, x: solve_stream_multigrid_sharded(
        ocp, ocp_c, 4, u, x, mesh, CFG, lanes=3))(u0, x0b)
    loc = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, CFG, lanes=3))(u0[:3], x0b[:3])
    np.testing.assert_allclose(np.asarray(sh.controls[:3]),
                               np.asarray(loc.controls),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(sh.iterations[:3]),
                                  np.asarray(loc.iterations))


def test_multigrid_unicycle_state_constraint():
    """Multigrid on the obstacle unicycle: interpolated coarse solutions can
    clip the keep-out disc on the fine grid, so this exercises the
    per-scenario fallback on a REAL state constraint; every output must be
    feasible on the fine grid."""
    from ipoc_tpu.models import unicycle

    T = 40
    ocp = unicycle.make_ocp(2.0 / T)
    ocp_c = unicycle.make_ocp(8.0 / T)
    x0 = unicycle.initial_state(jnp.float64)
    u0 = jnp.concatenate(
        [0.3 * jnp.ones((T, 1), jnp.float64),
         jnp.zeros((T, 1), jnp.float64)], axis=1)
    u0b = jnp.broadcast_to(u0, (4,) + u0.shape)
    x0b = jnp.stack([x0 + jnp.asarray([0.0, dy, 0.0], jnp.float64)
                     for dy in (0.0, 0.02, -0.02, 0.04)])
    mg = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, CFG, lanes=2))(u0b, x0b)
    u = np.asarray(mg.controls)
    assert np.isfinite(u).all()
    for i in range(4):
        x = rollout(ocp.dynamics, mg.controls[i], x0b[i])
        c = np.asarray(jax.vmap(ocp.constraints)(x[:-1], mg.controls[i]))
        assert c.max() <= 0.0, f"lane {i} violates constraints: {c.max()}"


def test_multigrid_cartpole_basin_switch_bound():
    """Pin the multigrid quality caveat with a bound (a few per cent of
    cold-start cartpole H=100 scenarios land in a different local basin
    than the single-grid stream).  On this 32-scenario CPU sample the
    basin-switch fraction must stay <= 4/32 and every basin-matched
    scenario's converged raw cost must agree to 1e-4 relative.  bench.py
    emits the full-pool version of these statistics in its JSON."""
    import pytest

    from ipoc_tpu.models import cartpole
    from ipoc_tpu.solvers.batched import make_batch as _mb

    T = 100
    ocp = cartpole.make_ocp(1.0 / T)
    ocp_c = cartpole.make_ocp(4.0 / T)
    x0 = cartpole.initial_state(jnp.float64)
    u0, x0b = _mb(
        jax.random.PRNGKey(1), x0, 32, T, 1,
        state_scale=0.01, control_scale=0.1, dtype=jnp.float64,
    )
    sg = jax.jit(lambda u, x: solve_stream(ocp, u, x, CFG, lanes=8))(
        u0, x0b)
    mg = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, CFG, lanes=8))(u0, x0b)

    def raw_cost(u, x0s):
        x = rollout(ocp.dynamics, u, x0s)
        return ocp.total_cost(x, u, 1e-9)

    c_sg = np.asarray(jax.jit(jax.vmap(raw_cost))(sg.controls, x0b))
    c_mg = np.asarray(jax.jit(jax.vmap(raw_cost))(mg.controls, x0b))
    rel = np.abs(c_mg - c_sg) / np.abs(c_sg)
    switched = rel > 1e-3
    assert switched.mean() <= 4 / 32
    if (~switched).any():
        assert rel[~switched].max() < 1e-4
