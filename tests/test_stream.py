"""Streaming executor tests: per-scenario results must match the flat-mode
solver exactly (same trial sequences, only lane scheduling differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import cartpole, pendulum, quadrotor
from ipoc_tpu.solvers.batched import make_batch, solve_batch
from ipoc_tpu.solvers.stream import solve_stream

# 3-stage barrier schedule + T=30: the scheduling-equivalence pins are
# schedule-independent, and the fast tier stays fast (VERDICT r2 #8).
CFG = ipoc_tpu.FAST_CONFIG.replace(
    globalization="single", barrier_mode="flat", bp_min=4.1e-3
)


@pytest.fixture(scope="module")
def scenario_pool():
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(3), x0, 7, 30, 1,
        state_scale=0.05, control_scale=0.1, dtype=jnp.float64,
    )
    return ocp, u0, x0b


def _flat_reference(ocp, u0, x0b):
    sol = jax.jit(
        lambda u, x: solve_batch(ocp, u, x, CFG)
    )(u0, x0b)
    return np.asarray(sol.controls), np.asarray(sol.iterations)


@pytest.mark.parametrize("lanes", [
    pytest.param(3, marks=pytest.mark.slow),
    pytest.param(7, marks=pytest.mark.slow),
    16,
])
@pytest.mark.smoke
def test_stream_matches_flat(scenario_pool, lanes):
    """N=7 scenarios through 3 (refilling), 7 (exact), and 16 (clamped to N)
    lanes all reproduce the flat-mode per-scenario solutions."""
    ocp, u0, x0b = scenario_pool
    u_ref, it_ref = _flat_reference(ocp, u0, x0b)
    sol = jax.jit(
        lambda u, x: solve_stream(ocp, u, x, CFG, lanes=lanes)
    )(u0, x0b)
    np.testing.assert_allclose(np.asarray(sol.controls), u_ref,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(sol.iterations), it_ref)


@pytest.mark.parametrize("model", [pendulum, cartpole, quadrotor],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_stream_equals_flat_solver_per_scenario(model):
    """The production stream config (fused evaluator, stage predictor)
    gives every scenario exactly what the flat single solve gives it."""
    nu = 2 if model is quadrotor else 1
    ocp = model.make_ocp(0.05 if model is quadrotor else 0.1)
    x0 = model.initial_state(jnp.float64)
    u0, x0b = make_batch(jax.random.PRNGKey(4), x0, 5, 10, nu,
                         state_scale=0.05, control_scale=0.1,
                         dtype=jnp.float64)
    if model is quadrotor:
        u0 = u0 + quadrotor.hover_controls(10, jnp.float64)[None]
    cfg = ipoc_tpu.BATCH_CONFIG.replace(barrier_mode="flat", bp_min=4.1e-3)
    sol = jax.jit(lambda u, x: solve_stream(ocp, u, x, cfg, lanes=2,
                                            refill_every=3))(u0, x0b)
    one = jax.jit(lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
        ocp, u, x, cfg))
    for i in range(u0.shape[0]):
        u_i, it_i = one(u0[i], x0b[i])
        np.testing.assert_allclose(np.asarray(sol.controls[i]),
                                   np.asarray(u_i), rtol=1e-12, atol=1e-12)
        assert int(sol.iterations[i]) == int(it_i) > 0


@pytest.mark.parametrize("every", [
    pytest.param(1, marks=pytest.mark.slow),
    5,
    pytest.param(1000, marks=pytest.mark.slow),
])
def test_stream_refill_every_same_results(scenario_pool, every):
    """The capture/refill cadence (every step, every 5, effectively once per
    drain) only reschedules lanes; per-scenario solutions are unchanged."""
    ocp, u0, x0b = scenario_pool
    u_ref, it_ref = _flat_reference(ocp, u0, x0b)
    sol = jax.jit(
        lambda u, x: solve_stream(
            ocp, u, x, CFG, lanes=3, refill_every=every)
    )(u0, x0b)
    np.testing.assert_allclose(np.asarray(sol.controls), u_ref,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(sol.iterations), it_ref)


@pytest.mark.slow
def test_stream_fewer_lockstep_steps(scenario_pool):
    """With fewer lanes than scenarios the stream still terminates and the
    lockstep step count is bounded by sum of per-scenario iterations (full
    serialization) plus capture steps."""
    ocp, u0, x0b = scenario_pool
    _, it_ref = _flat_reference(ocp, u0, x0b)
    sol = solve_stream(ocp, u0, x0b, CFG, lanes=2)
    assert int(sol.steps) <= int(it_ref.sum()) + len(it_ref) + 2


@pytest.mark.slow
def test_stream_bad_warm_start_lane():
    """A non-finite warm start is captured with iterations=0 and its input
    controls, without poisoning the other scenarios (flat-solver parity)."""
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(5), x0, 4, 30, 1,
        state_scale=0.05, control_scale=0.1, dtype=jnp.float64,
    )
    u_bad = u0.at[2].set(jnp.nan)
    sol = solve_stream(ocp, u_bad, x0b, CFG, lanes=2)
    ref_u, ref_it = _flat_reference(ocp, u_bad, x0b)
    np.testing.assert_allclose(np.asarray(sol.controls), ref_u,
                               rtol=1e-12, atol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(np.asarray(sol.iterations), ref_it)
    assert int(sol.iterations[2]) == 0


@pytest.mark.slow
def test_stream_sharded_matches_local(scenario_pool):
    """Per-shard streams over a 4-device mesh reproduce the per-scenario
    solutions of a single local stream (pool order is shard-major)."""
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.solvers.stream import solve_stream_sharded

    ocp, u0, x0b = scenario_pool
    # 8 scenarios over 4 shards (2 each)
    u8 = jnp.concatenate([u0, u0[:1]], axis=0)
    x8 = jnp.concatenate([x0b, x0b[:1]], axis=0)
    mesh = make_mesh(batch=4)
    sol = jax.jit(
        lambda u, x: solve_stream_sharded(ocp, u, x, mesh, CFG, lanes=2)
    )(u8, x8)
    ref = jax.jit(
        lambda u, x: solve_stream(ocp, u, x, CFG, lanes=2)
    )(u8[:2], x8[:2])  # first shard's pool, same lane count
    np.testing.assert_allclose(np.asarray(sol.controls[:2]),
                               np.asarray(ref.controls),
                               rtol=1e-12, atol=1e-12)
    flat = _flat_reference(ocp, u8[2:4], x8[2:4])
    np.testing.assert_allclose(np.asarray(sol.controls[2:4]), flat[0],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(sol.iterations[2:4]), flat[1])


def test_stream_requires_single_globalization():
    ocp = pendulum.make_ocp(0.02)
    with pytest.raises(ValueError, match="single"):
        solve_stream(
            ocp, jnp.zeros((2, 10, 1)), jnp.zeros((2, 2)),
            ipoc_tpu.FAST_CONFIG,
        )


def test_stage_predictor_same_optimum_fewer_iters(scenario_pool):
    """SolverConfig.stage_predictor extrapolates the central path at barrier
    stage transitions: converged raw costs must match the plain schedule to
    solver tolerance while total Newton iterations drop."""
    from ipoc_tpu.utils.integrators import rollout

    ocp, u0, x0b = scenario_pool
    # Full 5-stage schedule: the predictor only fires from the SECOND
    # transition on, so the fixture's trimmed 3-stage schedule leaves it
    # almost no headroom to show an iteration win.
    base = CFG.replace(newton_impl="fused", pred_floor=1e-9, bp_min=1e-4)
    off = jax.jit(lambda u, x: solve_stream(ocp, u, x, base, lanes=4))(
        u0, x0b)
    on = jax.jit(lambda u, x: solve_stream(
        ocp, u, x, base.replace(stage_predictor=True), lanes=4))(u0, x0b)

    def raw_costs(sol):
        bp = jnp.asarray(1e-9, jnp.float64)
        return np.array([
            float(ocp.total_cost(
                rollout(ocp.dynamics, sol.controls[i], x0b[i]),
                sol.controls[i], bp))
            for i in range(u0.shape[0])
        ])

    c_off, c_on = raw_costs(off), raw_costs(on)
    np.testing.assert_allclose(c_on, c_off, rtol=1e-4)
    assert int(np.sum(np.asarray(on.iterations))) < int(
        np.sum(np.asarray(off.iterations)))


@pytest.mark.slow
def test_stream_inner_unroll_same_results(scenario_pool):
    """inner_unroll only re-quantizes the inner loop; per-scenario results
    are bit-identical."""
    ocp, u0, x0b = scenario_pool
    ref = jax.jit(lambda u, x: solve_stream(ocp, u, x, CFG, lanes=3))(
        u0, x0b)
    un = jax.jit(lambda u, x: solve_stream(
        ocp, u, x, CFG, lanes=3, inner_unroll=4))(u0, x0b)
    np.testing.assert_allclose(np.asarray(un.controls),
                               np.asarray(ref.controls),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(un.iterations),
                                  np.asarray(ref.iterations))
