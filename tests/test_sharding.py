"""Multi-device tests on the 8-virtual-CPU-device fake backend (SURVEY §4):
cross-shard associative scans, time-sharded LQT passes, and sharded batch
solves must agree with their single-device counterparts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

import ipoc_tpu
from ipoc_tpu.models import pendulum
from ipoc_tpu.parallel.costates import affine_combine
from ipoc_tpu.parallel.lqt import par_bwd_pass, par_fwd_pass
from ipoc_tpu.parallel.sharding import make_mesh, sharded_associative_scan
from ipoc_tpu.parallel.time_sharded import solve_lqt_time_sharded
from ipoc_tpu.solvers.batched import make_batch, solve_batch, solve_batch_sharded
from tests.conftest import make_random_lqt


@pytest.fixture(scope="module")
def devices():
    ds = jax.devices()
    assert len(ds) == 8, f"expected 8 virtual devices, got {len(ds)}"
    return ds


def test_sharded_scan_forward(devices):
    """Cross-shard affine prefix scan == single-device scan."""
    mesh = Mesh(np.array(devices), ("time",))
    T, n = 16, 3
    rng = np.random.default_rng(7)
    F = jnp.array(rng.normal(size=(T, n, n)) * 0.5)
    c = jnp.array(rng.normal(size=(T, n)))

    expected = lax.associative_scan(
        lambda a, b: affine_combine(b, a), (F, c), axis=0
    )

    # Interval-concatenation in (earlier, later) convention: the composite
    # map applies the earlier interval first => affine_combine(later, earlier).
    fn = shard_map(
        lambda F, c: sharded_associative_scan(
            lambda a, b: affine_combine(b, a), (F, c), "time"
        ),
        mesh=mesh,
        in_specs=(P("time"), P("time")),
        out_specs=(P("time"), P("time")),
        check_vma=False,
    )
    got = fn(F, c)
    np.testing.assert_allclose(got[0], expected[0], atol=1e-11)
    np.testing.assert_allclose(got[1], expected[1], atol=1e-11)


def test_sharded_scan_reverse(devices):
    """Cross-shard suffix scan == single-device reverse scan."""
    mesh = Mesh(np.array(devices), ("time",))
    T, n = 16, 2
    rng = np.random.default_rng(8)
    F = jnp.array(rng.normal(size=(T, n, n)) * 0.5)
    c = jnp.array(rng.normal(size=(T, n)))

    expected = lax.associative_scan(
        lambda a, b: affine_combine(b, a), (F, c), reverse=True, axis=0
    )
    fn = shard_map(
        lambda F, c: sharded_associative_scan(
            affine_combine, (F, c), "time", reverse=True
        ),
        mesh=mesh,
        in_specs=(P("time"), P("time")),
        out_specs=(P("time"), P("time")),
        check_vma=False,
    )
    got = fn(F, c)
    np.testing.assert_allclose(got[0], expected[0], atol=1e-11)
    np.testing.assert_allclose(got[1], expected[1], atol=1e-11)


@pytest.mark.smoke
def test_time_sharded_lqt_solve(rng, devices):
    """Full time-sharded LQT solve == single-device parallel passes."""
    mesh = make_mesh(batch=1, time=8, devices=devices)
    T, nx, nu = 16, 3, 2
    lqt = make_random_lqt(rng, T=T, nx=nx, nu=nu)
    x0 = jnp.array(rng.normal(size=(nx,)))

    K, d, *_ = par_bwd_pass(lqt)
    u_ref, x_ref = par_fwd_pass(lqt, x0, K, d)

    u, x_stage = solve_lqt_time_sharded(lqt, x0, mesh)
    np.testing.assert_allclose(u, u_ref, atol=1e-9)
    np.testing.assert_allclose(x_stage, x_ref[:-1], atol=1e-9)


@pytest.mark.slow
def test_batch_solve_matches_individual():
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(0), x0, n=4, horizon=30, nu=1,
        state_scale=0.05, dtype=jnp.float64,
    )
    cfg = ipoc_tpu.FAST_CONFIG
    sol = solve_batch(ocp, u0, x0b, cfg)
    for i in range(4):
        u_i, it_i = ipoc_tpu.par_interior_point_optimal_control(
            ocp, u0[i], x0b[i], cfg
        )
        np.testing.assert_allclose(sol.controls[i], u_i, atol=1e-8)
        assert int(sol.iterations[i]) == int(it_i)


@pytest.mark.slow
def test_sharded_batch_matches_vmap(devices):
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(1), x0, n=8, horizon=25, nu=1,
        state_scale=0.05, dtype=jnp.float64,
    )
    cfg = ipoc_tpu.FAST_CONFIG
    mesh = make_mesh(batch=8, time=1, devices=devices)
    ref = solve_batch(ocp, u0, x0b, cfg)
    got = solve_batch_sharded(ocp, u0, x0b, mesh, cfg)
    np.testing.assert_allclose(got.controls, ref.controls, atol=1e-8)
    np.testing.assert_array_equal(got.iterations, ref.iterations)


def test_sharded_stream_matches_single_device(devices):
    """solve_stream_sharded over a 4-device batch mesh == one solve_stream
    over the whole pool: per-scenario iterations equal, controls equal to
    float32 rounding (the same check the four-card run makes)."""
    from ipoc_tpu.solvers.stream import solve_stream, solve_stream_sharded

    cfg = ipoc_tpu.BATCH_CONFIG.replace(
        max_newton_iters=8, bp_init=0.1, bp_min=0.021
    )
    T = 6
    ocp = pendulum.make_ocp(1.0 / T)
    x0 = pendulum.initial_state(jnp.float32)
    N = 4 * 6  # 6 scenarios per shard through 4 resident lanes
    u0, x0b = make_batch(jax.random.PRNGKey(5), x0, N, T, 1,
                         state_scale=0.02, control_scale=0.1,
                         dtype=jnp.float32)
    ref = solve_stream(ocp, u0, x0b, cfg, lanes=4, refill_every=4)
    mesh = make_mesh(batch=4, time=1, devices=devices[:4])
    got = jax.jit(lambda u, x: solve_stream_sharded(
        ocp, u, x, mesh, cfg, lanes=4, refill_every=4))(u0, x0b)
    assert len(got.controls.sharding.device_set) == 4
    np.testing.assert_array_equal(np.asarray(got.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(np.asarray(got.controls),
                               np.asarray(ref.controls), rtol=1e-5,
                               atol=1e-6)
