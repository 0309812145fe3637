"""Obstacle-avoidance unicycle: the first nonlinear STATE constraint in the
model zoo (a circular keep-out disc — nonconvex feasible set), exercising
the barrier machinery beyond box limits across solvers and the fused
batched path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import unicycle
from ipoc_tpu.solvers.batched import make_batch, solve_batch
from ipoc_tpu.utils.integrators import rollout

T = 60


def _setup(dtype=jnp.float64):
    ocp = unicycle.make_ocp(2.0 / T)
    x0 = unicycle.initial_state(dtype)
    u0 = jnp.concatenate(
        [0.3 * jnp.ones((T, 1), dtype), jnp.zeros((T, 1), dtype)], axis=1)
    return ocp, x0, u0


def _dist_to_center(x):
    cx, cy = unicycle.CENTER
    return np.sqrt(np.asarray((x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2))


@pytest.mark.parametrize("solver", ["par", "seq", "ddp"])
def test_swerves_and_rides_the_disc(solver):
    ocp, x0, u0 = _setup()
    fn = {
        "par": ipoc_tpu.par_interior_point_optimal_control,
        "seq": ipoc_tpu.seq_interior_point_optimal_control,
        "ddp": ipoc_tpu.interior_point_ddp,
    }[solver]
    if solver == "ddp":
        # DDP's nonlinear rollouts are more local than the Newton methods:
        # from the dead-straight cold start it converges to the "brake in
        # front of the disc" local optimum.  A deliberate swerving warm
        # start puts it in the go-around basin (genuine nonconvexity, same
        # for the reference's DDP).
        u0 = u0.at[:, 0].set(1.0).at[:, 1].set(-1.0)
    u, it = jax.jit(lambda u, x: fn(ocp, u, x, ipoc_tpu.FAST_CONFIG))(u0, x0)
    x = rollout(ocp.dynamics, u, x0)
    d = _dist_to_center(x)
    # reaches the goal...
    assert abs(float(x[-1, 0]) - unicycle.GOAL[0]) < 0.05
    # ...stays outside the disc at every constrained stage point, riding
    # the boundary (the straight line is blocked)
    c = np.asarray(jax.vmap(ocp.constraints)(x[:-1], u))
    assert c.max() <= 0.0
    assert d[:-1].min() == pytest.approx(unicycle.RADIUS, abs=1e-3)
    # it actually swerved
    assert float(jnp.max(jnp.abs(u[:, 1]))) > 0.5


@pytest.mark.slow
def test_par_seq_same_cost():
    ocp, x0, u0 = _setup()
    up, _ = jax.jit(lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
        ocp, u, x, ipoc_tpu.FAST_CONFIG))(u0, x0)
    us, _ = jax.jit(lambda u, x: ipoc_tpu.seq_interior_point_optimal_control(
        ocp, u, x, ipoc_tpu.FAST_CONFIG))(u0, x0)

    def raw(u):
        x = rollout(ocp.dynamics, u, x0)
        return float(ocp.total_cost(x, u, 1e-9))

    assert raw(up) == pytest.approx(raw(us), rel=1e-5)


def test_fused_batched_path():
    """The fused flat/stream path handles the nonlinear state constraint
    (the f64 plain composition here; the same lifted fns feed the GPU
    kernel)."""
    ocp, x0, u0 = _setup()
    B = 3
    u0b = jnp.broadcast_to(u0, (B,) + u0.shape)
    x0b = jnp.broadcast_to(x0, (B,) + x0.shape) + jnp.linspace(
        0.0, 0.01, B)[:, None]
    cfg = ipoc_tpu.BATCH_CONFIG
    sol = jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))(u0b, x0b)
    for i in range(B):
        x = rollout(ocp.dynamics, sol.controls[i], x0b[i])
        c = np.asarray(jax.vmap(ocp.constraints)(x[:-1], sol.controls[i]))
        assert c.max() <= 0.0
        assert abs(float(x[-1, 0]) - unicycle.GOAL[0]) < 0.1


def test_scalarize_covers_unicycle():
    from ipoc_tpu.ops.pallas.fused_iter_kernel import _stage_bwd_fn
    from ipoc_tpu.ops.pallas.scalarize import scalar_lift

    ocp, _, _ = _setup(jnp.float32)
    sds = jax.ShapeDtypeStruct
    with jax.enable_x64(False):
        fn = scalar_lift(
            _stage_bwd_fn(ocp, 3, 2),
            sds((3,), jnp.float32), sds((2,), jnp.float32),
            sds((), jnp.float32), sds((3,), jnp.float32),
        )
    assert fn.stats["ops"] > 0
