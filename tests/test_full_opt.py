"""One default-tier test that compiles through the PRODUCTION XLA pipeline.

tests/conftest.py turns on ``jax_disable_most_optimizations`` for the whole
default tier (the suite is compile-count bound; results are checked by
explicit tolerances, so the de-optimized compiler is safe there and ~2x
faster).  That leaves a hole: a regression that only manifests under full
XLA optimization (fusion/layout dependence, or a compile-time blowup)
would pass every default-tier
test.  This smoke test closes it: one small end-to-end batched IP solve is
compiled and run under the FULL optimization pipeline and pinned against
the de-optimized result.
"""

import jax
import jax.numpy as jnp
import numpy as np

import ipoc_tpu
from ipoc_tpu.models import pendulum
from ipoc_tpu.solvers.batched import make_batch, solve_batch


def test_full_opt_pipeline_smoke():
    ocp = pendulum.make_ocp(0.1)
    x0 = pendulum.initial_state(jnp.float32)
    cfg = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=60)
    u0, x0b = make_batch(
        jax.random.PRNGKey(0), x0, n=8, horizon=10, nu=1,
        state_scale=0.01, dtype=jnp.float32,
    )

    def run():
        sol = jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))(u0, x0b)
        return np.asarray(sol.controls), np.asarray(sol.iterations)

    u_deopt, it_deopt = run()

    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        jax.clear_caches()  # force a fresh trace+compile under full opt
        u_full, it_full = run()
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
        jax.clear_caches()

    assert np.all(np.isfinite(u_full))
    # The optimizing pipeline reassociates float ops, so accept decisions
    # near the boundary can shift iterates by an iteration or two — pin
    # the converged SOLUTIONS, not the iterate path.
    assert np.max(np.abs(it_full.astype(np.int64)
                         - it_deopt.astype(np.int64))) <= 3
    # Near-active-bound stages (|u| -> 5) are the IP-sensitive entries;
    # per-control agreement is loose there, cost agreement below is tight.
    np.testing.assert_allclose(u_full, u_deopt, atol=5e-2)
    zero = jnp.zeros((), jnp.float32)

    def total_cost(u_batch):
        from ipoc_tpu.utils.integrators import rollout

        def one(u, x):
            xs = rollout(ocp.dynamics, jnp.asarray(u), x)
            return ocp.total_cost(xs, jnp.asarray(u), zero)

        return np.asarray(jax.vmap(one)(u_batch, x0b))

    np.testing.assert_allclose(total_cost(u_full), total_cost(u_deopt),
                               rtol=1e-5)
