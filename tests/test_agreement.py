"""f32-vs-f64 agreement pins.

The sweep-level check is examples/sweep_agreement.py (gated
``max_abs_dx`` and ``bound_active_du`` columns per configuration).  This
slow test pins the same three gates on the headline config so the claim
is continuously asserted:

* relative converged-cost delta (the flat-valley-proof optimality gate),
* state-trajectory deviation through the f64 dynamics,
* control agreement on bound-active stages (where the active set pins the
  solution, agreement must be tight — no flat-valley slack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import cartpole
from ipoc_tpu.utils.integrators import rollout

FINAL_BP = 0.1 / 5.0**4


@pytest.mark.slow
def test_cartpole_h100_f32_agreement_gates():
    H = 100
    ocp = cartpole.make_ocp(1.0 / H)
    solver = ipoc_tpu.par_interior_point_optimal_control

    u64, _ = jax.jit(lambda u, x: solver(
        ocp, u, x, ipoc_tpu.DEFAULT_CONFIG))(
        0.1 * jax.random.normal(jax.random.PRNGKey(1), (H, 1)),
        cartpole.initial_state(jnp.float64))
    u32, _ = jax.jit(lambda u, x: solver(
        ocp, u, x, ipoc_tpu.FAST_CONFIG))(
        (0.1 * jax.random.normal(jax.random.PRNGKey(1), (H, 1))
         ).astype(jnp.float32),
        cartpole.initial_state(jnp.float32))

    x0 = cartpole.initial_state(jnp.float64)
    u32_64 = jnp.asarray(np.asarray(u32), jnp.float64)

    def cost(u):
        x = rollout(ocp.dynamics, u, x0)
        return float(ocp.total_cost(x, u, FINAL_BP))

    c32, c64 = cost(u32_64), cost(u64)
    assert abs(c32 - c64) / abs(c64) <= 1e-5

    x32 = rollout(ocp.dynamics, u32_64, x0)
    x64 = rollout(ocp.dynamics, u64, x0)
    assert float(jnp.max(jnp.abs(x32 - x64))) <= 2e-2

    bound = cartpole.CONTROL_BOUND
    active = np.abs(np.asarray(u64)) >= (1.0 - 1e-3) * bound
    assert active.any()  # the swing-up rides the force box
    du = np.abs(np.asarray(u32_64 - u64))
    act_du = np.sort(du[active])
    # p95 of the active set is pinned-tight; the tail above it is
    # switching-time quantization (see examples/sweep_agreement.py).
    assert float(act_du[int(0.95 * (len(act_du) - 1))]) <= 1e-3 * bound
