"""Warm-started nonlinear MPC: amortized interior-point resolves.

The throughput story for deployment: a receding-horizon controller re-solves
the IP problem from the previous plan every step, so per-step Newton
iteration counts collapse versus cold starts.  The whole closed loop is one
``lax.scan``.

Usage: python examples/nonlinear_mpc.py [--steps 50] [--platform cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

p = argparse.ArgumentParser()
p.add_argument("--steps", type=int, default=50)
p.add_argument("--horizon", type=int, default=40)
p.add_argument("--batch", type=int, default=1,
               help=">1: B independent closed-loop controllers in lockstep")
p.add_argument("--platform", default=None)
args = p.parse_args()
if args.platform:
    jax.config.update("jax_platforms", args.platform)

import jax.numpy as jnp
import numpy as np

import ipoc_tpu
from ipoc_tpu.models import pendulum
from ipoc_tpu.mpc import nmpc_loop
from ipoc_tpu.utils.compile_cache import use_compile_cache


def main():
    use_compile_cache()
    dt = 0.02
    ocp = pendulum.make_ocp(dt)
    # Warm-started resolves converge in a handful of iterations; cap tightly.
    cfg = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=25)

    def solve(u_warm, x):
        u, _ = ipoc_tpu.par_interior_point_optimal_control(ocp, u_warm, x, cfg)
        return u

    x0 = pendulum.initial_state(jnp.float32)
    u_init = jnp.zeros((args.horizon, 1), jnp.float32)

    if args.batch > 1:
        # Batched NMPC: B independent closed-loop controllers stepping in
        # lockstep — the amortized-throughput story (each step is a
        # warm-started IP resolve; on the GPU in float32 every Newton
        # iteration runs the fused kernel across the controllers).
        key = jax.random.PRNGKey(0)
        x0b = x0[None, :] + 0.05 * jax.random.normal(
            key, (args.batch, x0.shape[0]), jnp.float32
        )
        u0b = jnp.zeros((args.batch, args.horizon, 1), jnp.float32)
        loop = jax.jit(
            jax.vmap(
                lambda x, u: nmpc_loop(solve, ocp.dynamics, x, u,
                                       args.steps)
            )
        )
        jax.block_until_ready(loop(x0b, u0b))
        t0 = time.perf_counter()
        xs, us = jax.block_until_ready(loop(x0b, u0b))
        wall = time.perf_counter() - t0
        n_resolves = args.batch * args.steps
        print(
            f"{args.batch} controllers x {args.steps} MPC steps in "
            f"{wall:.3f}s ({n_resolves / wall:.0f} warm-started resolves/s)"
        )
        print("max |u|:", float(jnp.abs(us).max()), "(bound 5)")
        print("mean final |theta|:",
              float(jnp.abs(xs[:, -1, 0]).mean()))
        return

    loop = jax.jit(
        lambda x, u: nmpc_loop(solve, ocp.dynamics, x, u, args.steps)
    )
    jax.block_until_ready(loop(x0, u_init))
    t0 = time.perf_counter()
    xs, us = jax.block_until_ready(loop(x0, u_init))
    wall = time.perf_counter() - t0
    print(
        f"{args.steps} MPC steps in {wall:.3f}s "
        f"({args.steps / wall:.1f} resolves/s); "
        f"real-time budget per step: {dt * 1e3:.0f} ms, "
        f"actual: {wall / args.steps * 1e3:.2f} ms"
    )
    print("max |u|:", float(jnp.abs(us).max()), "(bound 5)")
    print("final state:", np.asarray(xs[-1]))


if __name__ == "__main__":
    main()
