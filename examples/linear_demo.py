"""Unconstrained LQR sanity demo (reference examples/linear_demo_cuda.py).

The parallel IP Newton method on a linear-quadratic problem must converge in
~one Newton iteration per barrier stage to the closed-form LQR solution.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

p = argparse.ArgumentParser()
p.add_argument("--platform", default=None, help="e.g. cpu to force CPU")
_args = p.parse_args()
if _args.platform:
    jax.config.update("jax_platforms", _args.platform)

import jax.numpy as jnp

import ipoc_tpu
from ipoc_tpu.models import double_integrator
from ipoc_tpu.utils.compile_cache import use_compile_cache


def main():
    use_compile_cache()
    ocp = double_integrator.make_ocp(0.1)
    horizon = 40
    x0 = jnp.array([2.0, 1.0])
    u0 = jnp.zeros((horizon, 1))

    u, iters = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(ocp, u, x)
    )(u0, x0)
    print("Newton iterations:", int(iters))
    print("u[:5] =", jnp.asarray(u[:5]).ravel())
    from ipoc_tpu.utils.integrators import rollout

    X = rollout(ocp.dynamics, u, x0)
    print("final state:", X[-1], "(drives to origin)")


if __name__ == "__main__":
    main()
