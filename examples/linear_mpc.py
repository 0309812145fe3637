"""Linear MPC loop: parallel vs sequential LQT passes.

Reference examples/linear_mpc_parallel.py semantics: a double integrator,
RK4 dt=0.001, LQT horizon T=5, 5000 receding-horizon steps, Q=diag(100,1),
R=0.1, x0=[2,1]; each MPC step re-solves the LQT and applies u[0]; the whole
loop is one lax.scan.  Times par vs seq full-loop wall clock.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from ipoc_tpu.models import double_integrator
from ipoc_tpu.mpc import lqt_mpc_loop
from ipoc_tpu.parallel.lqt import LQT
from ipoc_tpu.utils.integrators import discretize_dynamics


def build_lqt(T=5, dt=1e-3, dtype=jnp.float32):
    dynamics = discretize_dynamics(double_integrator.ode, dt, 1)
    x_lin = jnp.zeros(2, dtype)
    A = jax.jacfwd(dynamics, 0)(x_lin, jnp.zeros(1, dtype))
    B = jax.jacfwd(dynamics, 1)(x_lin, jnp.zeros(1, dtype))
    nx, nu = 2, 1
    Q = jnp.diag(jnp.array([1e2, 1e0], dtype))
    R = 1e-1 * jnp.eye(nu, dtype=dtype)
    tile = lambda M: jnp.broadcast_to(M, (T,) + M.shape)
    return LQT(
        A=tile(A), B=tile(B), c=jnp.zeros((T, nx), dtype),
        XT=Q, HT=jnp.eye(nx, dtype=dtype), rT=jnp.zeros(nx, dtype),
        X=tile(Q), H=tile(jnp.eye(nx, dtype=dtype)), r=jnp.zeros((T, nx), dtype),
        U=tile(R), Z=tile(jnp.eye(nu, dtype=dtype)), s=jnp.zeros((T, nu), dtype),
        M=jnp.zeros((T, nx, nu), dtype),
    )


def main():
    import json

    from ipoc_tpu.utils.compile_cache import use_compile_cache
    from ipoc_tpu.utils.timing import time_fn

    use_compile_cache()

    n_steps = 5000
    reps = int(os.environ.get("IPOC_MPC_REPS", "5"))
    lqt = build_lqt()
    x0 = jnp.array([2.0, 1.0], lqt.A.dtype)

    result = {
        "metric": "linear_mpc_5000_step_loop",
        "protocol": "reference examples/linear_mpc_parallel.py:86-100 "
                    "(T=5, dt=0.001, 5000 receding-horizon LQT re-solves, "
                    "whole loop one lax.scan); block_until_ready, "
                    "1 warmup + median of %d reps" % reps,
        "device": jax.devices()[0].device_kind,
        "n_steps": n_steps,
    }
    for mode in ("par", "seq"):
        loop = jax.jit(
            lambda x, m=mode: lqt_mpc_loop(lqt, x, n_steps, mode=m)
        )
        # warmup/compile + result for quality stats
        xs, us = jax.block_until_ready(loop(x0))
        mean_s, dt, _ = time_fn(loop, x0, reps=reps, warmup=0)
        result[mode] = {
            "loop_s_median": dt,
            "loop_s_mean": mean_s,
            "steps_per_sec": n_steps / dt,
            "final_state_norm": float(jnp.linalg.norm(xs[-1])),
        }
        print(
            f"{mode}: {dt:.3f}s for {n_steps} MPC steps "
            f"({n_steps/dt:.0f} steps/s); final |x| = {float(jnp.linalg.norm(xs[-1])):.2e}"
        )
    result["par_speedup_vs_seq"] = (
        result["seq"]["loop_s_median"] / result["par"]["loop_s_median"]
    )
    out = os.environ.get("IPOC_MPC_JSON", "")
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
