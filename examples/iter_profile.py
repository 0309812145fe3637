"""Per-iteration profile of the fused stream hot path on a GPU.

Times, at the bench configuration (cartpole H=100, B lanes):

* the fused lane-iteration kernel alone (two Triton launches,
  ``fused_newton_iter_batched``) and the plain XLA composition it replaces,
* the stage transition alone (two rollouts + barrier costs,
  ``ip_newton._lane_transition`` under vmap),
* one full ``flat_lane_iter`` step (kernel + XLA glue + scalar logic).

The difference full-step minus kernel minus transition is the
per-iteration XLA glue.  Each probe runs under ``lax.fori_loop`` REPS times
inside one jit, so the host's dispatch cost is amortized away.

Usage: python examples/iter_profile.py [--lanes 4096] [--horizon 100]
"""

import argparse
import functools
import os
import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ipoc_tpu.config import BATCH_CONFIG
from ipoc_tpu.models import cartpole
from ipoc_tpu.ops.pallas.fused_iter_kernel import (
    _fused_reference,
    fused_newton_iter_batched,
)
from ipoc_tpu.solvers.batched import make_batch
from ipoc_tpu.solvers.ip_newton import (
    _lane_transition,
    flat_lane_init,
    flat_lane_iter,
)
from ipoc_tpu.utils.compile_cache import use_compile_cache


def timed(fn, *args, reps=50, warmup=1):
    """Wall time per call of jit(fn) amortized over an in-program loop."""

    @jax.jit
    def looped(*a):
        def body(_, carry):
            return fn(*carry)

        return lax.fori_loop(0, reps, body, a)

    for _ in range(warmup):
        jax.block_until_ready(looped(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(looped(*args))
    dt = time.perf_counter() - t0
    return dt / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    use_compile_cache()

    B, T = args.lanes, args.horizon
    ocp = cartpole.make_ocp(1.0 / T)
    x0 = cartpole.initial_state(jnp.float32)
    u0, x0b = make_batch(
        jax.random.PRNGKey(0), x0, B, T, 1,
        state_scale=0.02, control_scale=0.1, dtype=jnp.float32,
    )
    cfg = BATCH_CONFIG
    lanes = jax.vmap(
        lambda u, x: flat_lane_init(ocp, u, x, cfg))(u0, x0b)
    bp = jnp.full((B,), 0.1, jnp.float32)
    reg = jnp.full((B,), 3.0, jnp.float32)

    plain = jax.vmap(lambda *a: _fused_reference(ocp, *a))
    results = {}
    for tag, fused in (("kernel", functools.partial(
            fused_newton_iter_batched, ocp)), ("plain_xla", plain)):
        def probe(x, u, b, r, fused=fused):
            out = fused(x, u, b, r)
            # Feed the trial back in so the loop has a data dependence.
            return out[0], out[1], b, r

        results[tag] = timed(probe, lanes.x, lanes.u, bp, reg,
                             reps=args.reps)

    trans = jax.vmap(functools.partial(_lane_transition, ocp))

    def probe_trans(u, up, x0_, b):
        xa, xb, ca, cb = trans(u, up, x0_, b)
        return jnp.where((ca < cb)[:, None, None], u, up), up, x0_, b

    results["transition"] = timed(
        probe_trans, lanes.u, lanes.u * 0.99, x0b, bp, reps=args.reps)

    step = jax.vmap(functools.partial(flat_lane_iter, ocp, cfg=cfg))
    results["full_lane_iter"] = timed(
        lambda ln: (step(ln),), lanes, reps=args.reps)

    print(f"config: B={B} T={T} reps={args.reps}")
    for k, v in results.items():
        print(f"{k:24s} {v * 1e6:9.1f} us/step")
    glue = results["full_lane_iter"] - results["kernel"] - results[
        "transition"]
    print(f"{'=> xla glue + scalars':24s} {glue * 1e6:9.1f} us/step")


if __name__ == "__main__":
    main()
