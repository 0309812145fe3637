"""Batched scenario throughput: solves/s against the batch size.

Sweeps the scenario batch size for vmapped constrained-cartpole IP solves
(no reference equivalent — the reference is strictly one solve at a time).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import ipoc_tpu
from ipoc_tpu.models import cartpole
from ipoc_tpu.solvers.batched import make_batch, solve_batch
from ipoc_tpu.utils.compile_cache import use_compile_cache


def main():
    use_compile_cache()
    H = int(os.environ.get("HORIZON", "100"))
    ocp = cartpole.make_ocp(1.0 / H)
    x0 = cartpole.initial_state(jnp.float32)
    cfg = ipoc_tpu.FAST_CONFIG

    for B in (1, 8, 32, 128, 512):
        u0, x0b = make_batch(
            jax.random.PRNGKey(1), x0, B, H, 1, state_scale=0.01,
            dtype=jnp.float32,
        )
        f = jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))
        jax.block_until_ready(f(u0, x0b))
        t0 = time.perf_counter()
        sol = jax.block_until_ready(f(u0, x0b))
        dt = time.perf_counter() - t0
        print(
            f"B={B:5d}: {dt*1e3:8.1f} ms/batch  {B/dt:9.1f} solves/s  "
            f"iters[min..max]=[{int(sol.iterations.min())}..{int(sol.iterations.max())}]"
        )

    # The production throughput path: multigrid-in-time streaming over a
    # deep scenario pool (the bench.py headline; solvers/stream.py).
    from ipoc_tpu.solvers.stream import solve_stream_multigrid

    B = int(os.environ.get("LANES", "512"))
    N = 8 * B
    ocp_c = cartpole.make_ocp(4.0 / H)
    u0, x0b = make_batch(
        jax.random.PRNGKey(1), x0, N, H, 1, state_scale=0.01,
        dtype=jnp.float32,
    )
    fm = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, ipoc_tpu.BATCH_CONFIG, lanes=B))
    jax.block_until_ready(fm(u0, x0b))
    t0 = time.perf_counter()
    jax.block_until_ready(fm(u0, x0b))
    dt = time.perf_counter() - t0
    print(
        f"multigrid stream (lanes={B}, pool={N}): {dt:6.3f} s  "
        f"{N/dt:9.1f} solves/s"
    )


if __name__ == "__main__":
    main()
