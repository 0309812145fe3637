"""Multi-device scaling benchmark: batch-sharded IP solves over a mesh.

Measures solves/s at increasing device counts (up to the four GPUs of one
host) and reports scaling efficiency.  On a one-GPU or CPU machine, run
with virtual devices to exercise the code path:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/scaling_benchmark.py --platform cpu --batch-per-device 4
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

p = argparse.ArgumentParser()
p.add_argument("--platform", default=None)
p.add_argument("--batch-per-device", type=int, default=8)
p.add_argument("--horizon", type=int, default=50)
args = p.parse_args()
if args.platform:
    jax.config.update("jax_platforms", args.platform)

import jax.numpy as jnp

import ipoc_tpu
from ipoc_tpu.models import cartpole
from ipoc_tpu.parallel.distributed import scaling_report
from ipoc_tpu.parallel.sharding import make_mesh
from ipoc_tpu.solvers.batched import make_batch, solve_batch_sharded
from ipoc_tpu.utils.compile_cache import use_compile_cache


def main():
    use_compile_cache()
    n_dev = len(jax.devices())
    H = args.horizon
    ocp = cartpole.make_ocp(1.0 / H)
    x0 = cartpole.initial_state(jnp.float32)
    cfg = ipoc_tpu.BATCH_CONFIG

    single_rate = None
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    for n in counts:
        B = args.batch_per_device * n
        mesh = make_mesh(batch=n, time=1)
        u0, x0b = make_batch(
            jax.random.PRNGKey(1), x0, B, H, 1, state_scale=0.01,
            dtype=jnp.float32,
        )
        f = jax.jit(
            lambda u, x, m=mesh: solve_batch_sharded(ocp, u, x, m, cfg)
        )
        jax.block_until_ready(f(u0, x0b))
        t0 = time.perf_counter()
        jax.block_until_ready(f(u0, x0b))
        rate = B / (time.perf_counter() - t0)
        if single_rate is None:
            single_rate = rate
        rep = scaling_report(rate, n, single_rate)
        print(
            f"devices={n:3d} B={B:5d}: {rate:9.1f} solves/s  "
            f"efficiency={rep['efficiency']:.2%}"
        )


if __name__ == "__main__":
    main()
