"""Newton-multigrid switched-lane quality diagnosis.

Measures, for several (coarse_impl, fine_impl) multigrid variants, the
basin-switch fraction and the SIGNED mean relative cost delta on switched
lanes vs the faithful single-grid Newton stream — the bench quality gate's
definition — plus drain throughput.  The question it answers: whether a
DDP coarse level (nonlinear closed-loop re-rollouts) lands switched lanes
in quality-neutral basins where the Newton coarse level does not.

Usage: python scripts/mg_quality.py [B] [POOLX] [variants...]
  variants: comma-pairs like fused,fused fused,ddp ddp,fused ddp,ddp
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

import ipoc_tpu  # noqa: E402
from ipoc_tpu.models import cartpole  # noqa: E402
from ipoc_tpu.solvers.batched import make_batch  # noqa: E402
from ipoc_tpu.solvers.stream import (  # noqa: E402
    solve_stream,
    solve_stream_multigrid,
)
from ipoc_tpu.utils.integrators import rollout  # noqa: E402

B = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
POOLX = int(sys.argv[2]) if len(sys.argv) > 2 else 16
variants = [tuple(v.split(",")) for v in sys.argv[3:]] or [
    ("fused", "fused"), ("fused", "ddp"), ("ddp", "fused"), ("ddp", "ddp"),
]
T, COARSEN = 100, 4

cfg = ipoc_tpu.BATCH_CONFIG
ocp = cartpole.make_ocp(1.0 / T)
ocp_c = cartpole.make_ocp(COARSEN / T)
x0 = cartpole.initial_state(jnp.float32)
N = B * POOLX
u0, x0b = make_batch(jax.random.PRNGKey(1), x0, N, T, 1,
                     state_scale=0.01, control_scale=0.1,
                     dtype=jnp.float32)


def sync(x):
    jax.block_until_ready(x)
    return np.asarray(x)


def raw_cost(u, x0s):
    x = rollout(ocp.dynamics, u, x0s)
    return ocp.total_cost(x, u, jnp.asarray(1e-9, u.dtype))


costs = jax.jit(jax.vmap(raw_cost))

print(f"B={B} N={N} platform={jax.devices()[0].platform}", flush=True)

ref_step = jax.jit(lambda u, x: solve_stream(ocp, u, x, cfg, lanes=B,
                                             refill_every=32))
ref = ref_step(u0, x0b)
c_sg = sync(costs(ref.controls, x0b)).astype(np.float64)
print("single-grid reference ready", flush=True)

for ci, fi in variants:
    step = jax.jit(lambda u, x, ci=ci, fi=fi: solve_stream_multigrid(
        ocp, ocp_c, COARSEN, u, x, cfg, lanes=B, refill_every=32,
        coarse_impl=None if ci == "fused" else ci,
        fine_impl=None if fi == "fused" else fi))
    sol = step(u0, x0b)
    sync(sol.iterations)
    t0 = time.perf_counter()
    sol = step(u0, x0b)
    sync(sol.iterations)
    dt = time.perf_counter() - t0
    c_mg = sync(costs(sol.controls, x0b)).astype(np.float64)
    rel = np.abs(c_mg - c_sg) / np.maximum(np.abs(c_sg), 1e-12)
    switched = rel > 1e-3
    signed = (c_mg - c_sg) / np.maximum(np.abs(c_sg), 1e-12)
    msd = float(signed[switched].mean()) if switched.any() else 0.0
    sw = signed[switched]
    wins = float((sw < 0).mean()) if switched.any() else 0.0
    print(
        f"mg[{ci:5s}/{fi:5s}]: {N/dt:9.0f} solves/s  "
        f"switch {switched.mean()*100:.2f}%  "
        f"signed_delta_switched {msd:+.5f}  "
        f"(win-frac {wins:.2f}, mean_win "
        f"{float(sw[sw < 0].mean()) if (sw < 0).any() else 0:+.4f}, "
        f"mean_loss {float(sw[sw > 0].mean()) if (sw > 0).any() else 0:+.4f})  "
        f"matched_mean {float(rel[~switched].mean()):.2e}  "
        f"it_c={float(np.mean(sync(sol.iterations_coarse))):.1f} "
        f"it_f={float(np.mean(sync(sol.iterations))):.1f}",
        flush=True,
    )
