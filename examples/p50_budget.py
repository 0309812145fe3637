"""p50 solve latency vs real-time budget for the five BASELINE configs.

BASELINE.json's metric is "solves/s/chip at H=100 cartpole; p50 solve
latency vs real-time budget".  This driver measures the p50 (median)
latency of each of the five BASELINE configs and compares it against the
per-solve real-time budget H*dt (and, for the MPC-flavored configs, the
replan period dt — the budget that matters for a receding-horizon loop).

Two latency columns per config:

* ``p50_call_s`` — plain jitted-call latency (reference protocol:
  1 warmup + N reps + ``block_until_ready``), host dispatch included.
* ``p50_chip_s`` — dispatch-amortized: K solves chained data-dependently
  inside ONE program / K (examples/runtime_benchmark.py --amortize
  methodology), i.e. what the device itself takes per solve.

Usage: python examples/p50_budget.py [--reps 10] [--out bench_results/p50_budget.json]
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import ipoc_tpu
from ipoc_tpu.models import cartpole, double_integrator, pendulum
from ipoc_tpu.solvers.batched import make_batch
from ipoc_tpu.solvers.stream import solve_stream_multigrid
from ipoc_tpu.utils.compile_cache import use_compile_cache


def p50(fn, *args, reps):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def chained(solver, ocp, u0, x0, cfg, K):
    def chain(u, x):
        def body(dep, _):
            uo, _ = solver(ocp, u + dep, x, cfg)
            return uo[0, 0] * jnp.asarray(1e-30, u.dtype), 0

        dep, _ = jax.lax.scan(body, jnp.zeros((), u.dtype), None, length=K)
        return dep

    return jax.jit(chain)


def single_config(name, model_ocp, u0, x0, solver, cfg, H, dt, reps, K=8):
    f = jax.jit(lambda u, x: solver(model_ocp, u, x, cfg)[0])
    call = p50(f, u0, x0, reps=reps)
    chip = p50(chained(solver, model_ocp, u0, x0, cfg, K), u0, x0,
               reps=max(3, reps // 3)) / K
    return {
        "config": name,
        "horizon": H,
        "dt": dt,
        "p50_call_s": round(call, 6),
        "p50_chip_s": round(chip, 6),
        "budget_h_dt_s": H * dt,
        "budget_replan_s": dt,
        "within_h_dt": bool(chip <= H * dt),
        "within_replan": bool(chip <= dt),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="bench_results/p50_budget.json")
    ap.add_argument("--pool", type=int, default=65536,
                    help="config-5 scenario pool (BASELINE: 65k)")
    args = ap.parse_args()
    use_compile_cache()
    rows = []
    reps = args.reps

    # 1. Linear MPC analog: double integrator, H=60, sequential IP Newton
    #    (BASELINE config 1; reference linear_mpc_parallel.py:24-81 uses
    #    dt=0.001 — budget is the replan period).
    H, dt = 60, 0.001
    ocp = double_integrator.make_ocp(dt)
    # reference linear-MPC initial state (linear_mpc_parallel.py:30-64)
    x0 = jnp.array([2.0, 1.0], jnp.float32)
    u0 = jnp.zeros((H, 1), jnp.float32)
    rows.append(single_config(
        "linear-mpc double-integrator H=60 seq", ocp, u0, x0,
        ipoc_tpu.seq_interior_point_optimal_control, ipoc_tpu.FAST_CONFIG,
        H, dt, reps))

    # 2. Constrained pendulum swing-up H=100, parallel-scan IP Newton.
    H, dt = 100, 0.01
    ocp = pendulum.make_ocp(dt)
    x0 = pendulum.initial_state(jnp.float32)
    u0 = (0.1 * jax.random.normal(jax.random.PRNGKey(1), (H, 1))).astype(
        jnp.float32)
    rows.append(single_config(
        "pendulum H=100 par", ocp, u0, x0,
        ipoc_tpu.par_interior_point_optimal_control, ipoc_tpu.FAST_CONFIG,
        H, dt, reps))

    # 3. Cartpole H=100, parallel IP, input+STATE constraints
    #    (cart_limit box; BASELINE config 3).
    H, dt = 100, 0.01
    ocp = cartpole.make_ocp(dt, cart_limit=0.3)
    x0 = cartpole.initial_state(jnp.float32)
    u0 = (0.1 * jax.random.normal(jax.random.PRNGKey(1), (H, 1))).astype(
        jnp.float32)
    rows.append(single_config(
        "cartpole H=100 par input+state", ocp, u0, x0,
        ipoc_tpu.par_interior_point_optimal_control, ipoc_tpu.FAST_CONFIG,
        H, dt, reps))

    # 4. Batched cartpole: 4096 scenarios, one chip (multigrid stream —
    #    the headline executor).  p50 = whole-batch latency; per-solve is
    #    amortized across the batch.
    H, dt = 100, 0.01
    B = 4096
    ocp = cartpole.make_ocp(dt)
    ocp_c = cartpole.make_ocp(dt * 4)
    x0 = cartpole.initial_state(jnp.float32)
    u0b, x0b = make_batch(jax.random.PRNGKey(1), x0, B, H, 1,
                          state_scale=0.01, control_scale=0.1,
                          dtype=jnp.float32)
    cfg = ipoc_tpu.BATCH_CONFIG
    step = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, cfg, lanes=B, refill_every=16).iterations)
    t = p50(step, u0b, x0b, reps=max(3, reps // 2))
    rows.append({
        "config": "batched cartpole 4096 scenarios (mg stream)",
        "horizon": H, "dt": dt,
        "p50_batch_s": round(t, 6),
        "p50_chip_s": round(t / B, 9),
        "budget_h_dt_s": H * dt, "budget_replan_s": dt,
        "within_h_dt": bool(t / B <= H * dt),
        "within_replan": bool(t / B <= dt),
        "note": "p50_chip_s is batch-amortized per solve",
    })

    # 5. A deep pool drained on one device (streams are embarrassingly
    #    parallel across devices, solvers/stream.py solve_stream_sharded).
    N = args.pool
    reps5 = 3
    u0N = jnp.tile(u0b, (max(1, N // B), 1, 1))[:N]
    x0N = jnp.tile(x0b, (max(1, N // B), 1))[:N]
    step5 = jax.jit(lambda u, x: solve_stream_multigrid(
        ocp, ocp_c, 4, u, x, cfg, lanes=B, refill_every=16).iterations)
    t = p50(step5, u0N, x0N, reps=reps5)
    rows.append({
        "config": f"deep pool {N} scenarios (one device)",
        "horizon": H, "dt": dt,
        "p50_pool_s": round(t, 6),
        "p50_chip_s": round(t / N, 9),
        "solves_per_sec": round(N / t, 1),
        "budget_h_dt_s": H * dt, "budget_replan_s": dt,
        "within_h_dt": bool(t / N <= H * dt),
        "within_replan": bool(t / N <= dt),
        "note": "pool-amortized per solve",
    })

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    payload = {"platform": jax.devices()[0].platform,
               "device_kind": jax.devices()[0].device_kind, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    for r in rows:
        print(json.dumps(r))
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
