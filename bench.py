"""Benchmark driver: batched constrained-cartpole H=100 IP solves/s on a GPU.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Refuses to run (one JSON line with an ``"error"`` field, nonzero exit)
unless every JAX device is a GPU: a device metric has no CPU fallback.

Protocol follows the reference harness (1 untimed warmup to exclude compile,
then timed reps with ``block_until_ready``, median reported — reference
examples/cartpole_runtime.py:115-174), adapted to the throughput story: a
streamed pool of full interior-point solves per timed rep.

The default mode runs BOTH streaming executors and reports the FASTER
one as the ``value`` with its quality record attached: the multigrid
stream (coarse-to-fine, basin switching possible, gated against the
single-grid solutions) and the faithful single-grid stream (one cold solve
per scenario — reference semantics).  Both numbers always appear
(``"multigrid"`` / ``"single_grid"``).  Set IPOC_BENCH_QUALITY=0 to skip
the gate and report raw multigrid throughput.

Env knobs: IPOC_BENCH_BATCH (default 4096 lanes), IPOC_BENCH_POOL (default
32x lanes), IPOC_BENCH_REPS (default 5), IPOC_BENCH_HORIZON (default 100),
IPOC_BENCH_MODE (mg|stream|batch|nmpc), IPOC_BENCH_REFILL (default 32),
IPOC_BENCH_COARSEN (default 4), IPOC_BENCH_QUALITY (default 1 in mg and
stream modes), IPOC_BENCH_IMPL (''|seq|ddp), IPOC_BENCH_DDP_PREDICTOR
(0/1), IPOC_BENCH_NMPC_STEPS / IPOC_BENCH_NMPC_CAP (nmpc mode: closed-loop
steps per rep and Newton-iteration cap per warm resolve).
"""

import json
import os
import statistics
import sys
import time

MODEL = os.environ.get("IPOC_BENCH_MODEL", "cartpole")
BATCH = int(os.environ.get("IPOC_BENCH_BATCH", "4096"))
# Deep pools amortize the stream's drain tail: steps/scenario falls toward
# mean_iterations/lanes as generations grow.
POOL = int(os.environ.get("IPOC_BENCH_POOL", str(32 * BATCH)))
REPS = int(os.environ.get("IPOC_BENCH_REPS", "5"))
HORIZON = int(os.environ.get("IPOC_BENCH_HORIZON", "100"))
MODE = os.environ.get("IPOC_BENCH_MODE", "mg")
IMPL = os.environ.get("IPOC_BENCH_IMPL", "")
COARSEN = int(os.environ.get("IPOC_BENCH_COARSEN", "4"))
REFILL = int(os.environ.get("IPOC_BENCH_REFILL", "32"))
QUALITY = os.environ.get("IPOC_BENCH_QUALITY", "1") != "0"
DT = 1.0 / HORIZON  # reference sweep keeps H * dt = 1 s

NMPC_STEPS = int(os.environ.get("IPOC_BENCH_NMPC_STEPS", "25"))
NMPC_CAP = int(os.environ.get("IPOC_BENCH_NMPC_CAP", "25"))

METRIC = (f"{MODEL}_h{HORIZON}_"
          + (f"{IMPL}_" if IMPL else "")
          + ("nmpc_resolves_per_sec" if MODE == "nmpc"
             else "ip_solves_per_sec"))
UNIT = "resolves/s" if MODE == "nmpc" else "solves/s"


def emit_error(msg: str) -> None:
    print(json.dumps({
        "metric": METRIC, "value": None, "unit": UNIT, "error": msg[-2000:],
    }))


def run() -> dict:
    import jax

    devices = jax.devices()
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise RuntimeError(f"bench.py needs GPUs; JAX found {platforms}")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import ipoc_tpu
    from ipoc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    from ipoc_tpu.models import cartpole, pendulum, quadrotor, unicycle
    from ipoc_tpu.solvers.batched import make_batch, solve_batch
    from ipoc_tpu.solvers.stream import solve_stream, solve_stream_multigrid
    from ipoc_tpu.utils.integrators import rollout

    models = {"cartpole": cartpole, "pendulum": pendulum,
              "quadrotor": quadrotor, "unicycle": unicycle}
    model = models[MODEL]
    ocp = model.make_ocp(DT)
    x0 = model.initial_state(jnp.float32)
    n_scen = POOL if MODE in ("stream", "mg") else BATCH
    nu = 2 if MODEL in ("quadrotor", "unicycle") else 1
    u0, x0b = make_batch(
        jax.random.PRNGKey(1), x0, n_scen, HORIZON, nu,
        state_scale=0.01, control_scale=0.1, dtype=jnp.float32,
    )
    if MODEL == "quadrotor":
        # shift the random warm start around hover thrust (feasible box)
        u0 = u0 + quadrotor.hover_controls(HORIZON, jnp.float32)[None]
    cfg = ipoc_tpu.BATCH_CONFIG
    if os.environ.get("IPOC_BENCH_BARRIER"):
        cfg = cfg.replace(barrier_mode=os.environ["IPOC_BENCH_BARRIER"])
    if IMPL:
        # e.g. IPOC_BENCH_IMPL=ddp — IP-DDP through the same stream
        # machinery; seq/par select the Newton evaluator.
        cfg = cfg.replace(newton_impl=IMPL)
        if IMPL == "ddp":
            # Stage predictor on the DDP path, default on;
            # IPOC_BENCH_DDP_PREDICTOR=0 reverts to plain warm starts.
            pred = os.environ.get("IPOC_BENCH_DDP_PREDICTOR", "1")
            cfg = cfg.replace(stage_predictor=pred == "1")

    if MODE == "nmpc":
        # Warm-started NMPC throughput: B independent receding-horizon
        # controllers in lockstep, the whole closed loop ONE XLA program;
        # every step is a warm-started IP resolve from the previous plan
        # (reference MPC-loop semantics: examples/linear_mpc_parallel.py:
        # 67-81, warm start by re-solve).
        from ipoc_tpu.mpc import nmpc_loop

        ncfg = cfg.replace(max_newton_iters=NMPC_CAP)

        def solve(u_warm, x):
            u, _ = ipoc_tpu.par_interior_point_optimal_control(
                ocp, u_warm, x, ncfg
            )
            return u

        loop = jax.jit(jax.vmap(
            lambda x, u: nmpc_loop(solve, ocp.dynamics, x, u, NMPC_STEPS)
        ))
        u0b = jnp.zeros((BATCH, HORIZON, nu), jnp.float32)
        x0c = x0b[:BATCH]
        jax.block_until_ready(loop(x0c, u0b))
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            xs, us = jax.block_until_ready(loop(x0c, u0b))
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        n_resolves = BATCH * NMPC_STEPS
        return {
            "metric": METRIC,
            "value": round(n_resolves / med, 3),
            "unit": UNIT,
            "device": device,
            "nmpc": {
                "controllers": BATCH,
                "steps": NMPC_STEPS,
                "iter_cap": NMPC_CAP,
                "per_step_ms": round(med / NMPC_STEPS * 1e3, 3),
                "replan_budget_ms": round(DT * 1e3, 3),
                "max_abs_u": float(np.abs(np.asarray(us)).max()),
            },
        }

    mode = MODE
    if mode == "mg" and HORIZON % COARSEN != 0:
        print(f"# horizon {HORIZON} not divisible by coarsen {COARSEN}; "
              "falling back to single-grid stream", file=sys.stderr)
        mode = "stream"
    if mode == "mg":
        ocp_c = model.make_ocp(DT * COARSEN)
        # Coarse-level evaluator: the basin of a switched lane is decided
        # at the COARSE level, and a DDP coarse solve (nonlinear
        # closed-loop rollouts) lands switched lanes in quality-neutral
        # basins (scripts/mg_quality.py measures it).  Default "ddp" for
        # the Newton mg mode; IPOC_BENCH_MG_COARSE=fused reverts.  DDP
        # bench runs (IMPL=ddp) already use ddp everywhere.
        mg_coarse = os.environ.get("IPOC_BENCH_MG_COARSE", "ddp")
        step = jax.jit(lambda u, x: solve_stream_multigrid(
            ocp, ocp_c, COARSEN, u, x, cfg, lanes=BATCH,
            refill_every=REFILL,
            coarse_impl=None if mg_coarse == cfg.newton_impl else mg_coarse))
    elif mode == "stream":
        step = jax.jit(lambda u, x: solve_stream(
            ocp, u, x, cfg, lanes=BATCH, refill_every=REFILL))
    else:
        step = jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))

    # Warmup (compile) — excluded from timing, reference protocol.
    jax.block_until_ready(step(u0, x0b))

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        sol = jax.block_until_ready(step(u0, x0b))
        times.append(time.perf_counter() - t0)
    if os.environ.get("IPOC_BENCH_DEBUG"):
        print("times:", times, file=sys.stderr)
        print("iters:", sol.iterations.min(), sol.iterations.max(),
              file=sys.stderr)

    med = statistics.median(times)
    payload = {
        "metric": METRIC,
        "value": round(n_scen / med, 3),
        "unit": UNIT,
        "device": device,
    }

    if mode == "stream" and QUALITY:
        # Single-grid stream: one faithful cold solve per scenario
        # (reference semantics, par_interior_point_newton.py:228-254;
        # per-lane ≡ flat ≡ staged-single pinned by tests/test_stream.py) —
        # no basin-switch caveat by construction.  Report convergence
        # health + the pool's raw converged cost.
        def raw_cost(u, x0s):
            x = rollout(ocp.dynamics, u, x0s)
            return ocp.total_cost(x, u, jnp.asarray(1e-9, u.dtype))

        costs = np.asarray(jax.jit(jax.vmap(raw_cost))(sol.controls, x0b)
                           ).astype(np.float64)
        iters = np.asarray(sol.iterations)
        payload["quality"] = {
            "basin_switch_frac": 0.0,
            "mean_signed_rel_cost_delta_switched": 0.0,
            "semantics": "single-grid: one faithful cold solve/scenario",
            "mean_iterations": round(float(iters.mean()), 2),
            "max_iterations": int(iters.max()),
            "mean_raw_cost": float(costs.mean()),
            "frac_nonfinite_cost": float(
                (~np.isfinite(costs)).mean()),
        }

    if mode == "mg" and QUALITY:
        # The bench ``value`` is the faster of the multigrid stream (gate
        # attached) and the faithful single-grid stream (one cold solve
        # per scenario, reference semantics par:228-254), which rides
        # along under "single_grid" as provenance.
        mg_value = payload["value"]
        ref_step = jax.jit(lambda u, x: solve_stream(
            ocp, u, x, cfg, lanes=BATCH, refill_every=REFILL))
        jax.block_until_ready(ref_step(u0, x0b))
        sg_times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            ref_sol = jax.block_until_ready(ref_step(u0, x0b))
            sg_times.append(time.perf_counter() - t0)
        sg_med = statistics.median(sg_times)
        payload["single_grid"] = {
            "value": round(n_scen / sg_med, 3),
            "quality": {
                "basin_switch_frac": 0.0,
                "mean_signed_rel_cost_delta_switched": 0.0,
                "semantics":
                "single-grid: one faithful cold solve/scenario",
            },
        }

        def raw_cost(u, x0s):
            x = rollout(ocp.dynamics, u, x0s)
            return ocp.total_cost(x, u, jnp.asarray(1e-9, u.dtype))

        costs = jax.jit(jax.vmap(raw_cost))
        c_mg = np.asarray(costs(sol.controls, x0b)).astype(np.float64)
        c_sg = np.asarray(costs(ref_sol.controls, x0b)).astype(np.float64)
        rel = np.abs(c_mg - c_sg) / np.maximum(np.abs(c_sg), 1e-12)
        switched = rel > 1e-3  # different local basin, not noise
        matched = ~switched
        sg_value = payload["single_grid"]["value"]
        # The faster mode per run is the headline: mg where it buys speed,
        # the faithful single-grid stream where that is simply faster.
        payload["value"] = max(mg_value, sg_value)
        payload["multigrid"] = {
            "value": mg_value,
            "headline": bool(mg_value >= sg_value),
            "quality": {
                "basin_switch_frac": round(float(switched.mean()), 5),
                "mean_rel_cost_delta_matched": float(rel[matched].mean())
                if matched.any() else None,
                "max_rel_cost_delta_matched": float(rel[matched].max())
                if matched.any() else None,
                "mean_signed_rel_cost_delta_switched":
                float(((c_mg - c_sg) / np.maximum(np.abs(c_sg), 1e-12))
                      [switched].mean()) if switched.any() else 0.0,
            },
        }
        if switched.any():
            # Neutrality evidence beyond the mean: the win/loss split and
            # the standard error of the switched-lane mean (a symmetric
            # mix of comparable basins is neutral IN EXPECTATION; the mean
            # alone can sit a fraction of a percent off zero at finite
            # pool sizes).
            sw = ((c_mg - c_sg) / np.maximum(np.abs(c_sg), 1e-12))[switched]
            payload["multigrid"]["quality"].update({
                "switched_win_frac": round(float((sw < 0).mean()), 4),
                "switched_mean_sem": float(sw.std() / np.sqrt(sw.size)),
                "coarse_impl": mg_coarse,
            })
        if mg_value >= sg_value:
            payload["quality"] = payload["multigrid"]["quality"]
        else:
            payload["quality"] = payload["single_grid"]["quality"]
    return payload


def main():
    try:
        payload = run()
    except Exception as exc:  # noqa: BLE001 — one parseable line, always
        emit_error(f"{type(exc).__name__}: {exc}")
        sys.exit(1)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
