"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

Phases (each prints its findings; any failure raises, exits nonzero and
prints no ``ok`` line):

1. device   — every JAX device is a GPU; the card's name and power limit,
               the JAX version and the matmul precision in effect.
2. kernel   — the fused lane-iteration kernel (Pallas through Triton)
               against the plain XLA composition it replaces, on the card,
               at 4096 lanes: cartpole T=100 and quadrotor T=40.
3. stream   — the cold-pool stream (``solve_stream_multigrid`` and
               ``solve_stream``, cartpole H=100, 4096 lanes, 4x4096
               scenarios) with the kernel in the compiled program; a
               64-scenario subsample re-solved in float64 on the card.
4. single   — pendulum H=100: par / seq / DDP agreement in float32 and
               float64, and the float64 parallel solve against its CPU run.
5. nmpc     — 256 cartpole NMPC controllers for 5 replan steps.
6. timing   — information only: one lane iteration and the stream's
               solves/s, kernel against plain XLA.

With ``--devices 4`` it runs, on four cards of one host, the batch-sharded
stream against the one-card stream on the same 16384-scenario pool, and
the horizon-sharded solve at T=1000 against the one-card solve, printing
how each input is laid out across devices.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

LANES = 4096
HORIZON = 100
REFILL = 32
COARSEN = 4
POOL = 4 * LANES
LONG_HORIZON = 1000  # the horizon-sharded solve


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Problem builders (shared with the CPU rehearsal of the sharded phase)
# ---------------------------------------------------------------------------


def iterate(model, T, B, seed=0):
    """A random iterate ``(ocp, x, u, bp, reg)`` of ``B`` lanes in float32:
    perturbed warm starts rolled out through the dynamics, per-lane barrier
    parameters in [1e-3, 1e-1] and Levenberg shifts in [1, 1e3]
    (log-uniform), where the backward pass is convex on nearly every
    lane."""
    import jax
    import jax.numpy as jnp

    from ipoc_tpu.models import quadrotor
    from ipoc_tpu.solvers.batched import make_batch
    from ipoc_tpu.utils.integrators import rollout

    f32 = jnp.float32
    quad = model is quadrotor
    nu = 2 if quad else 1
    ocp = model.make_ocp(0.05 if quad else 1.0 / T)
    u0, x0b = make_batch(jax.random.PRNGKey(seed), model.initial_state(f32),
                         B, T, nu, state_scale=0.05, control_scale=0.1,
                         dtype=f32)
    if quad:
        u0 = u0 + quadrotor.hover_controls(T, f32)[None]
    x = jax.jit(jax.vmap(lambda u, x0: rollout(ocp.dynamics, u, x0)))(
        u0, x0b)
    kb, kr = jax.random.split(jax.random.PRNGKey(seed + 1))
    bp = 10.0 ** jax.random.uniform(kb, (B,), f32, -3.0, -1.0)
    reg = 10.0 ** jax.random.uniform(kr, (B,), f32, 0.0, 3.0)
    return ocp, x, u0, bp, reg


def cartpole_pool(n, seed=1):
    """The cold pool of the main path: ``make_batch`` with PRNGKey(1)."""
    import jax
    import jax.numpy as jnp

    from ipoc_tpu.models import cartpole
    from ipoc_tpu.solvers.batched import make_batch

    T = HORIZON
    ocp = cartpole.make_ocp(1.0 / T)
    u0, x0b = make_batch(jax.random.PRNGKey(seed),
                         cartpole.initial_state(jnp.float32), n, T, 1,
                         state_scale=0.01, control_scale=0.1,
                         dtype=jnp.float32)
    return ocp, u0, x0b


def raw_cost_fn(ocp):
    """Stage plus final cost of the controls' rollout with a vanishing
    barrier weight: the quality the pool's users get."""
    import jax
    import jax.numpy as jnp

    from ipoc_tpu.utils.integrators import rollout

    def raw(u, x0):
        x = rollout(ocp.dynamics, u, x0)
        return ocp.total_cost(x, u, jnp.asarray(1e-9, u.dtype))

    return jax.jit(jax.vmap(raw))


def layout(name, arr) -> str:
    """How ``arr`` is laid out over devices: shard shape per device id."""
    shards = sorted((s.device.id, tuple(s.data.shape))
                    for s in arr.addressable_shards)
    return f"{name} {tuple(arr.shape)}: " + ", ".join(
        f"dev{d}{shape}" for d, shape in shards)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def kernel_calls(text: str) -> int:
    """Number of Triton custom calls in a lowered program; requires both
    launches of the fused lane iteration among them (the kernel ran, not
    the plain composition)."""
    from ipoc_tpu.ops.pallas.fused_iter_kernel import BWD_NAME, FWD_NAME

    n = text.count("__gpu$xla.gpu.triton")
    require(n >= 2 and BWD_NAME in text and FWD_NAME in text,
            f"the program does not call the fused kernel ({n} Triton "
            "custom calls)")
    return n


def phase_kernel(name, model, T):
    import jax
    import numpy as np

    from ipoc_tpu.ops.pallas.fused_iter_kernel import (
        _fused_reference,
        fused_newton_iter_batched,
    )

    ocp, x, u, bp, reg = iterate(model, T, LANES)
    feasible = np.isfinite(np.asarray(jax.jit(jax.vmap(ocp.total_cost))(
        x, u, bp)))
    ker_fn = jax.jit(lambda *a: fused_newton_iter_batched(
        ocp, *a, with_pivot=True))
    ref_fn = jax.jit(jax.vmap(
        lambda a, b, c, d: _fused_reference(ocp, a, b, c, d)))
    ker = [np.asarray(a) for a in ker_fn(x, u, bp, reg)]
    ref = [np.asarray(a) for a in ref_fn(x, u, bp, reg)]
    piv = ker.pop()
    require(feasible.mean() >= 0.99,
            f"{name}: only {feasible.mean():.4f} of the iterates feasible")
    # ok flags: equal, except where the minimum pivot is within 1e-6 of 0
    # (the kernel's unpivoted elimination and the reference's Cholesky then
    # legitimately disagree about definiteness).
    diff = (ker[6] != ref[6]) & feasible
    require(not (diff & (np.abs(piv) > 1e-6)).any(),
            f"{name}: bwd_ok differs on {int(diff.sum())} lanes "
            f"away from a zero pivot")
    m = feasible & ker[6] & ref[6]
    require(m.mean() >= 0.9, f"{name}: only {m.mean():.3f} of lanes ok")
    # 1e-4 of each output's scale: both evaluate the same float32
    # recursion, but the kernel sums in another order (per-entry unrolled
    # dot products vs XLA's fused reductions) and eliminates where the
    # reference factors by Cholesky.
    errs = {}
    trial_ok = m & (ker[4] < 0) & (ref[4] < 0)
    names = ["temp_x", "temp_u", "cost", "new_cost", "max_c", "pred", "hu"]
    for nm, a, b in zip(names, ker[:6] + ker[7:], ref[:6] + ref[7:]):
        sel = trial_ok if nm == "new_cost" else m
        a, b = a[sel].astype(np.float64), b[sel].astype(np.float64)
        errs[nm] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
        require(errs[nm] <= 1e-4, f"{name}: {nm} off by {errs[nm]:.2e}")
    say("kernel", f"{name} T={T} B={LANES}: feasible {feasible.mean():.4f}, "
        f"both ok {m.mean():.4f}, ok flags differ on {int(diff.sum())} "
        f"(min |pivot| there "
        f"{float(np.abs(piv[diff]).min()) if diff.any() else 0:.1e}); "
        "max error / output scale " + " ".join(
            f"{k}={v:.1e}" for k, v in errs.items()) + " (limit 1e-4)")
    return ocp, x, u, bp, reg, ker_fn, ref_fn


def phase_stream(timing):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ipoc_tpu
    from ipoc_tpu.models import cartpole
    from ipoc_tpu.ops.pallas.fused_iter_kernel import BWD_NAME, FWD_NAME
    from ipoc_tpu.solvers.ip_newton import flat_total_cap
    from ipoc_tpu.solvers.stream import solve_stream, solve_stream_multigrid

    cfg = ipoc_tpu.BATCH_CONFIG
    ocp, u0, x0b = cartpole_pool(POOL)
    ocp_c = cartpole.make_ocp(COARSEN / HORIZON)

    def mg(c):
        return jax.jit(lambda u, x: solve_stream_multigrid(
            ocp, ocp_c, COARSEN, u, x, c, lanes=LANES, refill_every=REFILL,
            coarse_impl="ddp"))

    def sg(c):
        return jax.jit(lambda u, x: solve_stream(
            ocp, u, x, c, lanes=LANES, refill_every=REFILL))

    t0 = time.perf_counter()
    lowered = mg(cfg).lower(u0, x0b)
    n_calls = kernel_calls(lowered.as_text())
    mg_run = lowered.compile()
    say("stream", f"multigrid program holds {n_calls} Triton custom calls "
        f"({BWD_NAME}, {FWD_NAME}); lowered+compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    sg_run = sg(cfg)
    raw = raw_cost_fn(ocp)
    cap = flat_total_cap(cfg)
    sols = {}
    for label, run in (("multigrid", mg_run), ("single-grid", sg_run)):
        sol = run(u0, x0b)
        u = np.asarray(sol.controls)
        it = np.asarray(sol.iterations)
        require(np.isfinite(u).all(), f"{label}: non-finite controls")
        umax = float(np.abs(u).max())
        require(umax <= cartpole.CONTROL_BOUND,
                f"{label}: |u| {umax} beyond {cartpole.CONTROL_BOUND}")
        below = float((it < cap).mean())
        require(below >= 0.99, f"{label}: only {below:.4f} below the cap")
        say("stream", f"{label}: N={POOL}, max|u|={umax:.4f} (bound "
            f"{cartpole.CONTROL_BOUND}), iterations mean {it.mean():.2f} "
            f"p99 {np.percentile(it, 99):.0f} max {it.max()}, "
            f"{below:.4f} below the cap {cap}, lockstep steps "
            f"{int(sol.steps)}")
        sols[label] = sol

    # float64 re-solve of a 64-scenario subsample with the sequential
    # reference solver, on the card.
    n = min(64, POOL)
    with jax.enable_x64(True):
        u64 = jnp.asarray(np.asarray(u0[:n]), jnp.float64)
        x64 = jnp.asarray(np.asarray(x0b[:n]), jnp.float64)
        ocp64 = cartpole.make_ocp(1.0 / HORIZON)
        seq = jax.jit(jax.vmap(
            lambda u, x: ipoc_tpu.seq_interior_point_optimal_control(
                ocp64, u, x, ipoc_tpu.FAST_CONFIG)))
        u_ref, it_ref = seq(u64, x64)
        raw64 = raw_cost_fn(ocp64)
        c_ref = np.asarray(raw64(u_ref, x64))
        for label, sol in sols.items():
            c = np.asarray(raw64(jnp.asarray(
                np.asarray(sol.controls[:n]), jnp.float64), x64))
            rel = np.abs(c - c_ref) / np.abs(c_ref)
            switched = rel > 1e-3
            require(switched.mean() < 0.05,
                    f"{label}: {switched.mean():.3f} of scenarios switched")
            worst = float(rel[~switched].max())
            require(worst <= 1e-4,
                    f"{label}: raw cost {worst:.2e} from float64")
            say("stream", f"{label} vs float64 seq on {n} scenarios: "
                f"{int(switched.sum())} switched basin (rel > 1e-3), the "
                f"rest within {worst:.1e} (limit 1e-4); float64 iterations "
                f"mean {np.asarray(it_ref).mean():.1f}")

    if timing:
        sg_xla = sg(cfg.replace(newton_impl="seq"))
        mg_xla = mg(cfg.replace(newton_impl="seq"))
        rates = {}
        for label, fn in (("multigrid kernel", mg_run),
                          ("multigrid xla", mg_xla),
                          ("single-grid kernel", sg_run),
                          ("single-grid xla", sg_xla)):
            rates[label] = POOL / median_time(fn, u0, x0b, reps=3)
        return rates
    return None


def phase_single():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ipoc_tpu
    from ipoc_tpu.models import pendulum

    T = 100
    solvers = {"par": ipoc_tpu.par_interior_point_optimal_control,
               "seq": ipoc_tpu.seq_interior_point_optimal_control,
               "ddp": ipoc_tpu.interior_point_ddp}
    for dtype, cfg in ((jnp.float32, ipoc_tpu.FAST_CONFIG),
                       (jnp.float64, ipoc_tpu.DEFAULT_CONFIG)):
        with jax.enable_x64(dtype == jnp.float64):
            ocp = pendulum.make_ocp(0.01)
            u0 = (0.1 * jax.random.normal(jax.random.PRNGKey(1), (T, 1))
                  ).astype(dtype)
            x0 = pendulum.initial_state(dtype)
            raw = raw_cost_fn(ocp)
            us, its, costs = {}, {}, {}
            for nm, f in solvers.items():
                u, it = jax.jit(lambda a, b, f=f: f(ocp, a, b, cfg))(u0, x0)
                us[nm], its[nm] = np.asarray(u), int(it)
                require(np.isfinite(us[nm]).all(), f"{nm}: non-finite u")
                costs[nm] = float(raw(u[None], x0[None])[0])
            gap = {nm: float(np.abs(us[nm] - us["par"]).max())
                   for nm in ("seq", "ddp")}
            head = {nm: float(np.abs(us[nm] - us["par"])[:T - 10].max())
                    for nm in ("seq", "ddp")}
            cgap = max(abs(costs[nm] / costs["par"] - 1.0)
                       for nm in ("seq", "ddp"))
            label = np.dtype(dtype).name
            if dtype == jnp.float64:
                # the CPU run of this solve: 67 iterations, max|u| 4.99967
                require(abs(its["par"] - 67) <= 1,
                        f"float64 par took {its['par']} iterations")
                umax = float(np.abs(us["par"]).max())
                require(abs(umax - 4.99967) < 1e-4, f"max|u| {umax}")
                require(max(gap.values()) <= 1e-3,
                        f"float64 solvers disagree by {gap}")
            # float32 agrees on the cost only: over the final stages, where
            # the cost is flat in u, the three solvers stop at points up to
            # 1e-1 apart in u (the CPU run shows the same gap).
            require(cgap <= 1e-5, f"{label}: raw costs differ by {cgap:.1e}")
            say("single", f"pendulum H={T} {label}: iterations {its}, "
                f"max|u_par|={np.abs(us['par']).max():.5f}, max|u - u_par| "
                f"{ {k: f'{v:.1e}' for k, v in gap.items()} } (first "
                f"{T - 10} stages "
                f"{ {k: f'{v:.1e}' for k, v in head.items()} }), raw cost "
                f"spread {cgap:.1e}")


def phase_nmpc():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ipoc_tpu
    from ipoc_tpu.models import cartpole
    from ipoc_tpu.mpc import nmpc_loop

    n, steps = 256, 5
    ocp, _, x0b = cartpole_pool(n)
    cfg = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=25)

    def solve(u_warm, x):
        return ipoc_tpu.par_interior_point_optimal_control(
            ocp, u_warm, x, cfg)[0]

    loop = jax.jit(jax.vmap(
        lambda x, u: nmpc_loop(solve, ocp.dynamics, x, u, steps)))
    xs, us = loop(x0b, jnp.zeros((n, HORIZON, 1), jnp.float32))
    xs, us = np.asarray(xs), np.asarray(us)
    require(np.isfinite(xs).all() and np.isfinite(us).all(),
            "NMPC: non-finite states or controls")
    umax = float(np.abs(us).max())
    require(umax <= cartpole.CONTROL_BOUND, f"NMPC: |u| {umax}")
    say("nmpc", f"{n} cartpole controllers x {steps} steps: max|u|="
        f"{umax:.4f} (bound {cartpole.CONTROL_BOUND}), all finite")


def phase_four(devices):
    """Batch-sharded stream and horizon-sharded solve on four devices,
    each against its one-device counterpart.  Both comparisons run; their
    failed checks are raised together at the end."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import ipoc_tpu
    from ipoc_tpu.models import cartpole
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.solvers.stream import solve_stream, solve_stream_sharded
    from ipoc_tpu.solvers.time_sharded import ip_newton_time_sharded

    failed = []

    def check(cond, what):
        if not cond:
            say("four", f"FAILED: {what}")
            failed.append(what)

    one = devices[0]
    n_dev = len(devices)
    cfg = ipoc_tpu.BATCH_CONFIG
    ocp, u0, x0b = cartpole_pool(POOL)
    raw = raw_cost_fn(ocp)

    # Batch-sharded stream: each device drains its quarter of the pool.
    mesh = make_mesh(batch=n_dev, devices=devices)
    u_in = jax.device_put(u0, NamedSharding(mesh, P("batch", None, None)))
    x_in = jax.device_put(x0b, NamedSharding(mesh, P("batch", None)))
    say("four", layout("controls in (batch-sharded)", u_in))
    say("four", layout("initial states in (batch-sharded)", x_in))
    sharded = jax.jit(lambda u, x: solve_stream_sharded(
        ocp, u, x, mesh, cfg, lanes=LANES, refill_every=REFILL))
    got = jax.block_until_ready(sharded(u_in, x_in))
    say("four", layout("controls out", got.controls))
    u1, x1 = jax.device_put(u0, one), jax.device_put(x0b, one)
    say("four", layout("controls in (one device)", u1))
    single = jax.jit(lambda u, x: solve_stream(
        ocp, u, x, cfg, lanes=LANES, refill_every=REFILL))
    ref = jax.block_until_ready(single(u1, x1))
    check(len(got.controls.sharding.device_set) == n_dev,
          "the sharded stream did not use every device")
    it_g, it_r = np.asarray(got.iterations), np.asarray(ref.iterations)
    ug, ur = np.asarray(got.controls), np.asarray(ref.controls)
    rel = float(np.abs(ug - ur).max() / np.abs(ur).max())
    c_g = np.asarray(raw(jax.device_put(ug, one), x1))
    c_r = np.asarray(raw(ref.controls, x1))
    rate_sh = POOL / median_time(sharded, u_in, x_in, reps=3)
    rate_1 = POOL / median_time(single, u1, x1, reps=3)
    say("four", f"solve_stream_sharded over {n_dev} devices vs "
        f"solve_stream on one, N={POOL}: iterations differ on "
        f"{int((it_g != it_r).sum())} scenarios, controls on "
        f"{int((ug != ur).any(axis=(1, 2)).sum())}, max control gap "
        f"{rel:.1e} of scale (limit 1e-5), raw costs within "
        f"{float(np.abs(c_g - c_r).max() / np.abs(c_r).max()):.1e}; "
        f"solves/s {rate_sh:.1f} sharded vs {rate_1:.1f} one device "
        f"({card()})")
    check((it_g == it_r).all(), "sharded stream iterations differ")
    check(rel <= 1e-5, f"sharded stream controls off by {rel:.1e}")

    # Horizon-sharded IP Newton at T=1000 (float64, so the two combine
    # trees agree far below the stopping tolerance).
    T = LONG_HORIZON
    with jax.enable_x64(True):
        ocp_t = cartpole.make_ocp(1.0 / T)
        x0 = cartpole.initial_state(jnp.float64)
        u_init = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (T, 1),
                                         jnp.float64)
        tcfg = ipoc_tpu.FAST_CONFIG.replace(globalization="single")
        tmesh = make_mesh(time=n_dev, devices=devices)
        ut = jax.device_put(u_init, NamedSharding(tmesh, P("time", None)))
        say("four", layout("controls in (time-sharded)", ut))
        t0 = time.perf_counter()
        u_sh, it_sh = jax.block_until_ready(jax.jit(
            lambda u, x: ip_newton_time_sharded(ocp_t, u, x, tmesh, tcfg))(
                ut, x0))
        t_sh = time.perf_counter() - t0
        say("four", layout("controls out (time-sharded)", u_sh))
        t0 = time.perf_counter()
        u_1, it_1 = jax.block_until_ready(jax.jit(
            lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
                ocp_t, u, x, tcfg))(jax.device_put(u_init, one),
                                    jax.device_put(x0, one)))
        t_1 = time.perf_counter() - t0
        rel = float(np.abs(np.asarray(u_sh) - np.asarray(u_1)).max()
                    / np.abs(np.asarray(u_1)).max())
        say("four", f"ip_newton_time_sharded over {n_dev} devices vs "
            f"par_interior_point_optimal_control on one: T={T} float64, "
            f"{int(it_sh)} vs {int(it_1)} iterations, controls within "
            f"{rel:.1e} (limit 1e-6); first calls {t_sh:.1f} s vs "
            f"{t_1:.1f} s")
        check(int(it_sh) == int(it_1), "time-sharded iterations differ")
        check(rel <= 1e-6, f"time-sharded controls off by {rel:.1e}")
    require(not failed, "; ".join(failed))


def phase_timing(ker_fn, ref_fn, args, rates, smi):
    t_k = median_time(ker_fn, *args, reps=20)
    t_x = median_time(ref_fn, *args, reps=20)
    say("timing", f"one lane iteration, cartpole T={HORIZON} B={LANES}: "
        f"kernel {t_k * 1e3:.3f} ms, plain XLA {t_x * 1e3:.3f} ms "
        f"({smi})")
    for label, r in rates.items():
        say("timing", f"stream {label}: {r:.1f} solves/s "
            f"(cartpole H={HORIZON}, N={POOL}, {LANES} lanes; {smi})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        print(f"chip_smoke: needs GPUs, JAX found {platforms}",
              file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    devices = devices[:args.devices]

    import ipoc_tpu
    from ipoc_tpu.utils.compile_cache import use_compile_cache

    cache = use_compile_cache()
    smi = card()
    say("device", f"card: {smi}")
    say("device", f"{len(devices)} x {devices[0].device_kind}, jax "
        f"{jax.__version__}, ipoc_tpu {ipoc_tpu.__version__}, matmul "
        f"precision {jax.config.jax_default_matmul_precision}, compile "
        f"cache {cache}")

    if args.devices == 4:
        phase_four(devices)
    else:
        from ipoc_tpu.models import cartpole, quadrotor

        _, x, u, bp, reg, ker_fn, ref_fn = phase_kernel(
            "cartpole", cartpole, HORIZON)
        phase_kernel("quadrotor", quadrotor, 40)
        rates = phase_stream(timing=True)
        phase_single()
        phase_nmpc()
        phase_timing(ker_fn, ref_fn, (x, u, bp, reg), rates, smi)

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
