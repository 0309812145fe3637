"""Runtime benchmark: the reference (dt, H) sweep for pendulum and cartpole.

The equivalent of examples/pendulum_runtime.py and
examples/cartpole_runtime.py in the reference (which have no CLI and
duplicate the whole harness per model): one driver, reference protocol
(jit + 1 warmup + N timed reps with block_until_ready, mean and median),
CSV per solver plus a JSONL record per configuration.

Usage:
    python examples/runtime_benchmark.py --model pendulum --reps 10
    python examples/runtime_benchmark.py --model cartpole --horizons 20,100
    python examples/runtime_benchmark.py --model pendulum --dtype float64 --platform cpu
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["pendulum", "cartpole", "quadrotor"],
               default="pendulum")
    p.add_argument("--solvers", default="par,seq,ddp")
    p.add_argument(
        "--horizons", default="20,40,80,100,200,400,800,1000",
        help="reference sweep keeps H*dt = 1s (pendulum_runtime.py:74-75)",
    )
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--platform", default=None, help="e.g. cpu to force CPU")
    p.add_argument("--outdir", default="bench_results")
    p.add_argument(
        "--amortize", type=int, default=0, metavar="K",
        help="also measure dispatch-amortized per-solve latency: K solves "
        "chained data-dependently inside ONE jitted program (a negligible "
        "but dynamic epsilon of solve i feeds solve i+1's warm start so "
        "XLA cannot parallelize or hoist them), total time / K.  Removes "
        "the per-call host dispatch cost from the per-solve number.",
    )
    p.add_argument(
        "--amortize-reps", type=int, default=3,
        help="timed repetitions of the K-chain (median reported)",
    )
    p.add_argument(
        "--save-controls", action="store_true",
        help="also write {model}_controls_{dtype}.npz with the converged "
        "controls per (solver, horizon) for cross-precision agreement "
        "checks (examples/sweep_agreement.py)",
    )
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    import ipoc_tpu
    from ipoc_tpu.models import cartpole, pendulum, quadrotor
    from ipoc_tpu.utils.compile_cache import use_compile_cache
    from ipoc_tpu.utils.timing import time_fn

    use_compile_cache()

    model = {"pendulum": pendulum, "cartpole": cartpole,
             "quadrotor": quadrotor}[args.model]
    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64
    solvers = {
        "par": ipoc_tpu.par_interior_point_optimal_control,
        "seq": ipoc_tpu.seq_interior_point_optimal_control,
        "ddp": ipoc_tpu.interior_point_ddp,
    }
    wanted = args.solvers.split(",")
    horizons = [int(h) for h in args.horizons.split(",")]
    cfg = ipoc_tpu.FAST_CONFIG if args.dtype == "float32" else ipoc_tpu.DEFAULT_CONFIG

    os.makedirs(args.outdir, exist_ok=True)
    rows = {name: [] for name in wanted}
    controls = {}
    jsonl_path = os.path.join(args.outdir, f"{args.model}_runtime.jsonl")

    with open(jsonl_path, "w") as jf:
        for H in horizons:
            dt = 1.0 / H  # reference: horizon * dt = 1 s
            ocp = model.make_ocp(dt)
            x0 = model.initial_state(dtype)
            if args.model == "quadrotor":
                # barrier-feasible hover warm start (thrust box excludes 0)
                u0 = quadrotor.hover_controls(H, dtype)
            else:
                u0 = (
                    0.1 * jax.random.normal(jax.random.PRNGKey(1), (H, 1))
                ).astype(dtype)
            for name in wanted:
                solver = solvers[name]
                f = jax.jit(lambda u, x, s=solver: s(ocp, u, x, cfg)[0])
                mean_s, median_s, _ = time_fn(f, u0, x0, reps=args.reps)
                u_opt, iters = jax.jit(
                    lambda u, x, s=solver: s(ocp, u, x, cfg)
                )(u0, x0)
                rec = {
                    "model": args.model,
                    "solver": name,
                    "horizon": H,
                    "dt": dt,
                    "dtype": args.dtype,
                    "mean_s": mean_s,
                    "median_s": median_s,
                    "iterations": int(iters),
                    "max_abs_u": float(jnp.abs(u_opt).max()),
                }
                if args.amortize > 0:
                    K = args.amortize

                    def chain(u, x, s=solver):
                        # A dynamic-but-negligible epsilon of each solve
                        # feeds the next warm start: the K solves execute
                        # strictly sequentially (a multiply-by-zero
                        # dependence would be folded away, so use a
                        # magnitude that underflows in the add instead).
                        def body(dep, _):
                            uo, _ = s(ocp, u + dep, x, cfg)
                            return uo[0, 0] * jnp.asarray(1e-30, u.dtype), 0
                        dep, _ = jax.lax.scan(
                            body, jnp.zeros((), u.dtype), None, length=K
                        )
                        return dep

                    fc = jax.jit(chain)
                    _, med_chain, _ = time_fn(
                        fc, u0, x0, reps=args.amortize_reps
                    )
                    rec["amortized_s"] = med_chain / K
                    rec["amortize_k"] = K
                print(json.dumps(rec))
                jf.write(json.dumps(rec) + "\n")
                rows[name].append((H, mean_s, median_s))
                if args.save_controls:
                    import numpy as np

                    controls[f"{name}_h{H}"] = np.asarray(u_opt)

    if args.save_controls:
        import numpy as np

        npz = os.path.join(
            args.outdir, f"{args.model}_controls_{args.dtype}.npz"
        )
        np.savez(npz, **controls)
        print(f"wrote {npz}", file=sys.stderr)

    for name, data in rows.items():
        path = os.path.join(args.outdir, f"{args.model}_ip_{name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["horizon", "mean_s", "median_s"])
            w.writerows(data)
    print(f"wrote CSVs + {jsonl_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
