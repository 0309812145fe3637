"""Speed-of-light (roofline) accounting for the throughput path.

Answers "is X solves/s fast, or 10x off?" by putting a measured rate
against the device's published peaks:

1. Counts the algorithmic FLOPs of ONE Newton iteration of the benchmark
   configuration with XLA's own cost analysis on the UNFUSED one-iteration
   program (``flat_lane_iter`` with the plain-scan evaluator — numerically
   identical math to the fused kernel path, so its FLOP count is the
   honest numerator for the kernel path too, which XLA cannot inspect).
2. Multiplies by measured {solves/s x mean iterations} to get achieved
   FLOP/s, and divides by the float32 peak of the device it runs on.
3. Reports the analytic per-lane working set and achieved device-memory
   bandwidth, and classifies the step as compute-, bandwidth-, or
   overhead-bound.

The work is float32 on CUDA cores (4x4 blocks, no tensor cores), so the
compute peak is the plain float32 rate.  Peaks are keyed by
``device_kind``; a device missing from ``PEAKS`` is an error.

Usage:
    # FLOP counting only (any platform):
    python examples/roofline.py --model cartpole --horizon 100

    # full roofline from a measurement on the GPU:
    python examples/roofline.py --model cartpole --horizon 100 \
        --solves-per-sec <measured> --mean-iters <measured>
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published peaks by ``jax.Device.device_kind``: float32 without tensor
# cores (TFLOP/s) and device-memory bandwidth (TB/s).  Source: NVIDIA H100
# data sheet, SXM part, at its 700 W limit; a card set to a lower power
# limit cannot hold these under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_tflops": 67.0, "hbm_tbs": 3.35},
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise SystemExit(f"roofline: no published peaks for device "
                         f"{device_kind!r}; add it to PEAKS") from None


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="cartpole")
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--batch", type=int, default=2048,
                   help="lanes, for the batched FLOP count")
    p.add_argument("--solves-per-sec", type=float, default=None)
    p.add_argument("--mean-iters", type=float, default=None,
                   help="mean Newton iterations per solve (chip_smoke.py "
                   "or bench.py output)")
    p.add_argument("--path", choices=["fused", "unfused"], default="fused",
                   help="which working-set model to normalize bytes with "
                   "(BATCH_CONFIG streams run the fused kernel)")
    p.add_argument("--platform", default=None)
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp

    import ipoc_tpu
    from ipoc_tpu.models import cartpole, pendulum, quadrotor, unicycle
    from ipoc_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    from ipoc_tpu.solvers.ip_newton import FlatLane, flat_lane_init, flat_lane_iter

    model = {"cartpole": cartpole, "pendulum": pendulum,
             "quadrotor": quadrotor, "unicycle": unicycle}[args.model]
    H = args.horizon
    ocp = model.make_ocp(1.0 / H)
    x0 = model.initial_state(jnp.float32)
    nx = x0.shape[0]
    nu = 2 if args.model in ("quadrotor", "unicycle") else 1

    # The unfused one-iteration program, batched over lanes: identical
    # mathematics to the fused kernel path (fused_iter_kernel docstring),
    # countable by XLA.
    cfg = ipoc_tpu.BATCH_CONFIG.replace(
        newton_impl="seq", stage_predictor=False
    )

    def one_iter(lane):
        return flat_lane_iter(ocp, lane, cfg)

    u0 = 0.1 * jnp.ones((args.batch, H, nu), jnp.float32)
    x0b = jnp.broadcast_to(x0, (args.batch, nx))
    lane0 = jax.vmap(lambda u, x: flat_lane_init(ocp, u, x, cfg))(u0, x0b)
    compiled = jax.jit(jax.vmap(one_iter)).lower(lane0).compile()
    ca = compiled.cost_analysis()
    flops_per_step = float(ca.get("flops", 0.0))
    xla_bytes_per_step = float(ca.get("bytes accessed", 0.0))
    flops_per_lane_iter = flops_per_step / args.batch

    # Analytic per-lane working sets per iteration.
    # * unfused: trajectory + controls read/written twice (trial build and
    #   accept) PLUS the per-stage Newton data r/Q/R/M/fx/fu staged through
    #   HBM between the derivative phase and the Riccati kernel.
    # * fused (the production BATCH_CONFIG path): the two-launch kernel
    #   re-derives the model IN-KERNEL (fused_iter_kernel.py) — only the
    #   lane state (x, u) and the gains cross device memory, ~2 reads +
    #   2 writes of the lane state per iteration.
    stage_data = nu + nx * nx + nu * nu + nx * nu + nx * nx + nx * nu
    lane_state = (H + 1) * nx + H * nu
    bytes_unfused = 4.0 * (2 * 2 * lane_state + H * stage_data)
    bytes_fused = 4.0 * (2 * 2 * lane_state)

    out = {
        "model": args.model, "horizon": H, "nx": nx, "nu": nu,
        "batch": args.batch,
        "flops_per_lane_iter": flops_per_lane_iter,
        "xla_bytes_per_lane_iter": xla_bytes_per_step / args.batch,
        "analytic_bytes_per_lane_iter_unfused": bytes_unfused,
        "analytic_bytes_per_lane_iter_fused": bytes_fused,
        "counted_on_platform": jax.devices()[0].platform,
    }

    if args.solves_per_sec and args.mean_iters:
        kind = jax.devices()[0].device_kind
        peak = peaks_for(kind)
        iters_per_sec = args.solves_per_sec * args.mean_iters
        achieved_flops = iters_per_sec * flops_per_lane_iter
        path_bytes = bytes_fused if args.path == "fused" else bytes_unfused
        achieved_tbs = iters_per_sec * path_bytes / 1e12
        out.update({
            "device_kind": kind,
            "path": args.path,
            "solves_per_sec": args.solves_per_sec,
            "mean_iters": args.mean_iters,
            "iters_per_sec": iters_per_sec,
            "achieved_tflops": achieved_flops / 1e12,
            "pct_of_fp32_peak": 100 * achieved_flops
            / (peak["fp32_tflops"] * 1e12),
            "achieved_hbm_tbs_analytic": achieved_tbs,
            "pct_of_hbm_peak": 100 * achieved_tbs / peak["hbm_tbs"],
        })
        # Whichever of {compute, bandwidth} holds the larger fraction
        # binds; if both are < 25%, the step is overhead-bound (kernel
        # launches, glue ops, while-loop predicates).
        c = out["pct_of_fp32_peak"]
        b = out["pct_of_hbm_peak"]
        out["bound"] = (
            "overhead" if max(c, b) < 25.0
            else ("compute" if c >= b else "bandwidth")
        )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
