"""The fused lane-iteration kernel against plain XLA, on one GPU.

    python scripts/kernel_vs_xla.py [--out chiprun_out/kernel_vs_xla.jsonl]

For each configuration — the main path (cartpole H=100, multigrid and
single-grid streams), pendulum H=100 and cartpole T=1000 — it times, with
the card's name and power limit beside every number:

* one lane iteration at 4096 lanes: the Triton kernel against the vmapped
  plain composition (``_fused_reference``) it replaces, 10 alternating
  pairs;
* the stream's solves/s with ``newton_impl="fused"`` (the kernel) against
  ``"seq"`` (the same math as plain XLA), 3 alternating pairs.

For the main path it also splits one stream step (``flat_lane_iter`` over
4096 lanes) into the trial evaluation, the stage-transition rollouts and
the Levenberg scale's gradient, and traces one single-grid drain to read
the device's busy and idle share.  One JSON object per line goes to
``--out``; a summary goes to standard output.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import ipoc_tpu  # noqa: E402
from ipoc_tpu.models import cartpole, pendulum  # noqa: E402
from ipoc_tpu.ops.pallas.fused_iter_kernel import (  # noqa: E402
    _fused_reference,
    fused_newton_iter_batched,
)
from ipoc_tpu.solvers.batched import make_batch  # noqa: E402
from ipoc_tpu.solvers.ip_newton import (  # noqa: E402
    _lane_transition,
    flat_lane_init,
    flat_lane_iter,
)
from ipoc_tpu.solvers.stream import (  # noqa: E402
    solve_stream,
    solve_stream_multigrid,
)
from ipoc_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
from ipoc_tpu.utils.integrators import rollout  # noqa: E402

LANES = 4096
CFG = ipoc_tpu.BATCH_CONFIG
XLA = CFG.replace(newton_impl="seq")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, *args) -> float:
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def alternate(fa, fb, args, pairs):
    """Warm both, then ``pairs`` timed runs of each in the order a b b a
    a b ...; returns both lists of seconds."""
    jax.block_until_ready(fa(*args))
    jax.block_until_ready(fb(*args))
    ta, tb = [], []
    for i in range(pairs):
        if i % 2 == 0:
            ta.append(timed(fa, *args))
            tb.append(timed(fb, *args))
        else:
            tb.append(timed(fb, *args))
            ta.append(timed(fa, *args))
    return ta, tb


def summary(ts):
    q = np.percentile(ts, [25, 50, 75])
    return {"median_s": float(q[1]), "q1_s": float(q[0]),
            "q3_s": float(q[2]), "runs_s": [float(t) for t in ts]}


def pool(model, T, n):
    ocp = model.make_ocp(1.0 / T)
    u0, x0b = make_batch(jax.random.PRNGKey(1),
                         model.initial_state(jnp.float32), n, T, 1,
                         state_scale=0.01, control_scale=0.1,
                         dtype=jnp.float32)
    return ocp, u0, x0b


def lane_iteration(ocp, u0, x0b):
    X = jax.jit(jax.vmap(lambda u, x: rollout(ocp.dynamics, u, x)))(
        u0, x0b)
    bp = jnp.full((u0.shape[0],), 0.1, jnp.float32)
    reg = jnp.full((u0.shape[0],), 10.0, jnp.float32)
    ker = jax.jit(lambda *a: fused_newton_iter_batched(ocp, *a))
    ref = jax.jit(jax.vmap(
        lambda a, b, c, d: _fused_reference(ocp, a, b, c, d)))
    tk, tx = alternate(ker, ref, (X, u0, bp, reg), 10)
    return {"kernel": summary(tk), "xla": summary(tx)}


def stream_rates(ocp, u0, x0b, ocp_c=None, pairs=3):
    def make(cfg):
        if ocp_c is None:
            return jax.jit(lambda u, x: solve_stream(
                ocp, u, x, cfg, lanes=LANES, refill_every=32))
        return jax.jit(lambda u, x: solve_stream_multigrid(
            ocp, ocp_c, 4, u, x, cfg, lanes=LANES, refill_every=32,
            coarse_impl="ddp"))

    fk, fx = make(CFG), make(XLA)
    t0 = time.perf_counter()
    sol = jax.block_until_ready(fk(u0, x0b))
    setup_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fx(u0, x0b))
    setup_x = time.perf_counter() - t0
    tk, tx = alternate(fk, fx, (u0, x0b), pairs)
    n = u0.shape[0]
    return {"pool": n, "lanes": LANES,
            "steps": int(sol.steps),
            "mean_iterations": float(np.asarray(sol.iterations).mean()),
            "kernel": summary(tk), "xla": summary(tx),
            "kernel_solves_per_s": n / statistics.median(tk),
            "xla_solves_per_s": n / statistics.median(tx),
            "first_call_s": {"kernel": setup_k, "xla": setup_x}}


def step_breakdown(ocp, u0, x0b):
    """One stream step over 4096 lanes, split into its parts."""
    u, x = u0[:LANES], x0b[:LANES]
    lanes = jax.jit(jax.vmap(lambda a, b: flat_lane_init(ocp, a, b, CFG)))(
        u, x)
    adv = jnp.ones((LANES,), bool)
    bp = jnp.full((LANES,), 0.02, jnp.float32)
    out = {}
    for label, cfg in (("kernel", CFG), ("xla", XLA)):
        step = jax.jit(jax.vmap(
            lambda ln, a, cfg=cfg: flat_lane_iter(ocp, ln, cfg, a)))
        out[f"step_{label}"] = summary([timed(step, lanes, adv)
                                        for _ in range(1 + 10)][1:])
    trans = jax.jit(jax.vmap(
        lambda a, b, c, d: _lane_transition(ocp, a, b, c, d)))
    out["transition"] = summary([timed(trans, u, u, x, bp)
                                 for _ in range(1 + 10)][1:])
    cu = jax.jit(jax.vmap(lambda xx, uu, b: jnp.linalg.norm(jax.vmap(
        lambda s, c: jax.grad(ocp.stage_cost, 1)(s, c, b))(xx[:-1], uu))))
    out["cu_norm"] = summary([timed(cu, lanes.x, u, bp)
                              for _ in range(1 + 10)][1:])
    out["transition_share_of_kernel_step"] = (
        out["transition"]["median_s"] / out["step_kernel"]["median_s"])
    return out


def device_busy(logdir):
    """Busy and idle share of GPU 0 over the traced window: the union of
    the intervals of every event on the device's stream lines."""
    f = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                  recursive=True)[0]
    pd = jax.profiler.ProfileData.from_file(f)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    lines, spans = {}, []
    for p in planes:
        for ln in p.lines:
            evs = [(e.start_ns, e.start_ns + e.duration_ns)
                   for e in ln.events]
            lines[ln.name] = {"events": len(evs), "busy_ns": float(
                sum(b - a for a, b in evs))}
            if ln.name.startswith("Stream"):
                spans += evs
    if not spans:
        return {"lines": lines, "busy_share": None}
    spans.sort()
    busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = max(b for _, b in spans) - spans[0][0]
    return {"lines": lines, "window_ms": window / 1e6,
            "busy_share": busy / window, "idle_share": 1 - busy / window}


def trace_stream(ocp, u0, x0b):
    run = jax.jit(lambda u, x: solve_stream(ocp, u, x, CFG, lanes=LANES,
                                            refill_every=32))
    jax.block_until_ready(run(u0, x0b))
    logdir = tempfile.mkdtemp()
    with jax.profiler.trace(logdir):
        jax.block_until_ready(run(u0, x0b))
    return device_busy(logdir)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/kernel_vs_xla.jsonl")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_vs_xla: needs a GPU")
    use_compile_cache()
    smi = card()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    dev = jax.devices()[0].device_kind

    def emit(rec):
        rec.update(card=smi, device_kind=dev)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps(rec)[:600], flush=True)

    main_pool = pool(cartpole, 100, 4 * LANES)
    ocp_c = cartpole.make_ocp(4 / 100)
    emit({"config": "cartpole H=100", "what": "lane_iteration",
          **lane_iteration(*(a[:LANES] if i else a
                             for i, a in enumerate(main_pool)))})
    emit({"config": "cartpole H=100", "what": "stream single-grid",
          **stream_rates(*main_pool)})
    emit({"config": "cartpole H=100", "what": "stream multigrid",
          **stream_rates(*main_pool, ocp_c=ocp_c)})
    emit({"config": "cartpole H=100", "what": "step_breakdown",
          **step_breakdown(*main_pool)})
    emit({"config": "cartpole H=100", "what": "trace single-grid",
          **trace_stream(*main_pool)})

    pend = pool(pendulum, 100, 4 * LANES)
    emit({"config": "pendulum H=100", "what": "lane_iteration",
          **lane_iteration(*(a[:LANES] if i else a
                             for i, a in enumerate(pend)))})
    emit({"config": "pendulum H=100", "what": "stream single-grid",
          **stream_rates(*pend)})

    long = pool(cartpole, 1000, LANES)
    emit({"config": "cartpole T=1000", "what": "lane_iteration",
          **lane_iteration(*long)})
    emit({"config": "cartpole T=1000", "what": "stream single-grid",
          **stream_rates(*long, pairs=2)})


if __name__ == "__main__":
    main()
