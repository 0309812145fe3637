"""Time-sharded (sequence-parallel) LQT and costate passes.

Shards the horizon axis of a single solve across devices: each device scans
its local slice of Riccati/costate elements in O(log T_local) span, per-shard
aggregates cross devices via one ``all_gather`` (NVLink within a host), and
a local fixup completes the global scan (SURVEY §5.7: "sharding the scan
itself").

These functions are written to run inside ``shard_map`` over a mesh axis
named ``"time"`` with every (T, ...) array sharded along axis 0.  All
purely-elementwise work (element construction, stage gains, control
extraction) needs no communication and runs on the local slice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ipoc_tpu.ops import linalg
from ipoc_tpu.parallel.costates import affine_combine
from ipoc_tpu.parallel.lqt import (
    LQT,
    _elements,
    _terminal_element,
    lqt_stages,
    stage_gains,
    value_combine,
)
from ipoc_tpu.parallel.sharding import sharded_associative_scan

TIME_AXIS = "time"


def shift_left_across_shards(a, fill, axis_name: str):
    """Shift a time-sharded per-stage array one stage earlier: local roll,
    with element 0 of the *next* shard filling the local tail via one
    ``ppermute`` neighbor exchange; the globally-last stage takes ``fill``.
    Turns per-stage values v_k into v_{k+1} (e.g. S_k -> S_{k+1} for the
    Riccati gains, lam_k -> lam_{k+1} for the costate contraction)."""
    idx = lax.axis_index(axis_name)
    n_shards = lax.axis_size(axis_name)
    rolled = jnp.concatenate([a[1:], fill[None]], axis=0)
    recv = lax.ppermute(
        a[0],
        axis_name,
        [(i, (i - 1) % n_shards) for i in range(n_shards)],
    )
    is_last = idx == n_shards - 1
    tail = jnp.where(is_last, fill, recv)
    return rolled.at[-1].set(tail)


def par_bwd_pass_time_sharded(lqt: LQT, axis_name: str = TIME_AXIS):
    """Backward LQT pass with the horizon sharded over ``axis_name``.

    Same interface as ``par_bwd_pass`` except ``S, v`` are returned with T
    entries (values at stages 0..T-1; the terminal pair is implicit in the
    terminal cost) so every output shards evenly along time.
    Scalar outputs (pred_reduction, feasible) are reduced over the axis with
    ``psum``/``all-and``.
    """
    elems = _elements(lqt)
    scanned = sharded_associative_scan(
        value_combine, elems, axis_name, reverse=True
    )
    eT = _terminal_element(lqt)
    full = value_combine(scanned, eT)
    S_stage, v_stage = full.J, full.eta  # S_k, v_k for local stages k

    # stage_gains wants S_{k+1}, v_{k+1}: shift left across the shard
    # boundary with a single ppermute (neighbor exchange).
    S_next = shift_left_across_shards(S_stage, eT.J, axis_name)
    v_next = shift_left_across_shards(v_stage, eT.eta, axis_name)

    K, d, _, _, dV, posdef = stage_gains(lqt_stages(lqt), S_next, v_next)
    U_ok = linalg.is_posdef(lqt.U)
    feasible = jnp.all(
        lax.all_gather(jnp.logical_and(jnp.all(posdef), U_ok), axis_name)
    )
    pred = lax.psum(jnp.sum(dV), axis_name)
    return K, d, S_stage, v_stage, pred, feasible


def par_fwd_pass_time_sharded(lqt: LQT, x0, Kx, d, axis_name: str = TIME_AXIS,
                              with_terminal: bool = False):
    """Forward closed-loop pass with the horizon sharded over ``axis_name``.

    Returns ``(u, x)`` with x holding the T *stage* states x_0..x_{T-1}
    locally sharded (the final state is cheap to recover from the last
    control if needed) so outputs shard evenly.  With
    ``with_terminal=True`` additionally returns the terminal state ``x_T``
    replicated on every shard (one extra all_gather) — the nonlinear
    solver needs it for the terminal cost/Hessian.
    """
    F = lqt.A - lqt.B @ Kx
    e = jnp.einsum("...ij,...j->...i", lqt.B, d) + lqt.c

    idx = lax.axis_index(axis_name)
    is_first = idx == 0
    # Absorb x0 into global element 0.
    e0 = jnp.where(is_first, F[0] @ x0 + e[0], e[0])
    F0 = jnp.where(is_first, jnp.zeros_like(F[0]), F[0])
    F = F.at[0].set(F0)
    e = e.at[0].set(e0)

    pref = sharded_associative_scan(
        lambda a, b: affine_combine(b, a), (F, e), axis_name, reverse=False
    )
    # pref[k] is the affine map x0 -> x_{k+1}; apply it, then shift right by
    # one stage (cross-shard neighbor exchange) to obtain the stage states.
    F_pref, c_pref = pref
    x_next = jnp.einsum("tij,j->ti", F_pref, x0) + c_pref

    n_shards = lax.axis_size(axis_name)
    recv = lax.ppermute(
        x_next[-1],
        axis_name,
        [(i, (i + 1) % n_shards) for i in range(n_shards)],
    )
    head = jnp.where(is_first, x0, recv)
    x_stage = jnp.concatenate([head[None], x_next[:-1]], axis=0)
    u = d - jnp.einsum("tij,tj->ti", Kx, x_stage)
    if with_terminal:
        xT = lax.all_gather(x_next[-1], axis_name)[n_shards - 1]
        return u, x_stage, xT
    return u, x_stage


def solve_lqt_time_sharded(lqt: LQT, x0, mesh):
    """Convenience: jit-able full LQT solve with the horizon sharded over the
    mesh's 'time' axis.  Returns (u, x_stages)."""
    spec_t3 = P("time", None, None)
    spec_t2 = P("time", None)
    rep = P()

    lqt_specs = LQT(
        A=spec_t3, B=spec_t3, c=spec_t2, XT=rep, HT=rep, rT=rep,
        X=spec_t3, H=spec_t3, r=spec_t2, U=spec_t3, Z=spec_t3, s=spec_t2,
        M=spec_t3,
    )

    @jax.jit
    def run(lqt, x0):
        def inner(lqt, x0):
            K, d, S, v, pred, feas = par_bwd_pass_time_sharded(lqt)
            u, x = par_fwd_pass_time_sharded(lqt, x0, K, d)
            return u, x

        return shard_map(
            inner,
            mesh=mesh,
            in_specs=(lqt_specs, rep),
            out_specs=(spec_t2, spec_t2),
            check_vma=False,
        )(lqt, x0)

    return run(lqt, x0)
