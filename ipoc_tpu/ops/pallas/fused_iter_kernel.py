"""Fused lane iteration: one Newton trial per scenario, T loop in-kernel.

The per-iteration pipeline of the batched flat-mode solver
(solvers/ip_newton.py flat_lane_iter) is, in plain XLA:

    total_cost -> first-order derivatives -> costate scan
    -> Hamiltonian Hessians -> Riccati scan -> forward scan -> trial cost
    -> feasibility

(:func:`_fused_reference`).  Every scan over the horizon is a sequential
loop of small launches.  Here the whole evaluation is TWO Pallas launches
through Triton (``backend="triton"``) that read only the iterate ``(x, u)``
and the per-lane scalars ``(bp, reg)``:

* one scenario per GPU thread; each program owns ``BL`` lanes and every
  matrix entry is one ``(BL,)`` vector, unrolled in Python over nx and nu;
* **backward launch** — a reversed ``fori_loop`` over T.  At each stage the
  model's first- and second-order stage data are emitted by the scalar DAG
  (ops/pallas/scalarize.py) from JAX AD of the Hamiltonian, then consumed
  at once by the costate and Riccati recursions, whose carries (value
  function, costate, predicted reduction, minimum pivot, cost, gradient
  norm) stay in registers.  Only the gains ``[k | K]`` reach device memory;
* **forward launch** — the closed-loop deviation rollout fused with the
  trial evaluation: the trial iterate, its barrier cost and its maximum
  constraint value (feasible iff <= 0).

All arrays are lane-major, ``(T, rows, B)``, so each load and store of a
row is coalesced.  Semantics equal the plain composition (reference cites:
compute_hamiltonian_lqr == reference par_interior_point_newton.py:13-42;
Riccati recursion == seq_interior_point_newton.py:42-90; trial acceptance
quantities == par:156-165) up to float32 summation order.  Requires
``terminal_hessian="exact"`` (the terminal data is grad/hessian of the
final cost, the documented fix of the reference's XT=Q[0] quirk, par:74).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ipoc_tpu.ops.pallas import use_fused_lane_iter
from ipoc_tpu.ops.pallas.scalarize import scalar_lift
from ipoc_tpu.problem import OCP

# Lanes (scenarios) per program.  32 lanes = one warp: 4096 lanes give 128
# programs, about one per SM of an H100.
BLOCK_LANES = 32
BWD_NAME = "ipoc_lane_iter_bwd"
FWD_NAME = "ipoc_lane_iter_fwd"


# ---------------------------------------------------------------------------
# Per-element stage functions (lifted to lane vectors by scalar_lift)
# ---------------------------------------------------------------------------


def _stage_bwd_fn(ocp: OCP, nx: int, nu: int):
    """Per-element backward stage data.

    Returns the Hamiltonian stage quantities (ops/derivatives.py
    compute_hamiltonian_lqr), the dynamics Jacobians, the updated costate,
    and the stage cost — row-major flattened.
    """

    def stage(x, u, bp, lam_next):
        def ham(xx, uu):
            return ocp.stage_cost(xx, uu, bp) + jnp.sum(
                lam_next * ocp.dynamics(xx, uu)
            )

        # ONE linearization serves everything: the primal IS (lam_new, ru,
        # f, cost) — Hx = cx + fx^T lam', Hu = cu + fu^T lam' — and nx+nu
        # applications of the linear jvp give the Hessian columns
        # (Q | M | R) AND the dynamics Jacobian columns (fx | fu) in one
        # shared trace.  The symmetric Hessian blocks keep only the upper
        # triangle per column and mirror the rest, so the lower-triangle
        # scalar nodes are dead-code-eliminated by the scalarizer.
        def gf(xx, uu):
            Hx, Hu = jax.grad(ham, (0, 1))(xx, uu)
            return Hx, Hu, ocp.dynamics(xx, uu), ocp.stage_cost(xx, uu, bp)

        (Hx, Hu, _f, cst), hjvp = jax.linearize(gf, x, u)
        ex = jnp.eye(nx, dtype=x.dtype)
        eu = jnp.eye(nu, dtype=u.dtype)
        zx = jnp.zeros_like(x)
        zu = jnp.zeros_like(u)
        xcols = [hjvp(ex[i], zu) for i in range(nx)]
        ucols = [hjvp(zx, eu[j]) for j in range(nu)]
        Q = jnp.stack(
            [jnp.stack([xcols[max(i, j)][0][min(i, j)] for j in range(nx)])
             for i in range(nx)], axis=0)
        R = jnp.stack(
            [jnp.stack([ucols[max(i, j)][1][min(i, j)] for j in range(nu)])
             for i in range(nu)], axis=0)
        M = jnp.stack([c[0] for c in ucols], axis=1)
        fx = jnp.stack([c[2] for c in xcols], axis=1)
        fu = jnp.stack([c[2] for c in ucols], axis=1)
        return (Hu, Q.reshape(nx * nx), R.reshape(nu * nu),
                M.reshape(nx * nu), fx.reshape(nx * nx), fu.reshape(nx * nu),
                Hx, cst)

    return stage


def _term_fn(ocp: OCP, nx: int):
    """Terminal costate / Hessian / cost from the final state."""

    def term(xT):
        lamT = jax.grad(ocp.final_cost)(xT)
        VT = jax.jacfwd(jax.grad(ocp.final_cost))(xT)
        return lamT, VT.reshape(nx * nx), ocp.final_cost(xT)

    return term


def _stage_fwd_fn(ocp: OCP, nx: int, nu: int):
    """Per-element forward step: gains -> trial point -> cost/constraints."""

    def stage(x, u, bp, dx, Kk):
        k = Kk[:nu]
        K = Kk[nu:].reshape(nu, nx)
        du = k + jnp.sum(K * dx[None, :], axis=1)
        tu = u + du
        tx = x + dx
        # The deviation propagation only needs fx dx + fu du: ONE
        # forward-mode pass through the dynamics, no Jacobians.
        _, dxn = jax.jvp(ocp.dynamics, (x, u), (dx, du))
        cst = ocp.stage_cost(tx, tu, bp)
        cmax = jnp.max(ocp.constraints(tx, tu))
        return tu, tx, dxn, cst, cmax

    return stage


def _term_fwd_fn(ocp: OCP):
    def term(xT, dxT):
        txT = xT + dxT
        return txT, ocp.final_cost(txT)

    return term


# ---------------------------------------------------------------------------
# Small-matrix algebra on lists of lane vectors: entry (i, j) of an (n x m)
# matrix is element i * m + j.
# ---------------------------------------------------------------------------


def _mm(A, B, n, k, m):
    """(n x k) @ (k x m)."""
    return [_sum(A[i * k + l] * B[l * m + j] for l in range(k))
            for i in range(n) for j in range(m)]


def _add_mm_sym(C, A, B, n, k):
    """``C + A @ B`` for a symmetric (n x n) result: the upper triangle is
    computed and mirrored, which keeps the value function exactly
    symmetric (the plain path's ``linalg.sym``)."""
    out = [None] * (n * n)
    for i in range(n):
        for j in range(i, n):
            acc = C[i * n + j] + _sum(A[i * k + l] * B[l * n + j]
                                      for l in range(k))
            out[i * n + j] = out[j * n + i] = acc
    return out


def _mv(A, x, n, m):
    """(n x m) @ (m,)."""
    return [_sum(A[i * m + j] * x[j] for j in range(m)) for i in range(n)]


def _transpose(A, n, m):
    return [A[i * m + j] for j in range(m) for i in range(n)]


def _sum(terms):
    terms = iter(terms)
    acc = next(terms)
    for t in terms:
        acc = acc + t
    return acc


def _solve_track(A, Bm, n, m):
    """Unpivoted elimination ``A X = B`` for an (n x n) A and (n x m) B;
    also returns the minimum leading pivot (A is PD iff it is > 0)."""
    a, b = list(A), list(Bm)
    minpiv = None
    for k in range(n):
        piv = a[k * n + k]
        minpiv = piv if minpiv is None else jnp.minimum(minpiv, piv)
        inv_p = 1.0 / piv
        for j in range(k + 1, n):
            a[k * n + j] = a[k * n + j] * inv_p
        for j in range(m):
            b[k * m + j] = b[k * m + j] * inv_p
        for i in range(k + 1, n):
            f = a[i * n + k]
            for j in range(k + 1, n):
                a[i * n + j] = a[i * n + j] - f * a[k * n + j]
            for j in range(m):
                b[i * m + j] = b[i * m + j] - f * b[k * m + j]
    for i in range(n - 2, -1, -1):
        for l in range(i + 1, n):
            f = a[i * n + l]
            for j in range(m):
                b[i * m + j] = b[i * m + j] - f * b[l * m + j]
    return b, minpiv


def _min_pivot(A, n):
    """Minimum leading pivot of an unpivoted elimination (PD test)."""
    return _solve_track(A, [], n, 0)[1]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _rows(ref, t, n):
    return [ref[t, i, :] for i in range(n)]


def _bwd_kernel(x_ref, u_ref, bp_ref, reg_ref, kk_ref, out_ref, *, nx, nu,
                T, stage, term):
    """Costates + stage data + Riccati in one reversed-time loop.

    Recursion (reference seq_interior_point_newton.py:42-90):
      Qxx = Q + fx'V fx;  Quu = R + reg I + fu'V fu;  Qxu = M + fx'V fu
      Qu  = ru + fu'v;    Qx = fx'v
      [k | K] = -Quu^{-1} [Qu | Qxu'];  v <- Qx + Qxu k;  V <- Qxx + Qxu K
      dV += k'Qu + 1/2 k'Quu k
    ``out_ref`` rows: cost, dV, minimum pivot, max |ru|.
    """
    bp = bp_ref[...]
    reg = reg_ref[...]
    lamT, VT, cT = term(_rows(x_ref, T, nx))
    zero = jnp.zeros_like(bp)

    def body(s, carry):
        Vxx, Vx, lam, dv, piv, cost, hu = carry
        t = T - 1 - s
        ru, Q, R, M, fx, fu, lam_new, cst = stage(
            _rows(x_ref, t, nx), _rows(u_ref, t, nu), [bp], lam)
        # Levenberg: R += reg * I (reg pre-scaled by ||cu|| outside;
        # reference par:116-118).
        R = [R[r] + reg if r % (nu + 1) == 0 else R[r]
             for r in range(nu * nu)]
        fxT = _transpose(fx, nx, nx)
        fuT = _transpose(fu, nx, nu)
        Vfx = _mm(Vxx, fx, nx, nx, nx)
        Vfu = _mm(Vxx, fu, nx, nx, nu)
        Qxx = _add_mm_sym(Q, fxT, Vfx, nx, nx)
        Quu = _add_mm_sym(R, fuT, Vfu, nu, nx)
        Qxu = [a + b for a, b in zip(M, _mm(fxT, Vfu, nx, nx, nu))]
        Qu = [a + b for a, b in zip(ru, _mv(fuT, Vx, nu, nx))]
        Qx = _mv(fxT, Vx, nx, nx)
        QxuT = _transpose(Qxu, nx, nu)
        rhs = [e for i in range(nu)
               for e in [Qu[i]] + QxuT[i * nx:(i + 1) * nx]]
        sol, p = _solve_track(Quu, rhs, nu, 1 + nx)
        k = [-sol[i * (1 + nx)] for i in range(nu)]
        K = [-sol[i * (1 + nx) + 1 + j] for i in range(nu) for j in range(nx)]
        p = jnp.minimum(p, _min_pivot(R, nu))
        for r, g in enumerate(k + K):
            kk_ref[t, r, :] = g
        Vx = [a + b for a, b in zip(Qx, _mv(Qxu, k, nx, nu))]
        Vxx = _add_mm_sym(Qxx, Qxu, K, nx, nu)
        dv = dv + _sum(k[i] * Qu[i] for i in range(nu)) + 0.5 * _sum(
            k[i] * q for i, q in enumerate(_mv(Quu, k, nu, nu)))
        piv = jnp.minimum(piv, p)
        cost = cost + cst[0]
        hu = functools.reduce(jnp.maximum, [jnp.abs(r) for r in ru], hu)
        return Vxx, Vx, lam_new, dv, piv, cost, hu

    carry = (VT, [zero] * nx, lamT, zero, jnp.full_like(bp, jnp.inf),
             cT[0], zero)
    _, _, _, dv, piv, cost, hu = jax.lax.fori_loop(0, T, body, carry)
    for r, v in enumerate((cost, dv, piv, hu)):
        out_ref[r, :] = v


def _fwd_kernel(x_ref, u_ref, bp_ref, kk_ref, tx_ref, tu_ref, out_ref, *, nx,
                nu, T, stage, term):
    """Deviation rollout fused with the trial cost and feasibility.
    ``out_ref`` rows: trial cost, maximum constraint value."""
    bp = bp_ref[...]
    ng = nu * (1 + nx)

    def body(t, carry):
        dx, cost, mc = carry
        tu, tx, dxn, cst, cmax = stage(
            _rows(x_ref, t, nx), _rows(u_ref, t, nu), [bp], dx,
            _rows(kk_ref, t, ng))
        for i, v in enumerate(tu):
            tu_ref[t, i, :] = v
        for i, v in enumerate(tx):
            tx_ref[t, i, :] = v
        return dxn, cost + cst[0], jnp.maximum(mc, cmax[0])

    zero = jnp.zeros_like(bp)
    carry = ([zero] * nx, zero, jnp.full_like(bp, -jnp.inf))
    dx, cost, mc = jax.lax.fori_loop(0, T, body, carry)
    txT, cT = term(_rows(x_ref, T, nx), dx)
    for i, v in enumerate(txT):
        tx_ref[T, i, :] = v
    out_ref[0, :] = cost + cT[0]
    out_ref[1, :] = mc


def fused_newton_iter_batched(ocp: OCP, x, u, bp, reg,
                              block_lanes: int = BLOCK_LANES,
                              interpret: bool = False,
                              with_pivot: bool = False):
    """One fused batched Newton trial evaluation (two Triton launches).

    Shapes: x (B,T+1,nx), u (B,T,nu), bp (B,), reg (B,) — reg is the
    Levenberg parameter already scaled by max(||cu||_F, floor).  The batch
    is padded to a multiple of ``block_lanes`` (a power of two) by
    repeating the last scenario.

    Returns ``(temp_x, temp_u, cost, new_cost_raw, max_constraint, pred,
    bwd_ok, Hu_norm)`` with temp_x (B,T+1,nx), temp_u (B,T,nu) and the rest
    (B,), as :func:`_fused_reference`.  The trial is feasible iff
    ``max_constraint <= 0``; ``new_cost_raw`` is only meaningful for
    feasible trials (the caller's ``where`` restores reference
    par:159-163 semantics).  ``with_pivot`` appends the minimum pivot of
    the backward sweep (the margin behind ``bwd_ok``).
    """
    B, Tp1, nx = x.shape
    T = Tp1 - 1
    nu = u.shape[-1]
    BL = block_lanes
    if BL & (BL - 1):
        raise ValueError(f"block_lanes must be a power of two, got {BL}")
    dtype = x.dtype
    Bp = -(-B // BL) * BL
    ng = nu * (1 + nx)

    def lanes_last(a):
        a = jnp.pad(a, ((0, Bp - B),) + ((0, 0),) * (a.ndim - 1), mode="edge")
        return jnp.moveaxis(a, 0, -1)

    xl, ul, bpl, regl = (lanes_last(a) for a in (x, u, bp, reg))
    sds = lambda shape: jax.ShapeDtypeStruct(shape, dtype)  # noqa: E731
    stage_b = scalar_lift(_stage_bwd_fn(ocp, nx, nu), sds((nx,)),
                          sds((nu,)), sds(()), sds((nx,)))
    term_b = scalar_lift(_term_fn(ocp, nx), sds((nx,)))
    stage_f = scalar_lift(_stage_fwd_fn(ocp, nx, nu), sds((nx,)), sds((nu,)),
                          sds(()), sds((nx,)), sds((ng,)))
    term_f = scalar_lift(_term_fwd_fn(ocp), sds((nx,)), sds((nx,)))

    def spec(*rows):
        return pl.BlockSpec(rows + (BL,), lambda b: (0,) * len(rows) + (b,))

    params = pl_triton.CompilerParams(num_warps=max(1, BL // 32),
                                      num_stages=1)
    grid = (Bp // BL,)
    with jax.enable_x64(False):
        kk, bwd_out = pl.pallas_call(
            functools.partial(_bwd_kernel, nx=nx, nu=nu, T=T, stage=stage_b,
                              term=term_b),
            grid=grid,
            in_specs=[spec(Tp1, nx), spec(T, nu), spec(), spec()],
            out_specs=[spec(T, ng), spec(4)],
            out_shape=[sds((T, ng, Bp)), sds((4, Bp))],
            compiler_params=params, backend="triton", interpret=interpret,
            name=BWD_NAME,
        )(xl, ul, bpl, regl)
        tx, tu, fwd_out = pl.pallas_call(
            functools.partial(_fwd_kernel, nx=nx, nu=nu, T=T, stage=stage_f,
                              term=term_f),
            grid=grid,
            in_specs=[spec(Tp1, nx), spec(T, nu), spec(), spec(T, ng)],
            out_specs=[spec(Tp1, nx), spec(T, nu), spec(2)],
            out_shape=[sds((Tp1, nx, Bp)), sds((T, nu, Bp)), sds((2, Bp))],
            compiler_params=params, backend="triton", interpret=interpret,
            name=FWD_NAME,
        )(xl, ul, bpl, kk)

    def unlane(a):
        return jnp.moveaxis(a, -1, 0)[:B]

    cost, pred, piv, hu = unlane(bwd_out).T
    new_cost_raw, max_c = unlane(fwd_out).T
    ok = jnp.isfinite(piv) & (piv > 0) & jnp.isfinite(pred)
    out = (unlane(tx), unlane(tu), cost, new_cost_raw, max_c, pred, ok, hu)
    return out + (piv,) if with_pivot else out


# ---------------------------------------------------------------------------
# Reference (plain XLA) compositions + custom_vmap dispatch
# ---------------------------------------------------------------------------


def _fused_reference(ocp: OCP, x, u, bp, reg):
    """Unbatched reference composition of the fused iteration.

    Exactly the unfused pipeline (first-order derivatives -> sequential
    costates -> Hamiltonian LQR -> regularized sequential trial -> trial
    evaluation); the kernel must match this up to f32 summation order.
    """
    from ipoc_tpu.ops.derivatives import (
        compute_first_order,
        compute_hamiltonian_lqr,
    )
    from ipoc_tpu.problem import LinearizedOCP
    from ipoc_tpu.solvers.ip_newton import _seq_trial_scan

    d = compute_first_order(ocp, x, u, bp)
    lam_T = jax.grad(ocp.final_cost)(x[-1])

    def costate_step(lam, de):
        cx, fx = de
        lam_new = cx + fx.T @ lam
        return lam_new, lam_new

    _, lam_head = jax.lax.scan(
        costate_step, lam_T, (d.cx, d.fx), reverse=True
    )
    lam = jnp.concatenate([lam_head, lam_T[None]], axis=0)
    lin = compute_hamiltonian_lqr(ocp, x, u, lam, bp)
    nu = u.shape[-1]
    lin_reg = LinearizedOCP(
        lin.r, lin.Q, lin.R + reg * jnp.eye(nu, dtype=u.dtype), lin.M
    )
    XT = jax.hessian(ocp.final_cost)(x[-1])
    du, dx, pred, ok = _seq_trial_scan(lin_reg, d, XT)
    temp_x = x + dx
    temp_u = u + du
    cost = ocp.total_cost(x, u, bp)
    new_cost_raw = ocp.total_cost(temp_x, temp_u, bp)
    max_c = jnp.max(jax.vmap(ocp.constraints)(temp_x[:-1], temp_u))
    hu = jnp.max(jnp.abs(lin.r))
    return temp_x, temp_u, cost, new_cost_raw, max_c, pred, ok, hu


def make_fused_iter(ocp: OCP):
    """Per-lane fused-iteration op.  Under vmap it runs the two Triton
    launches where :func:`~ipoc_tpu.ops.pallas.use_fused_lane_iter` holds
    (GPU, float32, nx <= 8) and the vmapped plain composition elsewhere."""

    @jax.custom_batching.custom_vmap
    def fused(x, u, bp, reg):
        return _fused_reference(ocp, x, u, bp, reg)

    @fused.def_vmap
    def _fused_vmap(axis_size, in_batched, x, u, bp, reg):
        x, u, bp, reg = (
            a if b else jnp.broadcast_to(a, (axis_size,) + a.shape)
            for a, b in zip((x, u, bp, reg), in_batched))
        if use_fused_lane_iter(x.dtype, x.shape[-1]):
            out = fused_newton_iter_batched(ocp, x, u, bp, reg)
        else:
            out = jax.vmap(
                lambda a, b, c, d: _fused_reference(ocp, a, b, c, d)
            )(x, u, bp, reg)
        return out, (True,) * 8

    return fused


def _fused_ddp_reference(ocp: OCP, x, u, bp, reg):
    """One IP-DDP trial evaluation with the fused iteration's interface
    (solvers/ip_ddp.py ddp_bwd_pass + nonlinear closed_loop_rollout with
    the ``||cu||`` reg scale hoisted out).  Reference semantics:
    differential_dynamic_programming.py:28-90."""
    from ipoc_tpu.ops.derivatives import compute_derivatives
    from ipoc_tpu.solvers.ip_ddp import ddp_bwd_core
    from ipoc_tpu.utils.integrators import closed_loop_rollout

    cost = ocp.total_cost(x, u, bp)
    d = compute_derivatives(ocp, x, u, bp)
    ffgain, gain, pred, ok, Qu = ddp_bwd_core(ocp.final_cost, x[-1], d, reg)
    temp_x, temp_u = closed_loop_rollout(ocp.dynamics, gain, ffgain, x, u)
    new_cost_raw = ocp.total_cost(temp_x, temp_u, bp)
    max_c = jnp.max(jax.vmap(ocp.constraints)(temp_x[:-1], temp_u))
    hu = jnp.max(jnp.abs(Qu))
    return temp_x, temp_u, cost, new_cost_raw, max_c, pred, ok, hu
