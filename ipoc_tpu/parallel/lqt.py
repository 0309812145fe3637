"""Linear-Quadratic Tracking (LQT) subproblem: sequential and parallel passes.

This module is the in-repo replacement for the reference's hard
external dependency ``paroc`` (parallel-optimal-control), whose interface was
recovered from its call sites (SURVEY §2.8; reference
par_interior_point_newton.py:6-7,119-123 and examples/linear_mpc_parallel.py:6-8,
64-76).  The algorithm is the temporal-parallelization of LQT from the
literature referenced in PAPERS.md (Sarkka-style associative-scan dynamic
programming): conditional value functions are represented as five-tuple
elements combined by an associative operator, giving an O(log T)-span
backward pass; the forward pass is an affine-map associative scan sharing its
element algebra with the costate scan (parallel/costates.py).

Design notes:

* Both the sequential and the parallel backward passes derive their per-stage
  gains from ONE shared function (:func:`stage_gains`), so seq == par holds
  by construction and is unit-tested.
* All combines are written as batched matmuls/einsums over the horizon axis —
  XLA lowers them to batched ops; no per-stage Python, no inner vmap.
* Positive-definiteness is detected via Cholesky success, not ``eigh``
  (see ops/linalg.py).

Problem form (general LQT with cross terms):

* dynamics       ``x_{k+1} = A_k x_k + B_k u_k + c_k``
* stage cost     ``1/2 (H x - r)^T X (H x - r) + 1/2 (Z u - s)^T U (Z u - s)
  + (H x - r)^T M (Z u - s)``
* terminal cost  ``1/2 (H_T x_T - r_T)^T X_T (H_T x_T - r_T)``
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ipoc_tpu.ops import linalg
from ipoc_tpu.parallel.costates import affine_combine
from ipoc_tpu.problem import Derivatives, LinearizedOCP


class LQT(NamedTuple):
    """LQT problem container.

    Field order matches the reference's positional construction of the
    external ``paroc.LQT`` (par_interior_point_newton.py:69-83,
    linear_mpc_parallel.py:64): ``A, B, c, XT, HT, rT, X, H, r, U, Z, s, M``.
    Shapes: A (T,nx,nx), B (T,nx,nu), c (T,nx); XT (nx,nx), HT (nm,nx),
    rT (nm,); X (T,nm,nm), H (T,nm,nx), r (T,nm); U (T,ns,ns), Z (T,ns,nu),
    s (T,ns); M (T,nm,ns).
    """

    A: jax.Array
    B: jax.Array
    c: jax.Array
    XT: jax.Array
    HT: jax.Array
    rT: jax.Array
    X: jax.Array
    H: jax.Array
    r: jax.Array
    U: jax.Array
    Z: jax.Array
    s: jax.Array
    M: jax.Array


class LQTStage(NamedTuple):
    """Per-stage slice of an LQT (no terminal fields) — scannable pytree."""

    A: jax.Array
    B: jax.Array
    c: jax.Array
    X: jax.Array
    H: jax.Array
    r: jax.Array
    U: jax.Array
    Z: jax.Array
    s: jax.Array
    M: jax.Array


def lqt_stages(lqt: LQT) -> LQTStage:
    return LQTStage(
        lqt.A, lqt.B, lqt.c, lqt.X, lqt.H, lqt.r, lqt.U, lqt.Z, lqt.s, lqt.M
    )


class ValueElement(NamedTuple):
    """Associative-scan element of the conditional value function.

    Represents ``V(x, z) = 1/2 x^T J x - x^T eta
    + max_l [ l^T (z - A x - b) - 1/2 l^T C l ]`` — the dual (information)
    form, which stays finite when C is singular (single under-actuated steps).
    """

    A: jax.Array
    b: jax.Array
    C: jax.Array
    eta: jax.Array
    J: jax.Array


def value_combine(earlier: ValueElement, later: ValueElement) -> ValueElement:
    """Associative combination of conditional-value elements.

    ``earlier`` spans [i, j), ``later`` spans [j, k); the result spans
    [i, k).  Batched over leading axes.  All inner solves are general LU
    solves on ``I + C_i J_j`` (not necessarily SPD).
    """
    Ai, bi, Ci, etai, Ji = earlier
    Aj, bj, Cj, etaj, Jj = later
    n = Ai.shape[-1]
    I = jnp.broadcast_to(jnp.eye(n, dtype=Ai.dtype), Ai.shape)

    # D = (I + C_i J_j)^{-1}; note (I + J_j C_i)^{-1} = D^T for symmetric C, J.
    LHS = I + Ci @ Jj
    Dt_A = linalg.solve(LHS, Ai, pivot=False)
    Dt_bCeta = linalg.solve(
        LHS, (bi + jnp.einsum("...ij,...j->...i", Ci, etaj))[..., None],
        pivot=False,
    )[..., 0]
    Dt_C = linalg.solve(LHS, Ci, pivot=False)

    LHS_T = I + Jj @ Ci
    E_eta = linalg.solve(
        LHS_T, (etaj - jnp.einsum("...ij,...j->...i", Jj, bi))[..., None],
        pivot=False,
    )[..., 0]
    E_J = linalg.solve(LHS_T, Jj, pivot=False)

    AiT = jnp.swapaxes(Ai, -1, -2)
    A = Aj @ Dt_A
    b = jnp.einsum("...ij,...j->...i", Aj, Dt_bCeta) + bj
    C = linalg.sym(Aj @ Dt_C @ jnp.swapaxes(Aj, -1, -2) + Cj)
    eta = jnp.einsum("...ij,...j->...i", AiT, E_eta) + etai
    J = linalg.sym(AiT @ E_J @ Ai + Ji)
    return ValueElement(A, b, C, eta, J)


def _elements(lqt: LQT) -> ValueElement:
    """Per-stage scan elements, stacked (T, ...) — the terminal element is
    produced separately by :func:`_terminal_element` so the stage-element
    array shards cleanly along the time axis (see parallel/time_sharded.py).

    The cross term is eliminated by completing the square in the control
    (standard LQT-with-cross-terms reduction), yielding modified dynamics
    ``Abar, Bbar, cbar`` and state weight ``Xtil = X - M U^{-1} M^T``.
    """
    T, nx, nu = lqt.B.shape

    # Z is invertible (identity in every reference use); Bbar = B Z^{-1}.
    Bbar = jnp.swapaxes(
        linalg.solve(
            jnp.swapaxes(lqt.Z, -1, -2), jnp.swapaxes(lqt.B, -1, -2),
            pivot=False,
        ),
        -1,
        -2,
    )
    Uinv = linalg.solve(
        lqt.U,
        jnp.broadcast_to(
            jnp.eye(lqt.U.shape[-1], dtype=lqt.U.dtype), lqt.U.shape
        ),
        pivot=False,
    )
    UinvMt = Uinv @ jnp.swapaxes(lqt.M, -1, -2)

    Abar = lqt.A - Bbar @ UinvMt @ lqt.H
    cbar = lqt.c + jnp.einsum(
        "...ij,...j->...i", Bbar, lqt.s + jnp.einsum("...ij,...j->...i", UinvMt, lqt.r)
    )
    C = linalg.sym(Bbar @ Uinv @ jnp.swapaxes(Bbar, -1, -2))
    Xtil = lqt.X - lqt.M @ UinvMt
    Ht = jnp.swapaxes(lqt.H, -1, -2)
    J = linalg.sym(Ht @ Xtil @ lqt.H)
    eta = jnp.einsum("...ij,...j->...i", Ht @ Xtil, lqt.r)

    return ValueElement(A=Abar, b=cbar, C=C, eta=eta, J=J)


def _terminal_element(lqt: LQT) -> ValueElement:
    """Terminal element: pure state cost, no dynamics (unbatched)."""
    nx = lqt.B.shape[-2]
    JT = linalg.sym(lqt.HT.T @ lqt.XT @ lqt.HT)
    etaT = lqt.HT.T @ lqt.XT @ lqt.rT
    zero = jnp.zeros((nx, nx), JT.dtype)
    return ValueElement(A=zero, b=jnp.zeros((nx,), JT.dtype), C=zero,
                        eta=etaT, J=JT)


def stage_gains(stage: LQTStage, S_next, v_next):
    """Per-stage LQR gain and value update from the next-stage value function.

    Given ``V_{k+1}(x) = 1/2 x^T S' x - x^T v'``, minimizes the stage
    Q-function analytically.  Returns the feedback gain ``K`` and
    feedforward ``d`` for the control law ``u_k = d_k - K_k x_k``, the
    current value pair ``(S_k, v_k)``, the per-stage predicted cost change
    ``dV_k = d^T q_u + 1/2 d^T Quu d`` (classic expected-reduction term, cf.
    reference seq_interior_point_newton.py:63), and a Cholesky
    positive-definiteness flag for ``Quu``.

    Shared verbatim by the sequential scan and the parallel post-pass, so the
    two backward passes agree by construction.  Batched over leading axes.
    """
    A, B, c, X, H, r, U, Z, s, M = stage
    At = jnp.swapaxes(A, -1, -2)
    Bt = jnp.swapaxes(B, -1, -2)
    Ht = jnp.swapaxes(H, -1, -2)
    Zt = jnp.swapaxes(Z, -1, -2)
    Mt = jnp.swapaxes(M, -1, -2)

    mv = lambda Mat, vec: jnp.einsum("...ij,...j->...i", Mat, vec)

    Sc_minus_v = mv(S_next, c) - v_next
    Quu = linalg.sym(Zt @ U @ Z + Bt @ S_next @ B)
    Qxu = Ht @ M @ Z + At @ S_next @ B
    Qxx = linalg.sym(Ht @ X @ H + At @ S_next @ A)
    qu = -mv(Zt @ U, s) - mv(Zt @ Mt, r) + mv(Bt, Sc_minus_v)
    qx = -mv(Ht @ X, r) - mv(Ht @ M, s) + mv(At, Sc_minus_v)

    Quu_chol = linalg.cholesky(Quu)
    posdef = jnp.all(jnp.isfinite(Quu_chol), axis=(-1, -2))

    # Solve Quu [d | K] = [-qu | Qxu^T] in one factorization.
    rhs = jnp.concatenate([-qu[..., None], jnp.swapaxes(Qxu, -1, -2)], axis=-1)
    sol = linalg.cholesky_solve(Quu, rhs)
    d = sol[..., 0]
    K = sol[..., 1:]

    S = linalg.sym(Qxx - Qxu @ K)
    v = -(qx + mv(Qxu, d))
    dV = jnp.einsum("...u,...u->...", d, qu) + 0.5 * jnp.einsum(
        "...u,...u->...", d, mv(Quu, d)
    )
    return K, d, S, v, dV, posdef


def par_bwd_pass(lqt: LQT):
    """Parallel (associative-scan) backward pass.

    Returns ``(Kx, d, S, v, pred_reduction, feasible)`` matching the
    recovered ``paroc.par_bwd_pass`` interface (reference
    par_interior_point_newton.py:120).  ``S, v`` are the value-function
    quadratic/linear terms at every k in 0..T; ``pred_reduction`` is the
    predicted total cost change of taking the full step from zero deviation;
    ``feasible`` is the all-stages convexity flag.
    """
    elems = _elements(lqt)
    # In a reverse scan fn receives (later-combination, earlier-element);
    # value_combine wants (earlier, later), hence the argument swap.
    scanned = lax.associative_scan(
        lambda a, b: value_combine(b, a), elems, reverse=True, axis=0
    )
    # scanned[k] spans stages [k, T); fold the terminal cost in with one
    # batched combine to obtain V_k for every k.
    eT = _terminal_element(lqt)
    full = value_combine(scanned, eT)
    S = jnp.concatenate([full.J, eT.J[None]], axis=0)
    v = jnp.concatenate([full.eta, eT.eta[None]], axis=0)
    K, d, _, _, dV, posdef = stage_gains(lqt_stages(lqt), S[1:], v[1:])
    U_ok = linalg.is_posdef(lqt.U)
    feasible = jnp.logical_and(jnp.all(posdef), U_ok)
    return K, d, S, v, jnp.sum(dV), feasible


def seq_bwd_pass(lqt: LQT):
    """Sequential (reverse ``lax.scan``) backward pass.

    Returns ``(Kx, d, S, v)`` matching the recovered ``paroc.seq_bwd_pass``
    interface (reference linear_mpc_parallel.py:74).  Uses the same
    :func:`stage_gains` as the parallel pass.
    """
    K, d, S, v, _, _ = seq_bwd_pass_full(lqt)
    return K, d, S, v


def seq_bwd_pass_full(lqt: LQT):
    """Sequential backward pass returning the full 6-tuple (par interface)."""
    ST = linalg.sym(lqt.HT.T @ lqt.XT @ lqt.HT)
    vT = lqt.HT.T @ lqt.XT @ lqt.rT

    def step(carry, lqt_k):
        S_next, v_next = carry
        K, d, S, v, dV, posdef = stage_gains(lqt_k, S_next, v_next)
        return (S, v), (K, d, S, v, dV, posdef)

    (_, _), (K, d, S, v, dV, posdef) = lax.scan(
        step, (ST, vT), lqt_stages(lqt), reverse=True
    )
    S = jnp.concatenate([S, ST[None]], axis=0)
    v = jnp.concatenate([v, vT[None]], axis=0)
    U_ok = linalg.is_posdef(lqt.U)
    feasible = jnp.logical_and(jnp.all(posdef), U_ok)
    return K, d, S, v, jnp.sum(dV), feasible


def _closed_loop(lqt: LQT, Kx, d):
    """Closed-loop affine step maps ``x_{k+1} = F_k x_k + e_k``."""
    F = lqt.A - lqt.B @ Kx
    e = jnp.einsum("...ij,...j->...i", lqt.B, d) + lqt.c
    return F, e


def par_fwd_pass(lqt: LQT, x0, Kx, d):
    """Parallel forward pass: O(log T)-span closed-loop rollout.

    Returns ``(u, x)`` with ``u`` of shape (T, nu) and ``x`` of shape
    (T+1, nx), matching the recovered ``paroc.par_fwd_pass`` interface
    (reference par_interior_point_newton.py:121-123: called with zero
    deviation to produce the Newton step).  Shares its affine element
    algebra with the costate scan.
    """
    F, e = _closed_loop(lqt, Kx, d)
    # Absorb x0 into element 0 so prefix combination yields x_{k+1} directly.
    e0 = F[0] @ x0 + e[0]
    F = F.at[0].set(jnp.zeros_like(F[0]))
    e = e.at[0].set(e0)
    # Prefix composition: combined = later(earlier(.)).
    _, xs = lax.associative_scan(
        lambda a, b: affine_combine(b, a), (F, e), axis=0
    )
    x = jnp.concatenate([x0[None], xs], axis=0)
    u = d - jnp.einsum("tij,tj->ti", Kx, x[:-1])
    return u, x


def seq_fwd_pass(lqt: LQT, x0, Kx, d):
    """Sequential forward pass (reference ``paroc.seq_fwd_pass`` interface)."""
    F, e = _closed_loop(lqt, Kx, d)

    def step(x, inp):
        F_k, e_k = inp
        x_next = F_k @ x + e_k
        return x_next, x_next

    _, xs = lax.scan(step, x0, (F, e))
    x = jnp.concatenate([x0[None], xs], axis=0)
    u = d - jnp.einsum("tij,tj->ti", Kx, x[:-1])
    return u, x


def newton_lqt(
    lin: LinearizedOCP, d: Derivatives, terminal_hessian: jax.Array
) -> LQT:
    """Assemble the Newton-step LQT from costate-contracted stage data.

    The equivalent of the reference's ``noc_to_lqt``
    (par_interior_point_newton.py:50-84): per-stage references
    ``s = -(R - M^T Q^{-1} M)^{-1} ru`` and ``r = -Q^{-1} M s`` make the
    LQT's linear terms reproduce the Newton model's ``ru^T du`` term.

    ``terminal_hessian`` is passed explicitly: the exact
    ``hessian(final_cost)(xT)`` by default, or ``Q[0]`` to replicate the
    reference's placeholder quirk (par:74) — see SolverConfig.terminal_hessian.
    """
    ru, Q, R, M = lin
    T, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[1]
    dtype = Q.dtype

    Qinv_M = linalg.solve(Q, M, pivot=False)
    Schur = R - jnp.swapaxes(M, -1, -2) @ Qinv_M
    s = -linalg.solve(Schur, ru[..., None], pivot=False)[..., 0]
    r = -jnp.einsum("...ij,...j->...i", Qinv_M, s)

    eye_x = jnp.broadcast_to(jnp.eye(nx, dtype=dtype), (T, nx, nx))
    eye_u = jnp.broadcast_to(jnp.eye(nu, dtype=dtype), (T, nu, nu))
    return LQT(
        A=d.fx,
        B=d.fu,
        c=jnp.zeros((T, nx), dtype),
        XT=terminal_hessian,
        HT=jnp.eye(nx, dtype=dtype),
        rT=jnp.zeros((nx,), dtype),
        X=Q,
        H=eye_x,
        r=r,
        U=R,
        Z=eye_u,
        s=s,
        M=M,
    )
