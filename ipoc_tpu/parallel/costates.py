"""Costate (adjoint) recursions: sequential and parallel-in-time.

The recursion is ``lam_T = grad(final_cost)(x_T)``,
``lam_k = cx_k + fx_k^T lam_{k+1}`` (reference noc/costates.py:34-54).

This is an *affine suffix recursion*, so it admits an O(log T)-span
evaluation via ``lax.associative_scan`` over affine-map elements
``lam_k = F_k @ lam_{k+1} + c_k``.  Unlike the reference (which manually
time-reverses the arrays, costates.py:34-40), we use the scan's native
``reverse=True`` suffix mode and batched matmuls (no inner vmap), which XLA
maps onto batched MXU ops directly.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import grad, lax

from ipoc_tpu.problem import OCP, Derivatives


def affine_combine(earlier, later):
    """Compose affine maps: ``earlier(later(v))``.

    Element (F, c) represents ``v -> F @ v + c``.  Batched over leading axes.
    This single combine serves both the costate scan here and the parallel
    LQT forward pass (parallel/lqt.py), sharing one element definition so
    seq == par is testable by construction (SURVEY §7 L3).
    """
    Fa, ca = earlier
    Fb, cb = later
    F = Fa @ Fb
    c = jnp.einsum("...ij,...j->...i", Fa, cb) + ca
    return F, c


def seq_costates(ocp: OCP, final_state, d: Derivatives):
    """Reverse ``lax.scan`` costate recursion (reference costates.py:43-54)."""
    lam_T = grad(ocp.final_cost)(final_state)

    def body(lam, inp):
        cx, fx = inp
        lam = cx + fx.T @ lam
        return lam, lam

    _, lams = lax.scan(body, lam_T, (d.cx, d.fx), reverse=True)
    return jnp.concatenate([lams, lam_T[None]], axis=0)


def par_costates(ocp: OCP, final_state, d: Derivatives):
    """O(log T)-span costate recursion via reverse associative scan.

    Same output as :func:`seq_costates` (reference costates.py:34-40
    semantics).  Elements: stage k is the affine map
    ``lam -> fx_k^T @ lam + cx_k``; a terminal element ``(0, lam_T)``
    absorbs the boundary condition, so suffix-combination at k yields
    ``lam_k`` in the constant slot.
    """
    lam_T = grad(ocp.final_cost)(final_state)
    F = jnp.concatenate(
        [jnp.swapaxes(d.fx, -1, -2), jnp.zeros_like(d.fx[:1])], axis=0
    )
    c = jnp.concatenate([d.cx, lam_T[None]], axis=0)
    # In a reverse scan fn receives (later-combination, earlier-element);
    # we want earlier-composed-with-later, hence the argument swap.
    _, lams = lax.associative_scan(
        lambda a, b: affine_combine(b, a), (F, c), reverse=True, axis=0
    )
    return lams
