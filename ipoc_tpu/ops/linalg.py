"""Small dense linear-algebra helpers for tiny blocks.

The reference uses ``jnp.linalg.inv`` (seq_interior_point_newton.py:58-59)
and ``jnp.linalg.eigh`` convexity checks (seq:52-53, ddp:47-48).  Both are
poor choices for tiny SPD systems: we use Cholesky factorization for solves
and the *success of the Cholesky factorization itself* as the
positive-definiteness signal (SURVEY §7 "Hard parts": eigh is expensive;
Cholesky success is the equivalent signal).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def sym(a):
    """Symmetrize (batched) square matrices; cheap drift control."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


# Unrolled small-matrix routines: the state/control blocks here are 1x1 to
# ~8x8, where a library call (LU, Cholesky) carries a large fixed overhead
# per tiny batch element.  The unrolled paths below are pure jnp
# arithmetic: any dtype, any backend, fully fusible.
SMALL_N = 8


def _gauss_solve_small(A, B):
    """Batched n<=SMALL_N solve via Gaussian elimination, partial pivoting.

    A (..., n, n), B (..., n, k) -> (..., n, k).
    """
    n = A.shape[-1]
    idx = jnp.arange(n)
    for col in range(n):
        # Partial pivot: strongest row at/below `col` in column `col`.
        colvals = jnp.abs(A[..., :, col])
        colvals = jnp.where(idx >= col, colvals, -jnp.inf)
        p = jnp.argmax(colvals, axis=-1)  # (...,)
        # Permutation swapping rows col <-> p (batched).
        pb = p[..., None]
        perm = jnp.where(
            idx == col, pb, jnp.where(idx == pb, col, idx)
        )
        A = jnp.take_along_axis(A, perm[..., None], axis=-2)
        B = jnp.take_along_axis(B, perm[..., None], axis=-2)
        # Eliminate below the pivot.
        pivot = A[..., col, col][..., None]
        if col + 1 < n:
            factor = A[..., col + 1 :, col] / pivot  # (..., n-col-1)
            A = A.at[..., col + 1 :, :].add(
                -factor[..., None] * A[..., col : col + 1, :]
            )
            B = B.at[..., col + 1 :, :].add(
                -factor[..., None] * B[..., col : col + 1, :]
            )
    # Back substitution.
    for row in range(n - 1, -1, -1):
        rhs = B[..., row, :]
        for j in range(row + 1, n):
            rhs = rhs - A[..., row, j][..., None] * B[..., j, :]
        B = B.at[..., row, :].set(rhs / A[..., row, row][..., None])
    return B


def _gauss_solve_small_nopivot(A, B):
    """Batched n<=SMALL_N solve, no pivoting: pure arithmetic, no gathers.

    For diagonally-sound systems (regularized Newton blocks, ``I + C J``
    with PSD factors) this avoids the expensive batched ``take_along_axis``
    row swaps of the pivoted path, which can dominate the whole solve.  Not safe for arbitrary matrices.
    """
    n = A.shape[-1]
    for col in range(n):
        pivot = A[..., col, col][..., None]
        if col + 1 < n:
            factor = A[..., col + 1 :, col] / pivot
            A = A.at[..., col + 1 :, :].add(
                -factor[..., None] * A[..., col : col + 1, :]
            )
            B = B.at[..., col + 1 :, :].add(
                -factor[..., None] * B[..., col : col + 1, :]
            )
    for row in range(n - 1, -1, -1):
        rhs = B[..., row, :]
        for j in range(row + 1, n):
            rhs = rhs - A[..., row, j][..., None] * B[..., j, :]
        B = B.at[..., row, :].set(rhs / A[..., row, row][..., None])
    return B


def _cholesky_small(A):
    """Batched n<=SMALL_N lower Cholesky; NaN entries when not PD."""
    n = A.shape[-1]
    L = jnp.zeros_like(A)
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[..., j, k] * L[..., j, k]
        Ljj = jnp.sqrt(d)  # NaN for negative d == not PD
        L = L.at[..., j, j].set(Ljj)
        for i in range(j + 1, n):
            off = A[..., i, j]
            for k in range(j):
                off = off - L[..., i, k] * L[..., j, k]
            L = L.at[..., i, j].set(off / Ljj)
    return L


def _tri_solve_small(L, B, lower=True):
    """Batched triangular solve against matrix RHS, unrolled."""
    n = L.shape[-1]
    order = range(n) if lower else range(n - 1, -1, -1)
    for row in order:
        rhs = B[..., row, :]
        inner = range(row) if lower else range(row + 1, n)
        for j in inner:
            rhs = rhs - L[..., row, j][..., None] * B[..., j, :]
        B = B.at[..., row, :].set(rhs / L[..., row, row][..., None])
    return B


def cholesky(A):
    """Batched Cholesky; unrolled for small n, LAPACK-style otherwise."""
    if A.shape[-1] <= SMALL_N:
        return _cholesky_small(A)
    return jnp.linalg.cholesky(A)


def _mutual_broadcast(A, b):
    batch = jnp.broadcast_shapes(A.shape[:-2], b.shape[:-2])
    return (
        jnp.broadcast_to(A, batch + A.shape[-2:]),
        jnp.broadcast_to(b, batch + b.shape[-2:]),
    )


def cholesky_solve(A, b):
    """Solve ``A x = b`` for symmetric positive-definite A via Cholesky.

    Works on batched operands.  ``b`` is a single vector if ``b.ndim == 1``,
    otherwise a (batched, broadcastable) matrix (..., n, k) — same convention
    as ``jnp.linalg.solve`` on JAX >= 0.5.  Returns NaNs if A is not PD —
    callers pair this with :func:`is_posdef` (the reference instead pairs
    explicit inverses with eigh checks).
    """
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    A = sym(A)
    A, b = _mutual_broadcast(A, b)
    if A.shape[-1] <= SMALL_N:
        L = _cholesky_small(A)
        y = _tri_solve_small(L, b, lower=True)
        x = _tri_solve_small(jnp.swapaxes(L, -1, -2), y, lower=False)
    else:
        L = jnp.linalg.cholesky(A)
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        x = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(L, -1, -2), y, lower=False
        )
    if vec:
        x = x[..., 0]
    return x


def is_posdef(A):
    """Positive-definiteness via Cholesky success (all-finite factor).

    Equivalent decision to the reference's ``all(eigh(A) > 0)``
    (seq_interior_point_newton.py:52-53) at a fraction of the cost.
    Reduces over all leading batch axes.
    """
    L = cholesky(sym(A))
    return jnp.all(jnp.isfinite(L))


def solve(A, b, pivot: bool = True):
    """General (non-SPD) batched linear solve.

    Unrolled elimination for small n (any dtype, any backend); LU
    otherwise.  ``b`` is a single vector iff ``b.ndim == 1``,
    otherwise a broadcastable matrix (jnp.linalg.solve convention on
    JAX >= 0.5).  ``pivot=False`` selects the gather-free elimination for
    diagonally-sound systems (see :func:`_gauss_solve_small_nopivot`).
    """
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    if A.shape[-1] <= SMALL_N:
        A, b = _mutual_broadcast(A, b)
        fn = _gauss_solve_small if pivot else _gauss_solve_small_nopivot
        x = fn(A, b)
    else:
        x = jnp.linalg.solve(A, b)
    if vec:
        x = x[..., 0]
    return x
