"""Scalar-DAG lifting (ops/pallas/scalarize.py) vs the plain functions.

The fused lane-iteration kernel evaluates the model's per-element stage
functions through :func:`scalar_lift`; these tests pin the lifted
evaluation on lane vectors to the plain function under ``vmap``, across
every model family and every lifted function, and check the structural
simplification actually fires (op counts well below the raw eqn counts).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipoc_tpu.models import cartpole, pendulum, quadrotor
from ipoc_tpu.ops.pallas.fused_iter_kernel import (
    _stage_bwd_fn,
    _stage_fwd_fn,
    _term_fn,
    _term_fwd_fn,
)
from ipoc_tpu.ops.pallas.scalarize import scalar_lift

L = 16
MODELS = {"cartpole": (cartpole, 1), "pendulum": (pendulum, 1),
          "quadrotor": (quadrotor, 2)}


def _lanes(a):
    """(L,) + shape array -> row-major list of (L,) lane vectors."""
    return list(jnp.reshape(a, (a.shape[0], -1)).T)


def _compare(fn, shapes, seed=0):
    rng = np.random.RandomState(seed)
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    with jax.enable_x64(False):
        lane_fn = scalar_lift(fn, *sds)
        args = [jnp.asarray(rng.uniform(0.05, 0.5, (L,) + s), jnp.float32)
                for s in shapes]
        got = lane_fn(*[_lanes(a) for a in args])
        ref = jax.vmap(fn)(*args)
    if not isinstance(ref, tuple):
        ref = (ref,)
    assert len(got) == len(ref)
    for i, (r, g) in enumerate(zip(ref, got)):
        want = np.asarray(r).reshape(L, -1).T
        np.testing.assert_allclose(np.stack([np.asarray(v) for v in g]),
                                   want, rtol=2e-5, atol=2e-5,
                                   err_msg=f"output {i}")
    return lane_fn.stats


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.smoke) if n == "pendulum" else n
    for n in sorted(MODELS)
])
def test_scalarize_matches_plain(name):
    model, nu = MODELS[name]
    ocp = model.make_ocp(0.01)
    nx = model.initial_state(jnp.float32).shape[0]
    ng = (1 + nx) * nu
    _compare(_stage_bwd_fn(ocp, nx, nu), [(nx,), (nu,), (), (nx,)])
    _compare(_term_fn(ocp, nx), [(nx,)])
    _compare(_stage_fwd_fn(ocp, nx, nu), [(nx,), (nu,), (), (nx,), (ng,)])
    _compare(_term_fwd_fn(ocp), [(nx,), (nx,)])
    _compare(ocp.dynamics, [(nx,), (nu,)])


def test_scalarize_folds_basis_structure():
    """The one-hot jvp tangents must fold: the scalarized backward stage
    function for cartpole lands far below the raw vector-eqn count (~1114
    eqns pre-scalarization), and constant folding + CSE both fire."""
    ocp = cartpole.make_ocp(0.01)
    stats = _compare(_stage_bwd_fn(ocp, 4, 1), [(4,), (1,), (), (4,)])
    assert stats["ops"] < 600, stats
    assert stats["folded"] > 100, stats
    assert stats["cse_hits"] > 50, stats


def test_scalarize_rejects_uncovered_primitives():
    def f(x, u):
        return jax.lax.cumsum(x) + u.sum()

    with pytest.raises(NotImplementedError):
        scalar_lift(f, jax.ShapeDtypeStruct((4,), jnp.float32),
                    jax.ShapeDtypeStruct((1,), jnp.float32))


def test_scalarize_integer_bitwise_and_div():
    """lax and/or are BITWISE on integers (simplification must not treat a
    constant operand as boolean), and integer division must not be
    strength-reduced to a float reciprocal multiply."""
    def f(x, u):
        i = x.astype(jnp.int32)
        masked = jnp.bitwise_and(i, 6)      # and with a constant
        floored = i // 3                    # truncating integer division
        return (masked + floored).astype(jnp.float32) + u.sum()

    sds = jax.ShapeDtypeStruct((4,), jnp.float32)
    sdu = jax.ShapeDtypeStruct((1,), jnp.float32)
    with jax.enable_x64(False):
        lane_fn = scalar_lift(f, sds, sdu)
        x = jnp.broadcast_to(jnp.arange(3.0, 7.0, dtype=jnp.float32), (L, 4))
        u = jnp.zeros((L, 1), jnp.float32)
        (got,) = lane_fn(_lanes(x), _lanes(u))
        ref = jax.vmap(f)(x, u)
    np.testing.assert_array_equal(np.stack([np.asarray(v) for v in got]),
                                  np.asarray(ref).T)


def test_scalarize_imports_standalone():
    """The module must import in a fresh process (jax.extend is not
    auto-registered by importing jax alone)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-c",
         "import ipoc_tpu.ops.pallas.scalarize as m; print(m.__name__)"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr
