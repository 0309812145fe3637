"""Fused lane-iteration tests.

Four layers:
* the Triton kernel in Pallas interpret mode against the plain reference
  composition ``_fused_reference`` (pipeline match up to f32 summation
  order), at an exact and at a ragged (padded) lane count;
* the rule that picks the kernel: backend, dtype and state dimension;
* the DDP evaluator's composition against one ip_ddp trial;
* solver-level equivalence: ``newton_impl="fused"`` must reproduce the
  ``"seq"`` solver's per-lane trial sequences bit-for-bit on CPU f64, and
  the streaming executor on the fused config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import cartpole, pendulum, quadrotor, unicycle
from ipoc_tpu.ops import pallas as ops_pallas
from ipoc_tpu.ops.pallas.fused_iter_kernel import (
    _fused_ddp_reference,
    _fused_reference,
    fused_newton_iter_batched,
    make_fused_iter,
)
from ipoc_tpu.solvers.batched import make_batch, solve_batch
from ipoc_tpu.solvers.stream import solve_stream
from ipoc_tpu.utils.integrators import rollout

SINGLE = ipoc_tpu.FAST_CONFIG.replace(
    globalization="single", barrier_mode="flat"
)
NAMES = ["temp_x", "temp_u", "cost", "new_cost", "max_c", "pred", "ok", "hu"]


def _iterate(model, T, B, dtype=jnp.float32, seed=0):
    """A random feasible iterate ``(ocp, x, u, bp, reg)`` of ``B`` lanes."""
    if model is quadrotor:
        ocp, nu = quadrotor.make_ocp(0.05), 2
    elif model is unicycle:
        ocp, nu = unicycle.make_ocp(2.0 / T), 2
    else:
        ocp, nu = model.make_ocp(1.0 / T), 1
    x0 = model.initial_state(dtype)
    u0, x0b = make_batch(
        jax.random.PRNGKey(seed), x0, B, T, nu,
        state_scale=0.05, control_scale=0.1, dtype=dtype,
    )
    if model is quadrotor:
        u0 = u0 + quadrotor.hover_controls(T, dtype)[None]
    elif model is unicycle:
        u0 = u0.at[..., 0].add(0.3)
    X = jax.vmap(lambda u, x: rollout(ocp.dynamics, u, x))(u0, x0b)
    bp = jnp.full((B,), 0.1, dtype)
    reg = jnp.full((B,), 3.0, dtype)
    return ocp, X, u0, bp, reg


def _assert_outputs_close(got, want, tol):
    for nm, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, nm
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=nm)


@pytest.mark.parametrize("B", [4, 5], ids=["exact", "ragged"])
@pytest.mark.parametrize("model", [pendulum, cartpole, quadrotor, unicycle],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_kernel_matches_reference_composition(model, B):
    """Interpret-mode Triton kernel == plain composition (f32), with 4
    lanes per program: B=4 fills one program, B=5 pads a second."""
    ocp, X, u0, bp, reg = _iterate(model, 6, B)
    with jax.enable_x64(False):
        ker = fused_newton_iter_batched(ocp, X, u0, bp, reg, block_lanes=4,
                                        interpret=True)
        ref = jax.vmap(lambda x, u, b, r: _fused_reference(ocp, x, u, b, r)
                       )(X, u0, bp, reg)
    assert bool(jnp.all(ref[6]))
    _assert_outputs_close(ker, ref, 5e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("model,T", [(cartpole, 100), (quadrotor, 40)],
                         ids=["cartpole", "quadrotor"])
def test_kernel_on_gpu_matches_reference(gpu_device, model, T):
    """The compiled Triton kernel == plain composition on the card, f32.
    Tolerance 1e-4 of each output's scale: summation order differs."""
    ocp, X, u0, bp, reg = _iterate(model, T, 256)
    with jax.enable_x64(False), jax.default_device(gpu_device):
        ker = jax.jit(lambda *a: fused_newton_iter_batched(ocp, *a))(
            X, u0, bp, reg)
        ref = jax.jit(jax.vmap(
            lambda x, u, b, r: _fused_reference(ocp, x, u, b, r)))(
                X, u0, bp, reg)
    ok = np.asarray(ref[6]) & np.asarray(ker[6])
    assert ok.mean() > 0.9
    for nm, a, b in zip(NAMES, ker, ref):
        a, b = np.asarray(a)[ok], np.asarray(b)[ok]
        if a.dtype != bool:
            scale = np.abs(b).max() + 1e-6
            np.testing.assert_allclose(a, b, atol=1e-4 * scale, err_msg=nm)


def test_kernel_flags_indefinite_control_block():
    """A negative Levenberg shift makes R indefinite: the kernel's minimum
    pivot must reject the trial exactly where the reference does."""
    ocp, X, u0, bp, _ = _iterate(pendulum, 6, 4)
    reg = jnp.asarray([3.0, -1e4, 3.0, -1e4], jnp.float32)
    with jax.enable_x64(False):
        ker = fused_newton_iter_batched(ocp, X, u0, bp, reg, block_lanes=4,
                                        interpret=True)
        ref = jax.vmap(lambda x, u, b, r: _fused_reference(ocp, x, u, b, r)
                       )(X, u0, bp, reg)
    np.testing.assert_array_equal(np.asarray(ker[6]), [True, False] * 2)
    np.testing.assert_array_equal(np.asarray(ker[6]), np.asarray(ref[6]))


def test_kernel_rejects_non_power_of_two_block():
    ocp, X, u0, bp, reg = _iterate(pendulum, 6, 4)
    with pytest.raises(ValueError, match="power of two"):
        fused_newton_iter_batched(ocp, X, u0, bp, reg, block_lanes=6,
                                  interpret=True)


@pytest.mark.parametrize("backend,dtype,kernel", [
    ("cpu", jnp.float32, False),
    ("gpu", jnp.float64, False),
    ("gpu", jnp.float32, True),
])
def test_gate_picks_path(monkeypatch, backend, dtype, kernel):
    """The vmapped fused op stages the Triton kernel exactly on the GPU
    backend in float32; CPU runs and float64 trace the plain composition.
    Tracing only: nothing is lowered for the patched backend."""
    monkeypatch.setattr(ops_pallas.jax, "default_backend", lambda: backend)
    assert ops_pallas.use_fused_lane_iter(dtype, 4) is kernel
    assert not ops_pallas.use_fused_lane_iter(dtype, ops_pallas.MAX_NX + 1)
    ocp, X, u0, bp, reg = _iterate(cartpole, 4, 3, dtype=dtype)
    fused = make_fused_iter(ocp)
    with jax.enable_x64(dtype == jnp.float64):
        jaxpr = str(jax.make_jaxpr(jax.vmap(fused))(X, u0, bp, reg))
    assert ("pallas_call" in jaxpr) is kernel


@pytest.mark.parametrize("model", [pendulum, cartpole],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_ddp_reference_matches_ip_ddp_trial(model):
    """The DDP evaluator (reg scale hoisted out) == one trial of the
    reference-structured IP-DDP stage (solvers/ip_ddp.py, f64)."""
    from ipoc_tpu.ops.derivatives import compute_derivatives
    from ipoc_tpu.solvers.ip_ddp import ddp_bwd_pass
    from ipoc_tpu.utils.integrators import closed_loop_rollout

    ocp, X, u0, bp, _ = _iterate(model, 8, 1, dtype=jnp.float64)
    x, u, bp, rp, floor = X[0], u0[0], bp[0], 3.0, 1e-6
    d = compute_derivatives(ocp, x, u, bp)
    ff, gain, pred, ok, Qu = ddp_bwd_pass(ocp.final_cost, x[-1], d, rp, floor)
    tx, tu = closed_loop_rollout(ocp.dynamics, gain, ff, x, u)
    want = (tx, tu, ocp.total_cost(x, u, bp), ocp.total_cost(tx, tu, bp),
            jnp.max(jax.vmap(ocp.constraints)(tx[:-1], tu)), pred, ok,
            jnp.max(jnp.abs(Qu)))
    reg = rp * jnp.maximum(jnp.linalg.norm(d.cu), floor)
    got = _fused_ddp_reference(ocp, x, u, bp, reg)
    assert bool(ok)
    _assert_outputs_close(got, want, 1e-12)


@pytest.mark.parametrize("barrier_mode", ["staged", "flat"])
def test_fused_solver_equals_seq_f64(barrier_mode):
    """Per-lane solves with newton_impl='fused' (plain composition off the
    GPU) must be bit-identical to 'seq' — same trials, same accept/reject,
    same LM."""
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(3), x0, 4, 50, 1,
        state_scale=0.05, control_scale=0.1, dtype=jnp.float64,
    )
    base = SINGLE.replace(barrier_mode=barrier_mode)
    s_seq = jax.jit(lambda u, x: solve_batch(
        ocp, u, x, base.replace(newton_impl="seq")))(u0, x0b)
    s_fus = jax.jit(lambda u, x: solve_batch(
        ocp, u, x, base.replace(newton_impl="fused")))(u0, x0b)
    np.testing.assert_array_equal(np.asarray(s_seq.iterations),
                                  np.asarray(s_fus.iterations))
    np.testing.assert_array_equal(np.asarray(s_seq.controls),
                                  np.asarray(s_fus.controls))


def test_stream_with_fused_config():
    """solve_stream drives the fused trial evaluation per lane."""
    ocp = pendulum.make_ocp(0.02)
    x0 = pendulum.initial_state(jnp.float64)
    u0, x0b = make_batch(
        jax.random.PRNGKey(5), x0, 5, 40, 1,
        state_scale=0.05, control_scale=0.1, dtype=jnp.float64,
    )
    cfg = SINGLE.replace(newton_impl="fused")
    ref = jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))(u0, x0b)
    sol = jax.jit(lambda u, x: solve_stream(ocp, u, x, cfg, lanes=2))(
        u0, x0b)
    np.testing.assert_allclose(np.asarray(sol.controls),
                               np.asarray(ref.controls),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(sol.iterations),
                                  np.asarray(ref.iterations))


def test_fused_requires_exact_terminal_hessian():
    ocp = pendulum.make_ocp(0.02)
    cfg = SINGLE.replace(newton_impl="fused", terminal_hessian="reference")
    with pytest.raises(ValueError, match="terminal_hessian"):
        jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))(
            jnp.zeros((2, 10, 1)), jnp.zeros((2, 2)))


def test_fused_requires_single_globalization():
    ocp = pendulum.make_ocp(0.02)
    cfg = ipoc_tpu.FAST_CONFIG.replace(newton_impl="fused")
    with pytest.raises(ValueError, match="single"):
        jax.jit(lambda u, x: solve_batch(ocp, u, x, cfg))(
            jnp.zeros((2, 10, 1)), jnp.zeros((2, 2)))
