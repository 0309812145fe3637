"""Sequential Newton trial (reverse/forward scans) tests.

The sequential trial must agree with the parallel LQT pipeline — same
quadratic model, same stationary point, same predicted-reduction formula
(reference seq_interior_point_newton.py:42-90 vs
par_interior_point_newton.py:107-124).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ipoc_tpu
from ipoc_tpu.models import cartpole, pendulum
from ipoc_tpu.ops.derivatives import compute_derivatives, compute_lqr_params
from ipoc_tpu.parallel.costates import par_costates
from ipoc_tpu.parallel.lqt import newton_lqt, par_bwd_pass, par_fwd_pass
from ipoc_tpu.problem import Derivatives, LinearizedOCP
from ipoc_tpu.solvers.ip_newton import _regularized, _seq_trial_scan
from ipoc_tpu.utils.integrators import rollout


def _stage_data(model, T, rp=1.0, bp=0.1, dtype=jnp.float32):
    ocp = model.make_ocp(1.0 / T)
    x0 = model.initial_state(dtype)
    u0 = (0.1 * jax.random.normal(jax.random.PRNGKey(1), (T, 1))).astype(dtype)
    X = rollout(ocp.dynamics, u0, x0)
    d = compute_derivatives(ocp, X, u0, dtype(bp))
    lam = par_costates(ocp, X[-1], d)
    lin = compute_lqr_params(lam, d)
    lin_reg = _regularized(lin, d, dtype(rp), True)
    XT = jax.hessian(ocp.final_cost)(X[-1])
    return ocp, d, lin_reg, XT


def _assert_matches_par_pipeline(lin_reg, d, XT, nx):
    lqt = newton_lqt(lin_reg, d, XT)
    K, kff, _, _, pred_ref, feas_ref = par_bwd_pass(lqt)
    du_ref, dx_ref = par_fwd_pass(lqt, jnp.zeros(nx, jnp.float64), K, kff)

    du, dx, pred, ok = _seq_trial_scan(lin_reg, d, XT)
    scale = float(jnp.abs(du_ref).max()) + 1e-9
    np.testing.assert_allclose(du, du_ref, atol=1e-9 * scale)
    np.testing.assert_allclose(dx, dx_ref, atol=1e-9 * scale)
    np.testing.assert_allclose(float(pred), float(pred_ref), rtol=1e-9)
    assert bool(ok) == bool(feas_ref)


@pytest.mark.parametrize("model,T,nx", [
    (cartpole, 8, 4),
    pytest.param(cartpole, 40, 4, marks=pytest.mark.slow),
    pytest.param(pendulum, 60, 2, marks=pytest.mark.slow),
])
def test_seq_trial_scan_matches_par_pipeline(model, T, nx):
    """The sequential trial == the parallel LQT pipeline (f64)."""
    _, d, lin_reg, XT = _stage_data(model, T, dtype=jnp.float64)
    _assert_matches_par_pipeline(lin_reg, d, XT, nx)


def test_seq_trial_multi_input_matches_par_pipeline():
    """nu > 1: the gain solve ``Quu [k | K] = -[Qu | Qxu^T]`` on random
    well-conditioned multi-input stage data == the parallel pipeline."""
    nx, nu, T = 3, 2, 7
    ks = iter(jax.random.split(jax.random.PRNGKey(0), 10))

    def rnd(*s):
        return jax.random.normal(next(ks), s, jnp.float64) * 0.3

    A_ = rnd(T, nx, nx)
    Q = A_ @ jnp.swapaxes(A_, -1, -2) + 2 * jnp.eye(nx)
    Br = rnd(T, nu, nu)
    R = Br @ jnp.swapaxes(Br, -1, -2) + 2 * jnp.eye(nu)
    lin_reg = LinearizedOCP(rnd(T, nu), Q, R, rnd(T, nx, nu) * 0.1)
    d = Derivatives(None, None, None, None, None, rnd(T, nx, nx),
                    rnd(T, nx, nu), None, None, None)
    XTa = rnd(nx, nx)
    XT = XTa @ XTa.T + jnp.eye(nx)
    _assert_matches_par_pipeline(lin_reg, d, XT, nx)


def test_solver_newton_impl_seq_agrees():
    """Full IP solve with newton_impl='seq' matches the default 'par' path."""
    ocp = pendulum.make_ocp(1.0 / 60)
    x0 = pendulum.initial_state(jnp.float64)
    u0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (60, 1))
    cfg_par = ipoc_tpu.FAST_CONFIG
    cfg_seq = cfg_par.replace(newton_impl="seq")
    u_par, it_par = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
            ocp, u, x, cfg_par
        )
    )(u0, x0)
    u_seq, it_seq = jax.jit(
        lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
            ocp, u, x, cfg_seq
        )
    )(u0, x0)
    np.testing.assert_allclose(u_seq, u_par, atol=2e-3)
    assert int(it_seq) > 0
