"""The parallel-in-time scans against plain sequential recursions.

``par_costates`` (affine suffix scan), ``par_fwd_pass`` (affine prefix
scan) and ``par_bwd_pass`` (value-function scan) are XLA associative scans
on every backend.  Their combine trees differ with the horizon's binary
structure, so they are pinned at odd, power-of-two and ragged lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipoc_tpu.models import cartpole
from ipoc_tpu.parallel.costates import par_costates
from ipoc_tpu.parallel.lqt import par_bwd_pass, par_fwd_pass, seq_bwd_pass_full
from ipoc_tpu.problem import Derivatives
from tests.conftest import make_random_lqt


@pytest.mark.parametrize("T", [5, 7, 128, 130])
def test_scans_match_sequential_recursion(rng, T):
    nx, nu = 4, 2
    # affine suffix scan: lam_k = cx_k + fx_k^T lam_{k+1}, lam_T = grad(phi)
    ocp = cartpole.make_ocp(0.01)
    cx = jnp.asarray(rng.normal(size=(T, nx)))
    fx = jnp.asarray(0.3 * rng.normal(size=(T, nx, nx)))
    xT = jnp.asarray(rng.normal(size=(nx,)))
    d = Derivatives(cx, None, None, None, None, fx, None, None, None, None)
    lam = [np.asarray(jax.grad(ocp.final_cost)(xT))]
    for k in reversed(range(T)):
        lam.insert(0, np.asarray(cx[k]) + np.asarray(fx[k]).T @ lam[0])
    np.testing.assert_allclose(par_costates(ocp, xT, d), np.stack(lam),
                               rtol=1e-10, atol=1e-10)

    # value scan (backward pass) and affine prefix scan (forward pass)
    lqt = make_random_lqt(rng, T=T, nx=nx, nu=nu)
    Kp, dp, Sp, vp, predp, feasp = par_bwd_pass(lqt)
    Ks, ds, Ss, vs, preds, feass = seq_bwd_pass_full(lqt)
    np.testing.assert_allclose(Kp, Ks, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(dp, ds, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(Sp, Ss, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(predp, preds, rtol=1e-8)
    assert bool(feasp) and bool(feass)

    x0 = jnp.asarray(rng.normal(size=(nx,)))
    u, x = par_fwd_pass(lqt, x0, Kp, dp)
    xs = [np.asarray(x0)]
    for k in range(T):
        uk = np.asarray(dp[k]) - np.asarray(Kp[k]) @ xs[-1]
        np.testing.assert_allclose(u[k], uk, rtol=1e-8, atol=1e-9)
        xs.append(np.asarray(lqt.A[k]) @ xs[-1] + np.asarray(lqt.B[k]) @ uk
                  + np.asarray(lqt.c[k]))
    np.testing.assert_allclose(x, np.stack(xs), rtol=1e-8, atol=1e-9)
