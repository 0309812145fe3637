"""Test configuration: CPU with 8 virtual devices, f64 enabled.

Correctness tests run in float64 on CPU; multi-device sharding tests use
the idiomatic JAX fake backend — 8 virtual CPU devices via
``--xla_force_host_platform_device_count`` (SURVEY §4).  Tests that need
the GPU carry the ``gpu`` marker and skip on the CPU (the ``gpu_device``
fixture decides at run time); run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

# Must be set before the CPU backend is created.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless JAX_PLATFORMS names another platform (the GPU-marked tests).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else
# <checkout>/.jax_cache): repeat test runs skip XLA recompiles, the dominant
# cost of many of these CPU tests.
from ipoc_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# The default tier is COMPILE-bound (tiny shapes, big second-order-AD
# traces), so skip XLA's expensive optimization passes by default —
# about 2x faster cold suite with identical results (the tests compare
# jax-vs-jax or jax-vs-numpy with explicit
# tolerances; no test depends on fusion/layout choices).
# IPOC_TEST_FULL_OPT=1 restores full optimization.
if os.environ.get("IPOC_TEST_FULL_OPT", "0") != "1":
    jax.config.update("jax_disable_most_optimizations", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX finds none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: this process sees "
                    f"{jax.devices()[0].platform} devices only")
    return gpus[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_random_lqt(rng, T=8, nx=3, nu=2, cross=True, drift=True, dtype=None):
    """Random well-conditioned LQT problem for pass-level tests."""
    import jax.numpy as jnp

    from ipoc_tpu.parallel.lqt import LQT

    def psd(n, scale=1.0):
        A = rng.normal(size=(n, n))
        return scale * (A @ A.T + n * np.eye(n))

    A = jnp.array(rng.normal(size=(T, nx, nx)) * 0.5)
    B = jnp.array(rng.normal(size=(T, nx, nu)))
    c = jnp.array(rng.normal(size=(T, nx)) * 0.3) if drift else jnp.zeros((T, nx))
    X = jnp.array(np.stack([psd(nx, 0.5) for _ in range(T)]))
    U = jnp.array(np.stack([psd(nu, 1.0) for _ in range(T)]))
    M = (
        jnp.array(rng.normal(size=(T, nx, nu)) * 0.2)
        if cross
        else jnp.zeros((T, nx, nu))
    )
    r = jnp.array(rng.normal(size=(T, nx)))
    s = jnp.array(rng.normal(size=(T, nu)))
    H = jnp.broadcast_to(jnp.eye(nx), (T, nx, nx))
    Z = jnp.broadcast_to(jnp.eye(nu), (T, nu, nu))
    XT = jnp.array(psd(nx, 1.0))
    HT = jnp.eye(nx)
    rT = jnp.array(rng.normal(size=(nx,)))
    lqt = LQT(A, B, c, XT, HT, rT, X, H, r, U, Z, s, M)
    if dtype is not None:
        lqt = jax.tree.map(lambda a: a.astype(dtype), lqt)
    return lqt


def lqt_total_cost(lqt, us, x0):
    """Direct (loop) evaluation of the LQT objective — test oracle."""
    import jax.numpy as jnp

    T = lqt.B.shape[0]
    x = x0
    cost = 0.0
    for k in range(T):
        xe = lqt.H[k] @ x - lqt.r[k]
        ue = lqt.Z[k] @ us[k] - lqt.s[k]
        cost = (
            cost
            + 0.5 * xe @ lqt.X[k] @ xe
            + 0.5 * ue @ lqt.U[k] @ ue
            + xe @ lqt.M[k] @ ue
        )
        x = lqt.A[k] @ x + lqt.B[k] @ us[k] + lqt.c[k]
    xe = lqt.HT @ x - lqt.rT
    return cost + 0.5 * xe @ lqt.XT @ xe
