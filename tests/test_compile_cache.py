"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins, else the
checkout's own ``.jax_cache``."""

import os
import subprocess
import sys

import jax
import pytest

from ipoc_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_names_the_cache(tmp_path):
    """In a fresh process with the variable set, the helper leaves JAX on
    that directory and returns it."""
    code = ("import jax; from ipoc_tpu.utils.compile_cache import "
            "use_compile_cache as u; p = u(); "
            "print(p == jax.config.jax_compilation_cache_dir, p)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", str(tmp_path)]


def test_default_is_inside_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.use_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
