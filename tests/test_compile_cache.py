"""The entry points' compile-cache helper: an explicit
JAX_COMPILATION_CACHE_DIR wins and is left alone; otherwise the cache is
the fixed <checkout>/.jax_cache directory."""

import os

import jax
import pytest

from gatb_core_tpu.system import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_variable_is_honoured(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_checkout_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expect = os.path.join(root, ".jax_cache")
    assert compile_cache.enable_compile_cache() == expect
    assert jax.config.jax_compilation_cache_dir == expect
    # a fixed path: the same on every call
    assert compile_cache.enable_compile_cache() == expect
