"""The persistent compilation cache helper."""

import os

import jax
import pytest

from cmfem_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    keys = (compile_cache.CACHE_DIR_OPTION,
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_is_honoured(tmp_path, monkeypatch, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets no
    path of its own."""
    path = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
    jax.config.update(compile_cache.CACHE_DIR_OPTION, "untouched")
    assert compile_cache.enable_compile_cache() == path
    assert os.path.isdir(path)
    assert getattr(jax.config, compile_cache.CACHE_DIR_OPTION) == "untouched"


def test_default_is_the_repo_cache(monkeypatch, restore_cache_config):
    """Without the env var, the cache is the fixed .jax_cache at the
    repository root, which .gitignore lists."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(root, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == expected
    assert compile_cache.enable_compile_cache() == expected
    assert getattr(jax.config, compile_cache.CACHE_DIR_OPTION) == expected
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
