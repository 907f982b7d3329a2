"""compile_cache.enable: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the cache goes to the fixed <repo>/.jax_cache."""

import os

import jax
import pytest

from tpu_restir import compile_cache


@pytest.fixture
def _restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir(env_set, tmp_path, monkeypatch, _restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        # JAX reads the variable itself; the helper sets nothing
        assert jax.config.jax_compilation_cache_dir == "unchanged"
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        d = compile_cache.enable()
        root = os.path.dirname(os.path.dirname(compile_cache.__file__))
        assert d == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
