"""Persistent XLA compilation cache location.

Entry points (the CLI, bench.py, chip_smoke.py, tools/*) call `enable()`
before their first compile. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX
already reads it and nothing is changed. Otherwise the cache goes to
`.jax_cache` at the root of the checkout: a fixed path, because the path
is part of what makes a later run find the entries again.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
