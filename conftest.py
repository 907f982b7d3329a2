# Root conftest: configure JAX for tests.
#
# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# (tpu_restir/dist) are exercised without GPUs, per the project's test
# strategy (SURVEY.md §4, item 4: single-chip vs multi-chip parity).
import os

# Persistent compilation cache: XLA-CPU compiles on this machine are slow
# (~0.5-1 s per tiny executable), so caching across test runs cuts minutes
# off every pytest invocation.
_CACHE_DIR = os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), ".jax_cache"))

# Force CPU, whatever JAX_PLATFORMS the environment presets; jax may
# already be imported, so also update jax.config directly (valid until a
# backend initializes). RESTIR_TEST_GPU=1 leaves the platform to JAX, to
# run the tests marked `gpu` on a card (README: "Tests").
_ON_GPU = os.environ.get("RESTIR_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere "
        "(run with RESTIR_TEST_GPU=1 python -m pytest tests/ -m gpu)")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    # decided per test at run time, never while modules are imported
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel); "
                    "chip_smoke.py covers it on the card")
