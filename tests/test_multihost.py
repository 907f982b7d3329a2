"""Multi-host distributed backend test (SURVEY.md §5.8).

Exercises dist.mesh.init_distributed with a real 2-process
jax.distributed cluster on CPU (4 virtual devices per process, 8 global)
— the same code path a multi-host GPU launch takes — and checks that the
row-sharded ReSTIR frame over the cross-process global mesh matches the
single-chip render on each process's addressable shards. The worker also
reports halo traffic per frame (the scaling-overhead datapoint recorded
in README/BENCH).
"""

import os
import socket
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # repo root ONLY: nothing else on the path may import and initialize
    # jax before the worker calls distributed.initialize
    env["PYTHONPATH"] = _ROOT
    # share the test compilation cache (big compile, two processes)
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(_ROOT, ".jax_cache"))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_ROOT, "tests",
                                          "multihost_worker.py"),
             coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_ROOT)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, f"pid {pid} no OK:\n{out[-4000:]}"
