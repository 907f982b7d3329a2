"""chip_smoke.py's phases at 16x16 on the CPU, called directly.

On the CPU the auto backend is woop_mxu and the Triton kernel runs in
the Pallas interpreter; main() itself still refuses to run without a GPU
(checked here too). The GPU run at 1920x1080 is `python chip_smoke.py`.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from tpu_restir.kernels import ray_tri

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "no GPU" in out


def test_script_alone_fails(tmp_path):
    """Without the rest of the repo the script exits non-zero and prints
    no result line."""
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not any(ln.startswith("{") and json.loads(ln).get("ok")
                   for ln in r.stdout.splitlines())


def test_phase_cornell_forward():
    # at 16x16 one pixel that takes another ReSTIR decision is 0.4 % of
    # the image, hence limits looser than the 1080p ones
    out = chip_smoke.phase_cornell_forward(16, 16, 3, mean_rtol=5e-3,
                                           mae_rel=5e-2)
    assert out["rays_per_frame"] == 28 * 16 * 16
    assert out["frame_ms"] > 0


def test_phase_kernel_parity(monkeypatch):
    monkeypatch.setattr(ray_tri, "INTERPRET", True)
    out = chip_smoke.phase_kernel_parity(16, 16)
    assert out["n_rays"] == 256 and out["n_tris"] == 36


def test_phase_cli(tmp_path):
    out = chip_smoke.phase_cli(16, 16, str(tmp_path))
    assert os.path.exists(tmp_path / "cornell_cli.png.txt")
    assert out["cli_s"] > 0


def test_phase_scenes():
    out = chip_smoke.phase_scenes(16, 16, scale=0.05)
    assert set(out) == {"lights1k", "terrain100k"}
    assert all(v["frame_ms"] > 0 for v in out.values())


def test_read_png_rejects_garbage(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"not a png")
    with pytest.raises(AssertionError):
        chip_smoke.read_png(str(p))
