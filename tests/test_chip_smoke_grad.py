"""chip_smoke.py's forward+backward phase at 16x16 on the CPU: the
auto-backend gradients against the brute-backend gradients."""

import chip_smoke


def test_phase_forward_backward():
    # 16x16: looser than the 1080p limit, as in test_chip_smoke.py
    out = chip_smoke.phase_forward_backward(16, 16, reps=1, grad_rel_l2=5e-2)
    assert out["grad_rel_l2"] <= 5e-2
    assert out["fwd_bwd_ms"] > 0
