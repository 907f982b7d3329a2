"""chip_smoke.py's four-device phase at 16x16 on four virtual CPU
devices: the row-sharded step and value_and_grad against one device."""

import chip_smoke


def test_phase_four():
    out = chip_smoke.phase_four(16, 16)
    assert out["frame_mae_rel"] <= chip_smoke.FRAME_MAE_REL
    assert out["grad_rel_l2"] <= chip_smoke.GRAD_REL_L2
