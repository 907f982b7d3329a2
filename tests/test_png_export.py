"""save_png writes a standard 8-bit RGBA PNG (stdlib zlib, no PIL):
read back with PIL here, and with chip_smoke's own reader."""

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from tpu_restir.io.export import save_png


@pytest.mark.parametrize("h,w", [(1, 1), (5, 37), (48, 64)])
def test_png_round_trip(tmp_path, h, w):
    rng = np.random.default_rng(h * w)
    img = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    path = str(tmp_path / "sub" / "img.png")
    save_png(path, img)
    want = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    with Image.open(path) as im:
        assert im.mode == "RGBA" and im.size == (w, h)
        got = np.asarray(im)
    np.testing.assert_array_equal(got[..., :3], want)
    assert np.all(got[..., 3] == 255)
    np.testing.assert_array_equal(chip_smoke.read_png(path), got)
