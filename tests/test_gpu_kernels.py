"""Compiled Triton ray_tri kernels against brute on an NVIDIA GPU.

Marked `gpu`: they skip elsewhere (the kernels compile only for a GPU;
tests/test_kernels_pallas.py runs the same kernels interpreted on the
CPU). Run on a card with:  RESTIR_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_restir.config import IntersectorConfig
from tpu_restir.kernels import ray_tri
from tpu_restir.render import intersect
from tpu_restir.scene import cornell_box
from tpu_restir.scene.procedural import triangle_soup

_BRUTE = IntersectorConfig(backend="brute")


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["cornell", "soup512"])
def test_compiled_ray_tri_matches_brute(which):
    scene = cornell_box() if which == "cornell" else triangle_soup(512)
    rng = np.random.default_rng(3)
    n = 1 << 16
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    t, _u, _v, tri = ray_tri.closest_hit(scene, o, d, tn, tf)
    b = intersect.intersect_closest(scene, o, d, tn, tf, _BRUTE)
    hit = np.asarray(tri) >= 0
    # hit masks may differ only inside the 1e-5 barycentric edge slack
    assert np.mean(hit != np.asarray(b.hit)) < 1e-3
    both = hit & np.asarray(b.hit)
    np.testing.assert_allclose(np.asarray(t)[both], np.asarray(b.t)[both],
                               rtol=1e-4, atol=1e-5)
    occ = ray_tri.any_hit(scene, o, d, tn, jnp.full((n,), 1.5))
    occ_b = intersect.intersect_any(scene, o, d, tn, jnp.full((n,), 1.5),
                                    _BRUTE)
    assert np.mean(np.asarray(occ) != np.asarray(occ_b)) < 1e-3
