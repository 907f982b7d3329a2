"""Woop-transform (woop_mxu) intersection backend must agree with the
Möller-Trumbore brute-force baseline."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir.config import IntersectorConfig
from tpu_restir.render import intersect
from tpu_restir.scene import cornell_box, many_lights_scene


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = np.array([[0.0, -3.5, 1.0]], np.float32) \
        + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_woop_matches_brute_closest():
    scene = cornell_box()
    o, d = _random_rays(800)
    a = intersect.intersect_closest(scene, o, d, 0.001, jnp.inf,
                                    IntersectorConfig(backend="brute"))
    b = intersect.intersect_closest(scene, o, d, 0.001, jnp.inf,
                                    IntersectorConfig(backend="woop_mxu"))
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=5e-4)


def test_woop_matches_brute_any():
    scene = many_lights_scene(64)
    o, d = _random_rays(500, seed=3)
    tfar = jnp.full((500,), 2.5)
    a = intersect.intersect_any(scene, o, d, 0.01, tfar,
                                IntersectorConfig(backend="brute"))
    b = intersect.intersect_any(scene, o, d, 0.01, tfar,
                                IntersectorConfig(backend="woop_mxu"))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_woop_blocked_matches_unblocked():
    scene = many_lights_scene(100)
    o, d = _random_rays(300, seed=5)
    a = intersect.intersect_closest(
        scene, o, d, 0.001, jnp.inf,
        IntersectorConfig(backend="woop_mxu", tri_block=64, ray_chunk=128))
    b = intersect.intersect_closest(
        scene, o, d, 0.001, jnp.inf,
        IntersectorConfig(backend="woop_mxu"))
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), rtol=1e-5)
