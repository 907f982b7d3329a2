"""Wide-BVH (8-ary) build + traversal tests.

Oracles: the bvh backend must match the brute
backend hit-for-hit on >=10k-triangle scenes; leaf coverage must be an
exact partition of the primitive range.
"""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir.config import IntersectorConfig
from tpu_restir.render import intersect
from tpu_restir.scene.procedural import terrain_scene, triangle_soup

_BVH = IntersectorConfig(backend="bvh")
_BRUTE = IntersectorConfig(backend="brute")


def _rays(rng, n, extent):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    return jnp.asarray(o), jnp.asarray(d), tn, tf


def test_leaf_coverage_partition():
    scene = triangle_soup(3000)
    meta = np.asarray(scene.bvh.meta).reshape(-1)
    leaf = meta[meta < 0]
    enc = -leaf - 1
    start = enc >> 5
    count = enc & 31
    idx = np.sort(np.concatenate(
        [np.arange(s, s + c) for s, c in zip(start, count)]))
    np.testing.assert_array_equal(idx, np.arange(scene.num_tris))
    # internal child ids are valid node ids, none pointing at the root
    internal = meta[meta > 0]
    assert internal.min() > 0
    assert internal.max() < scene.bvh.meta.shape[0]


def test_bvh_matches_brute_closest_incoherent():
    scene = triangle_soup(10_000)
    rng = np.random.default_rng(21)
    o, d, tn, tf = _rays(rng, 2048, 2.0)

    hb = intersect.intersect_closest(scene, o, d, tn, tf, _BRUTE)
    hv = intersect.intersect_closest(scene, o, d, tn, tf, _BVH)

    np.testing.assert_array_equal(np.asarray(hv.hit), np.asarray(hb.hit))
    m = np.asarray(hb.hit)
    # same Moller-Trumbore op sequence => per-triangle t is bit-identical;
    # winners can differ only on exact-t ties
    diff = m & (np.asarray(hv.tri) != np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(hv.t)[diff],
                                  np.asarray(hb.t)[diff])
    same = m & ~diff
    np.testing.assert_array_equal(np.asarray(hv.t)[same],
                                  np.asarray(hb.t)[same])
    np.testing.assert_array_equal(np.asarray(hv.u)[same],
                                  np.asarray(hb.u)[same])
    np.testing.assert_array_equal(np.asarray(hv.v)[same],
                                  np.asarray(hb.v)[same])
    assert diff.mean() < 0.01


def test_bvh_matches_brute_any():
    scene = triangle_soup(10_000)
    rng = np.random.default_rng(22)
    o, d, tn, _ = _rays(rng, 2048, 2.0)
    tf = jnp.full((o.shape[0],), 1.5, jnp.float32)
    ob = intersect.intersect_any(scene, o, d, tn, tf, _BRUTE)
    ov = intersect.intersect_any(scene, o, d, tn, tf, _BVH)
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ob))


def test_bvh_terrain_parity_and_auto_backend():
    scene = terrain_scene(20_000)
    assert scene.bvh is not None
    # auto picks the packet-cluster backend at scale; the wide BVH stays
    # available explicitly
    assert intersect._backend(scene, IntersectorConfig()) == "fcluster"
    rng = np.random.default_rng(23)
    n = 1024
    # coherent-ish camera rays from above the terrain
    o = np.tile(np.array([0.0, -6.0, 4.0], np.float32), (n, 1))
    at = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    at[:, 2] = 0.5
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    hb = intersect.intersect_closest(scene, o, d, tn, tf, _BRUTE)
    hv = intersect.intersect_closest(scene, o, d, tn, tf, _BVH)
    np.testing.assert_array_equal(np.asarray(hv.hit), np.asarray(hb.hit))
    m = np.asarray(hb.hit)
    np.testing.assert_allclose(np.asarray(hv.t)[m], np.asarray(hb.t)[m],
                               rtol=0, atol=0)


def test_bvh_closest_grads_match_fused_formula():
    """The detached-winner VJP through the bvh backend must agree with
    autodiff of the brute backend (same estimator as kernels/ray_tri)."""
    scene = triangle_soup(6000)
    rng = np.random.default_rng(24)
    o, d, tn, tf = _rays(rng, 256, 1.5)
    g = jnp.asarray(rng.standard_normal(o.shape[0]), jnp.float32)

    def loss(cfg):
        def f(o_, d_):
            hit = intersect.intersect_closest(scene, o_, d_, tn, tf, cfg)
            return jnp.sum(hit.hit.astype(jnp.float32) * g * hit.t)
        return f

    go_v, gd_v = jax.grad(loss(_BVH), argnums=(0, 1))(o, d)
    go_b, gd_b = jax.grad(loss(_BRUTE), argnums=(0, 1))(o, d)
    np.testing.assert_allclose(np.asarray(go_v), np.asarray(go_b),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gd_v), np.asarray(gd_b),
                               rtol=2e-3, atol=2e-3)
