"""Packet-cluster (fcluster) backend tests — the production large-scene
path (round 3; replaces the wide-BVH lockstep walk as the auto choice).

Oracles: hit-for-hit parity with the brute backend on coherent and
incoherent ray sets (same Möller-Trumbore op sequence => bit-identical t
on the winning triangle), tile-swizzle transparency, and detached-winner
gradients matching brute autodiff."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir.config import IntersectorConfig
from tpu_restir.render import intersect
from tpu_restir.scene.procedural import terrain_scene, triangle_soup

_FC = IntersectorConfig(backend="fcluster")
_BRUTE = IntersectorConfig(backend="brute")


def _rays(rng, n, extent):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    return jnp.asarray(o), jnp.asarray(d), tn, tf


def _assert_closest_parity(hb, hv):
    np.testing.assert_array_equal(np.asarray(hv.hit), np.asarray(hb.hit))
    m = np.asarray(hb.hit)
    diff = m & (np.asarray(hv.tri) != np.asarray(hb.tri))
    # winners may differ only on exact-t ties
    np.testing.assert_array_equal(np.asarray(hv.t)[diff],
                                  np.asarray(hb.t)[diff])
    same = m & ~diff
    np.testing.assert_array_equal(np.asarray(hv.t)[same],
                                  np.asarray(hb.t)[same])
    assert diff.mean() < 0.01


def test_fcluster_matches_brute_incoherent():
    scene = triangle_soup(10_000)
    rng = np.random.default_rng(31)
    o, d, tn, tf = _rays(rng, 2048, 2.0)
    hb = intersect.intersect_closest(scene, o, d, tn, tf, _BRUTE)
    hv = intersect.intersect_closest(scene, o, d, tn, tf, _FC)
    _assert_closest_parity(hb, hv)
    tfs = jnp.full((o.shape[0],), 1.5, jnp.float32)
    ob = intersect.intersect_any(scene, o, d, tn, tfs, _BRUTE)
    ov = intersect.intersect_any(scene, o, d, tn, tfs, _FC)
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ob))


def test_fcluster_matches_brute_coherent_2d_swizzle():
    """2-D pixel-grid rays exercise the 8x32 tile-swizzle path; results
    must be identical to the unswizzled flat call and to brute."""
    scene = terrain_scene(20_000)
    rng = np.random.default_rng(32)
    h, w = 16, 64
    o = np.tile(np.array([0.0, -6.0, 4.0], np.float32), (h * w, 1))
    at = rng.uniform(-4, 4, (h * w, 3)).astype(np.float32)
    at[:, 2] = 0.3
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o2 = jnp.asarray(o.reshape(h, w, 3))
    d2 = jnp.asarray(d.reshape(h, w, 3))
    tn, tf = jnp.float32(1e-3), jnp.float32(1e4)
    hb = intersect.intersect_closest(scene, o2, d2, tn, tf, _BRUTE)
    hv = intersect.intersect_closest(scene, o2, d2, tn, tf, _FC)
    _assert_closest_parity(hb, hv)
    hflat = intersect.intersect_closest(scene, jnp.asarray(o),
                                        jnp.asarray(d), tn, tf, _FC)
    np.testing.assert_array_equal(np.asarray(hv.tri).reshape(-1),
                                  np.asarray(hflat.tri))
    ob = intersect.intersect_any(scene, o2, d2, tn, tf, _BRUTE)
    ov = intersect.intersect_any(scene, o2, d2, tn, tf, _FC)
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ob))


def test_fcluster_tile_perm_inverse():
    from tpu_restir.render.intersect import _tile_perm, _tile_perm_inv
    h, w = 24, 96
    perm = np.asarray(_tile_perm(h, w))
    inv = np.asarray(_tile_perm_inv(h, w))
    np.testing.assert_array_equal(perm[inv], np.arange(h * w))
    np.testing.assert_array_equal(inv[perm], np.arange(h * w))


def test_fcluster_grads_match_brute():
    scene = triangle_soup(6000)
    rng = np.random.default_rng(33)
    o, d, tn, tf = _rays(rng, 256, 1.5)
    g = jnp.asarray(rng.standard_normal(o.shape[0]), jnp.float32)

    def loss(cfg):
        def f(o_, d_):
            hit = intersect.intersect_closest(scene, o_, d_, tn, tf, cfg)
            return jnp.sum(hit.hit.astype(jnp.float32) * g * hit.t)
        return f

    go_v, gd_v = jax.grad(loss(_FC), argnums=(0, 1))(o, d)
    go_b, gd_b = jax.grad(loss(_BRUTE), argnums=(0, 1))(o, d)
    np.testing.assert_allclose(np.asarray(go_v), np.asarray(go_b),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gd_v), np.asarray(gd_b),
                               rtol=2e-3, atol=2e-3)


def test_backend_errors_without_accel_arrays():
    """Forcing an accel backend on a scene without the
    arrays must raise a clear error, not an AttributeError."""
    import pytest

    from tpu_restir.scene.materials import MaterialSpec, MatType
    from tpu_restir.scene.scene import build_scene

    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32)
    scene = build_scene(tri, np.zeros(2, np.int32),
                        [MaterialSpec("m", MatType.LAMBERT,
                                      diffuse=(0.5, 0.5, 0.5))])
    assert scene.bvh is None and scene.cluster_min is None
    with pytest.raises(ValueError, match="no wide BVH"):
        intersect._backend(scene, IntersectorConfig(backend="bvh"))
    with pytest.raises(ValueError, match="no cluster"):
        intersect._backend(scene, IntersectorConfig(backend="fcluster"))
