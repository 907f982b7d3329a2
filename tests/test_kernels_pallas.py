"""Interpret-mode parity tests for the Pallas-Triton ray_tri kernels,
and tests of the plain XLA gather that replaced the windowed-gather
kernel.

The fused kernels (kernels/ray_tri.py) compile only for a GPU; these
tests run the SAME kernels through the Pallas interpreter
(pl.pallas_call interpret=True) and check them against the XLA paths:

  * ray_tri closest/any vs the brute Moller-Trumbore backend, on several
    scenes, ray counts that are not a multiple of the block, dead rays
    and degenerate triangles
  * ray_tri closest VJP vs autodiff of the brute backend
  * the kernels' lowering to Triton IR for a CUDA device (no GPU needed)
  * packed.gather_packed and its scatter-add VJP
  * the backend choice per platform
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_restir.config import IntersectorConfig
from tpu_restir.kernels import ray_tri
from tpu_restir.render import intersect
from tpu_restir.render.integrators.restir import packed as pk
from tpu_restir.scene import cornell_box, many_lights_scene
from tpu_restir.scene.procedural import terrain_scene, triangle_soup

_BRUTE = IntersectorConfig(backend="brute")


@pytest.fixture(autouse=True)
def _interpret_kernels():
    ray_tri.INTERPRET = True
    yield
    ray_tri.INTERPRET = False


def _random_rays(rng, scene_extent, n):
    o = rng.uniform(-scene_extent, scene_extent, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_closest_matches_brute(scene, o, d, tn, tf):
    t_k, u_k, v_k, tri_k = ray_tri.closest_hit(scene, o, d, tn, tf)
    brute = intersect.intersect_closest(scene, o, d, tn, tf, _BRUTE)

    hit_k = np.asarray(tri_k >= 0)
    np.testing.assert_array_equal(hit_k, np.asarray(brute.hit))
    m = hit_k
    np.testing.assert_allclose(np.asarray(t_k)[m], np.asarray(brute.t)[m],
                               rtol=1e-4, atol=1e-5)
    # winning triangle: identical except where two triangles tie on t
    # (coplanar quads — e.g. the light panel in the ceiling plane — where
    # the Woop and Moller-Trumbore formulations round ties differently)
    diff = m & (np.asarray(tri_k) != np.asarray(brute.tri))
    assert np.all(np.abs(np.asarray(t_k)[diff] - np.asarray(brute.t)[diff])
                  <= 1e-3 * np.abs(np.asarray(brute.t)[diff]) + 1e-5)
    same = m & ~diff
    np.testing.assert_allclose(np.asarray(u_k)[same],
                               np.asarray(brute.u)[same],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(v_k)[same],
                               np.asarray(brute.v)[same],
                               rtol=1e-3, atol=1e-4)
    return hit_k


def test_ray_tri_closest_matches_brute():
    scene = cornell_box()
    rng = np.random.default_rng(11)
    n = 256
    o, d = _random_rays(rng, 2.0, n)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    _assert_closest_matches_brute(scene, o, d, tn, tf)


def test_ray_tri_any_matches_brute():
    scene = cornell_box()
    rng = np.random.default_rng(12)
    n = 256
    o, d = _random_rays(rng, 2.0, n)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 3.0, jnp.float32)

    occ_k = ray_tri.any_hit(scene, o, d, tn, tf)
    occ_b = intersect.intersect_any(scene, o, d, tn, tf, _BRUTE)
    np.testing.assert_array_equal(np.asarray(occ_k), np.asarray(occ_b))


def test_ray_tri_closest_vjp_matches_brute_autodiff():
    """The analytic closest-hit VJP (d(t,u,v)/d(o,d) of the winning Woop
    transform) must agree with autodiff through the brute backend."""
    scene = cornell_box()
    rng = np.random.default_rng(13)
    n = 64
    o, d = _random_rays(rng, 1.5, n)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    gt = jnp.asarray(rng.standard_normal(n), jnp.float32)
    gu = jnp.asarray(rng.standard_normal(n), jnp.float32)
    gv = jnp.asarray(rng.standard_normal(n), jnp.float32)

    def loss_kernel(o_, d_):
        t, u, v, tri = ray_tri.closest_hit(scene, o_, d_, tn, tf)
        m = (tri >= 0).astype(jnp.float32)
        t = jnp.where(tri >= 0, t, 0.0)
        return jnp.sum(m * (gt * t + gu * u + gv * v))

    def loss_brute(o_, d_):
        hit = intersect.intersect_closest(scene, o_, d_, tn, tf, _BRUTE)
        m = hit.hit.astype(jnp.float32)
        return jnp.sum(m * (gt * hit.t + gu * hit.u + gv * hit.v))

    go_k, gd_k = jax.grad(loss_kernel, argnums=(0, 1))(o, d)
    go_b, gd_b = jax.grad(loss_brute, argnums=(0, 1))(o, d)
    np.testing.assert_allclose(np.asarray(go_k), np.asarray(go_b),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(gd_k), np.asarray(gd_b),
                               rtol=2e-3, atol=2e-3)


def _emissive_subset(scene):
    idx = scene.lights.tri_idx
    return scene.replace(tri_v=scene.tri_v[idx], tri_v0=scene.tri_v0[idx],
                         tri_e1=scene.tri_e1[idx], tri_e2=scene.tri_e2[idx],
                         woop=scene.woop[idx])


@pytest.mark.parametrize("which", ["cornell", "soup512", "lights_subset"])
def test_ray_tri_scenes_match_brute(which):
    """Closest and any hit against brute on the kernel's scene sizes:
    the flagship scene, a 512-triangle soup (the auto gate), and the
    emissive subset of the many-lights scene (initial.py's BRDF
    candidates, ~100 triangles here)."""
    if which == "cornell":
        scene, extent = cornell_box(), 2.0
    elif which == "soup512":
        scene, extent = triangle_soup(512), 2.0
    else:
        scene, extent = _emissive_subset(many_lights_scene(100)), 1.0
    rng = np.random.default_rng(31)
    n = 200
    o, d = _random_rays(rng, extent, n)
    if which == "lights_subset":
        # aim at the ceiling grid from below
        o = o.at[:, 2].set(1.0)
        d = d.at[:, 2].set(jnp.abs(d[:, 2]) + 0.5)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    hit = _assert_closest_matches_brute(scene, o, d, tn,
                                        jnp.full((n,), jnp.inf, jnp.float32))
    assert hit.any()
    tf = jnp.full((n,), 1.5, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(ray_tri.any_hit(scene, o, d, tn, tf)),
        np.asarray(intersect.intersect_any(scene, o, d, tn, tf, _BRUTE)))


@pytest.mark.parametrize("n", [1, ray_tri.BLOCK + 1, 3 * ray_tri.BLOCK - 5])
def test_ray_tri_ray_count_not_block_multiple(n):
    """Masked loads/stores: any ray count, no padding by the caller."""
    scene = cornell_box()
    o, d = _random_rays(np.random.default_rng(n), 2.0, n)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    t, _u, _v, tri = ray_tri.closest_hit(scene, o, d, tn,
                                         jnp.full((n,), 1e4, jnp.float32))
    assert t.shape == tri.shape == (n,)
    _assert_closest_matches_brute(scene, o, d, tn,
                                  jnp.full((n,), 1e4, jnp.float32))
    occ = ray_tri.any_hit(scene, o, d, tn, jnp.full((n,), 2.0, jnp.float32))
    assert occ.shape == (n,) and occ.dtype == jnp.bool_


def test_ray_tri_dead_rays():
    """tnear > tfar: never a hit, never occluded; live rays unaffected."""
    scene = cornell_box()
    n = 150
    o, d = _random_rays(np.random.default_rng(5), 1.0, n)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    dead = jnp.arange(n) % 3 == 0
    tf = jnp.where(dead, -1.0, 1e4).astype(jnp.float32)
    _t, _u, _v, tri = ray_tri.closest_hit(scene, o, d, tn, tf)
    occ = ray_tri.any_hit(scene, o, d, tn, tf)
    assert not np.any(np.asarray(tri)[np.asarray(dead)] >= 0)
    assert not np.any(np.asarray(occ)[np.asarray(dead)])
    np.testing.assert_array_equal(
        np.asarray(occ),
        np.asarray(intersect.intersect_any(scene, o, d, tn, tf, _BRUTE)))
    hit = _assert_closest_matches_brute(scene, o, d, tn, tf)
    assert hit[~np.asarray(dead)].any()


def test_ray_tri_degenerate_triangles():
    """Zero-area triangles (build_woop_matrices' never-hit rows) are
    skipped; the real triangles still hit."""
    from tpu_restir.kernels.woop import build_woop_matrices

    scene = cornell_box()
    v = np.asarray(scene.tri_v).copy()
    v[::4] = v[::4, :1]            # collapse every 4th triangle to a point
    deg = scene.replace(tri_v=jnp.asarray(v),
                        tri_v0=jnp.asarray(v[:, 0]),
                        tri_e1=jnp.asarray(v[:, 1] - v[:, 0]),
                        tri_e2=jnp.asarray(v[:, 2] - v[:, 0]),
                        woop=jnp.asarray(build_woop_matrices(v)))
    n = 256
    o, d = _random_rays(np.random.default_rng(6), 1.0, n)
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    hit = _assert_closest_matches_brute(deg, o, d, tn, tf)
    _t, _u, _v, tri = ray_tri.closest_hit(deg, o, d, tn, tf)
    assert hit.any() and not np.any(np.asarray(tri)[hit] % 4 == 0)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_ray_tri_lowers_to_triton_for_cuda(kind):
    """The kernels lower to Triton IR for a CUDA device (the step that
    refuses unsupported primitives), without a GPU."""
    scene = cornell_box()
    n = 1000
    o, d = _random_rays(np.random.default_rng(7), 1.0, n)
    tn = jnp.zeros((n,), jnp.float32)
    tf = jnp.full((n,), 1e4, jnp.float32)
    impl = (ray_tri._closest_core_impl if kind == "closest"
            else ray_tri._any_core_impl)
    ray_tri.INTERPRET = False
    text = jax.jit(impl).trace(ray_tri._woop_rows(scene), o, d, tn, tf) \
        .lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"ray_tri_{kind}" in text


def test_gather_packed_identity_taps():
    rng = np.random.default_rng(8)
    h, w, c = 8, 24, 3
    payload = jnp.asarray(rng.standard_normal((h, w, c)), jnp.float32)
    ys = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[None, :, None],
                          (1, h, w))
    xs = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, None, :],
                          (1, h, w))
    got = pk.gather_packed(payload, ys, xs)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(payload))


def test_gather_packed_halo_extended_payload():
    """Taps into a halo-extended strip (the sharded spatial pass) read
    payload[tys, txs] in payload coordinates."""
    rng = np.random.default_rng(10)
    h, w, c, k, r, halo = 16, 40, 5, 4, 4, 6
    eh = h + 2 * halo
    payload = rng.standard_normal((eh, w, c)).astype(np.float32)
    ys = np.arange(h)[None, :, None] + halo \
        + rng.integers(-r, r + 1, (k, h, w))
    xs = np.arange(w)[None, None, :] + rng.integers(-r, r + 1, (k, h, w))
    tys = np.clip(ys, 0, eh - 1)
    txs = np.clip(xs, 0, w - 1)
    got = pk.gather_packed(jnp.asarray(payload), jnp.asarray(tys, jnp.int32),
                           jnp.asarray(txs, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got), payload[tys, txs])


def test_gather_packed_vjp_matches_scatter_add():
    """The gather's autodiff transpose == a direct .at[].add scatter, with
    colliding taps (disk-sampled offsets clamped at the border)."""
    rng = np.random.default_rng(19)
    h, w, c, k, rad2 = 16, 32, 6, 5, 30.0
    payload = jnp.asarray(rng.standard_normal((h, w, c)), jnp.float32)
    ang = rng.uniform(0, 2 * np.pi, (k, h, w))
    rad = np.sqrt(rng.uniform(0, rad2, (k, h, w)))
    dy = np.trunc(rad * np.sin(ang)).astype(np.int64)
    dx = np.trunc(rad * np.cos(ang)).astype(np.int64)
    tys = jnp.asarray(np.clip(np.arange(h)[None, :, None] + dy, 0, h - 1),
                      jnp.int32)
    txs = jnp.asarray(np.clip(np.arange(w)[None, None, :] + dx, 0, w - 1),
                      jnp.int32)
    cot = jnp.asarray(rng.standard_normal((k, h, w, c)), jnp.float32)

    g = jax.grad(lambda p: jnp.sum(pk.gather_packed(p, tys, txs) * cot))(
        payload)
    idx = (tys * w + txs).reshape(-1)
    want = jnp.zeros((h * w, c)).at[idx].add(cot.reshape(-1, c))
    np.testing.assert_allclose(np.asarray(g), np.asarray(want).reshape(
        h, w, c), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_backend_choice_per_platform(platform, monkeypatch):
    """auto picks the Triton kernel for scenes up to fused_max_tris only
    on a GPU; on the CPU it is a plain XLA backend, never an interpreted
    kernel; larger clustered scenes take the same XLA backend on every
    platform."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = IntersectorConfig()
    small = intersect._backend(cornell_box(), cfg)
    assert small == ("fused" if platform == "gpu" else "woop_mxu")
    lights = intersect._backend(many_lights_scene(1000), cfg)
    assert lights == ("fused" if platform == "gpu" else "fcluster")
    terrain = intersect._backend(terrain_scene(20_000), cfg)
    assert terrain == "fcluster"
    assert {small, lights, terrain} <= {"fused", "woop_mxu", "brute",
                                        "cluster", "fcluster", "bvh"}
