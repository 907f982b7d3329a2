"""A/B oracles for the initial-pass fast paths.

1. `_closest_emissive_visible` vs the reference's plain
   closest-hit-must-be-emissive rule (brdfSampleLight,
   pg/ReSTIRIntegrator.cpp:126-177) on a scene with occluders near the
   light: the two must agree for every ray EXCEPT those whose blocker
   sits within tfar_offset of the light — the fast path reuses the
   reference's own shadow-segment epsilon (Intersection::testOcclusion,
   pg/Intersection.h:42-60), so a blocker inside that epsilon is
   (documentedly) not counted.
2. The `lights.count > _EMISSIVE_SUBSET_MAX` fallback branch (incoherent
   re-binned closest-hit) produces the same initial reservoirs as the
   subset path on a scene with no epsilon-zone blockers.
"""

import jax.numpy as jnp
import numpy as np

from tpu_restir import rng
from tpu_restir.config import (CameraConfig, RenderConfig, RenderParams,
                               RestirParams)
from tpu_restir.render import intersect
from tpu_restir.render.integrators.restir import initial as init_mod
from tpu_restir.scene.materials import MaterialSpec, MatType
from tpu_restir.scene.scene import build_scene


def _quad(p0, p1, p2, p3):
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [np.stack([p0, p1, p2]), np.stack([p0, p2, p3])]


def _blocker_scene(eps_blocker_z):
    """Floor at z=0, emissive light at z=2; blocker A at z=1 covering
    x<0, blocker B at z=eps_blocker_z covering x>0.5."""
    tris, mats = [], []

    def add(ts, m):
        tris.extend(ts)
        mats.extend([m] * len(ts))

    add(_quad((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0)), 0)
    add(_quad((-2, -2, 2), (2, -2, 2), (2, 2, 2), (-2, 2, 2)), 1)  # light
    add(_quad((-2, -2, 1), (0, -2, 1), (0, 2, 1), (-2, 2, 1)), 0)  # A
    add(_quad((0.5, -2, eps_blocker_z), (2, -2, eps_blocker_z),
              (2, 2, eps_blocker_z), (0.5, 2, eps_blocker_z)), 0)  # B
    specs = [
        MaterialSpec("grey", MatType.LAMBERT, diffuse=(0.6, 0.6, 0.6)),
        MaterialSpec("light", MatType.LAMBERT, diffuse=(0.7, 0.7, 0.7),
                     emission=(10.0, 10.0, 10.0)),
    ]
    return build_scene(np.stack(tris), np.asarray(mats), specs)


def test_emissive_visible_matches_plain_closest_except_epsilon_zone():
    cfg = RenderConfig()
    p = cfg.params
    eps_z = 2.0 - 0.5 * p.tfar_offset       # blocker INSIDE the epsilon
    scene = _blocker_scene(eps_z)

    # vertical rays from the floor toward the light, covering all zones
    n = 512
    rngn = np.random.default_rng(3)
    xy = rngn.uniform(-1.9, 1.9, (n, 2)).astype(np.float32)
    o = jnp.asarray(np.concatenate([xy, np.full((n, 1), 0.01, np.float32)],
                                   axis=1))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))

    fast = init_mod._closest_emissive_visible(scene, o, d,
                                              p.tnear_offset, cfg)

    # reference semantics: plain closest hit, accept iff emissive
    href = intersect.intersect_closest(scene, o, d, p.tnear_offset,
                                       jnp.inf, cfg.intersector)
    emis = np.asarray(scene.tri_emissive_mask())
    ref_ok = np.asarray(href.hit) & emis[np.maximum(np.asarray(href.tri), 0)]

    x = np.asarray(o)[:, 0]
    zone_a = x < 0              # blocked at z=1: both reject
    zone_b = x > 0.5            # blocked inside epsilon: semantics differ
    zone_open = ~zone_a & ~zone_b

    fok = np.asarray(fast.hit)
    np.testing.assert_array_equal(fok[zone_open], ref_ok[zone_open])
    assert ref_ok[zone_open].all()
    np.testing.assert_array_equal(fok[zone_a], ref_ok[zone_a])
    assert not ref_ok[zone_a].any()
    # the documented epsilon delta: reference rejects (closest hit is the
    # epsilon blocker), the fast path accepts the light
    assert not ref_ok[zone_b].any()
    assert fok[zone_b].all()
    # outside the epsilon the fast path must NOT accept through blockers
    scene2 = _blocker_scene(2.0 - 10.0 * p.tfar_offset)
    fast2 = init_mod._closest_emissive_visible(scene2, o, d,
                                               p.tnear_offset, cfg)
    assert not np.asarray(fast2.hit)[zone_b].any()


def test_brdf_fallback_branch_matches_subset_path(monkeypatch):
    """Force `lights.count > _EMISSIVE_SUBSET_MAX` so the re-binned
    incoherent closest-hit branch runs; initial reservoirs must match the
    subset path (no epsilon-zone blockers in this scene)."""
    from tpu_restir.render import camera as cam_mod
    from tpu_restir.render.integrators.restir import gbuffer as gb_mod
    from tpu_restir.scene.procedural import terrain_scene

    scene = terrain_scene(5_000)
    size = 32
    ccfg = CameraConfig(width=size, height=size, fov_y_deg=45.0,
                        view_from=(0.0, -7.0, 4.0), view_at=(0.0, 0.0, 0.5),
                        pixel_sampler="random")
    cfg = RenderConfig(camera=ccfg, params=RenderParams(use_skybox=False),
                       restir=RestirParams(m_area=1, m_brdf=2),
                       integrator="restir")
    cam = cam_mod.make_camera(ccfg)
    ys = jnp.broadcast_to(jnp.arange(size)[:, None], (size, size))
    xs = jnp.broadcast_to(jnp.arange(size)[None, :], (size, size))
    fseed = rng.make_frame_seed(0, 0)
    gb = gb_mod.gbuffer_fill(scene, cam, cfg, fseed, ys, xs)

    res_subset = init_mod.initial_pass(fseed, scene, gb, cfg, ys, xs)
    monkeypatch.setattr(init_mod, "_EMISSIVE_SUBSET_MAX", 0)
    res_fallback = init_mod.initial_pass(fseed, scene, gb, cfg, ys, xs)

    for name in ("w_sum", "w", "confidence"):
        np.testing.assert_allclose(
            np.asarray(getattr(res_fallback, name)),
            np.asarray(getattr(res_subset, name)), rtol=1e-5, atol=1e-6,
            err_msg=name)
    np.testing.assert_allclose(np.asarray(res_fallback.sample.point),
                               np.asarray(res_subset.sample.point),
                               rtol=1e-5, atol=1e-5)
