"""Tightened statistical oracles.

The reference's evaluation currency is 4-digit image-mean agreement
between unbiased variants (BASELINE.md: MIS 1.22169 vs ReSTIR 1.2221)
and a recorded *darkening* bias for the plain CONSTANT spatial scheme
(the `darkening_*` screenshot series). Because all schemes share the
same PCG4D candidate streams (common random numbers), scheme-vs-scheme
means converge far faster than scheme-vs-reference: at 64x64 x 48 frames
the unbiased schemes agree within ~0.15%, so a 1e-2 oracle has ~6x
headroom while catching any new bias in the MIS denominators.

Also here: the temporal weight-explosion regression (BASELINE.md flags
`temporal2_32a_1b_5000it` — mean 35.2, variance 1.7e8 — as a recorded
failure mode): a long temporal-reuse run with the confidence cap must
keep mean and variance bounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_restir import rng
from tpu_restir.config import (CameraConfig, DirectStrategy, RenderConfig,
                               RenderParams, RestirParams, SpatialMis)
from tpu_restir.render import camera as cam_mod
from tpu_restir.render.integrators import render_nee
from tpu_restir.render.integrators.restir.pipeline import (
    render_restir_frames)
from tpu_restir.scene import cornell_box

SIZE = 64
N_FRAMES = 48


@pytest.fixture(scope="module")
def setup():
    scene = cornell_box()
    ccfg = CameraConfig(width=SIZE, height=SIZE, fov_y_deg=45.0,
                        view_from=(0, -3.9, 1.0), view_at=(0, 0, 1.0),
                        pixel_sampler="random")
    cfg = RenderConfig(camera=ccfg, params=RenderParams(use_skybox=False),
                       integrator="restir")
    cam = cam_mod.make_camera(ccfg)
    return scene, cfg, cam


def _mean(img):
    return float(jnp.mean(jnp.mean(img, axis=-1)))


@pytest.fixture(scope="module")
def scheme_means(setup):
    scene, cfg, cam = setup
    means = {}
    for mis in SpatialMis.ALL:
        rp = RestirParams(m_area=2, m_brdf=1, do_temporal_reuse=True,
                          do_spatial_reuse=True, spatial_neighbor_count=5,
                          spatial_mis=mis)
        means[mis] = _mean(render_restir_frames(
            scene, cam, cfg.replace(restir=rp), 0, N_FRAMES))
    return means


def test_unbiased_schemes_agree_tightly(scheme_means):
    """All unbiased spatial MIS schemes within 1e-2 relative of pairwise
    (observed agreement ~1.5e-3)."""
    ref = scheme_means[SpatialMis.PAIRWISE]
    for mis in (SpatialMis.CONSTANT_DEBIAS_Z,
                SpatialMis.CONSTANT_DEBIAS_CONTRIB,
                SpatialMis.BALANCE_HEURISTIC):
        assert np.isclose(scheme_means[mis], ref, rtol=1e-2), \
            (mis, scheme_means[mis], ref)


def test_constant_scheme_darkens(scheme_means):
    """The plain 1/M CONSTANT scheme is biased DARK (the reference's
    `darkening_*` series) — the bias must exist, be negative, and stay in
    the recorded ~1-4% band."""
    ref = scheme_means[SpatialMis.PAIRWISE]
    bias = (scheme_means[SpatialMis.CONSTANT] - ref) / ref
    assert -0.05 < bias < -0.005, bias


def test_restir_mean_matches_mis_reference(setup, scheme_means):
    """ReSTIR pairwise mean vs the NEE/MIS DI reference estimator at 2%
    (independent estimators — no CRN cancellation)."""
    scene, cfg, cam = setup
    cfg_mis = cfg.replace(integrator="nee", direct_strategy=DirectStrategy.MIS,
                          nee_calc_gi=False)
    acc = jnp.zeros((SIZE, SIZE, 3))
    for f in range(N_FRAMES):
        frame = render_nee(scene, cam, cfg_mis, rng.frame_key(0, f))
        acc = acc + (frame - acc) / (f + 1.0)
    ref = _mean(acc)
    assert np.isclose(scheme_means[SpatialMis.PAIRWISE], ref, rtol=0.02), \
        (scheme_means[SpatialMis.PAIRWISE], ref)


def test_temporal_no_weight_explosion(setup):
    """220 frames of temporal reuse with the confidence cap: the running
    mean must stay near the reference and the per-frame variance bounded
    (the BASELINE `temporal2_32a_1b_5000it` blow-up had mean 35.2 and
    variance 1.7e8)."""
    scene, cfg, _ = setup
    ccfg = CameraConfig(width=32, height=32, fov_y_deg=45.0,
                        view_from=(0, -3.9, 1.0), view_at=(0, 0, 1.0),
                        pixel_sampler="random")
    cfg = cfg.replace(camera=ccfg,
                      restir=RestirParams(m_area=2, m_brdf=1,
                                          do_temporal_reuse=True,
                                          confidence_cap=20.0))
    cam = cam_mod.make_camera(ccfg)
    img = render_restir_frames(scene, cam, cfg, 0, 220)
    pix = np.asarray(jnp.mean(img, axis=-1))
    mean = pix.mean()
    var = (pix * pix).mean() - mean * mean
    assert 0.1 < mean < 0.5, mean            # sane scene brightness
    assert var < 10.0, var                   # no 1.7e8-style explosion
    assert np.isfinite(pix).all()
