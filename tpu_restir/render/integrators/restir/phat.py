"""Target-function evaluation: f and p_hat.

Reference: ReSTIRIntegrator::evaluateF / evaluatePHat
(pg/ReSTIRIntegrator.cpp:180-211). f = L_i * f_r * G * V for a light
sample against a G-buffer surface; p_hat = |f|. Every call is an
image-shaped batch; when test_visibility is set the V term is one batched
occlusion query.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from tpu_restir import mathx
from tpu_restir.render import brdf, intersect
from tpu_restir.render.integrators.restir.gbuffer import GBuffer
from tpu_restir.render.integrators.restir.reservoir import LightSample

# p_hat is evaluated O(M) times per frame; storing each call's shading
# intermediates for the backward pass is pure device-memory traffic. Remat policy:
# save ONLY the occlusion booleans (1 byte/pixel; their kernel must not
# rerun in the backward — visibility is detached anyway) and recompute
# the cheap vector math from the already-live gb/sample inputs.
_SAVE_OCCLUSION = jax.checkpoint_policies.save_only_these_names("occlusion")


def evaluate_f(sample: LightSample, scene, gb: GBuffer, test_visibility,
               params, intersector) -> jnp.ndarray:
    """f(sample; surface) with optional visibility (pg/ReSTIRIntegrator.cpp:185-211).

    Invalid samples and emissive surfaces evaluate to 0 (lights are
    displayed directly, :188)."""
    ok = sample.valid & ~gb.is_emissive()
    seg = sample.point - gb.pos
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_i = jnp.maximum(mathx.dot(wi, gb.normal), 0.0)
    cos_y = jnp.abs(mathx.dot(-wi, sample.normal))
    g = jnp.where(r_sqr > 0.0, cos_i * cos_y / jnp.maximum(r_sqr, 1e-20), 0.0)
    f_r = brdf.gbuf_eval_brdf(gb, wi)
    f = sample.l_i * f_r * g[..., None]
    if test_visibility:
        # pixels whose f is already 0 (invalid sample / emissive surface)
        # get a degenerate zero-length segment: test_occlusion turns it
        # into a dead ray (tfar < tnear) that the intersection backends
        # skip, instead of a full shadow trace whose result is discarded
        to_p = jnp.where(ok[..., None], sample.point, gb.pos)
        occ = checkpoint_name(
            intersect.test_occlusion(scene, gb.pos, to_p, params,
                                     intersector), "occlusion")
        ok = ok & ~occ
    return jnp.where(ok[..., None], f, 0.0)


def evaluate_p_hat(sample: LightSample, scene, gb: GBuffer, test_visibility,
                   params, intersector) -> jnp.ndarray:
    """p_hat = |f| (pg/ReSTIRIntegrator.cpp:180-183), rematerialized in
    the backward pass under the save-occlusion policy above."""
    fn = jax.checkpoint(
        partial(evaluate_f, test_visibility=test_visibility, params=params,
                intersector=intersector),
        policy=_SAVE_OCCLUSION)
    return mathx.length(fn(sample, scene, gb))
