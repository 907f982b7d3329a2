"""Weighted reservoir sampling state as SoA arrays.

The reference's per-pixel Reservoir/LightSample structs
(pg/Reservoir.h:6-59) become image-shaped arrays; addSample's sequential
branch becomes a masked select, so the WRS update is branch-free and
vectorizes over every pixel at once. Validity is an explicit bool instead
of the reference's -FLT_MAX sentinels (equivalent: LightSample::isValid).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_restir import struct


class LightSample(struct.PyTreeNode):
    point: jnp.ndarray    # (..., 3)
    normal: jnp.ndarray   # (..., 3)
    l_i: jnp.ndarray      # (..., 3)
    valid: jnp.ndarray    # (...,) bool — point/normal set AND any(l_i > 0)


class Reservoir(struct.PyTreeNode):
    sample: LightSample
    w_sum: jnp.ndarray       # (...,)
    w: jnp.ndarray           # (...,) unbiased contribution weight W
    confidence: jnp.ndarray  # (...,) float (int in the reference)

    def has_sample(self) -> jnp.ndarray:
        """w_sum > 0 (reference Reservoir::hasSample)."""
        return self.w_sum > 0.0


def empty_light_sample(shape) -> LightSample:
    return LightSample(
        point=jnp.zeros(shape + (3,)), normal=jnp.zeros(shape + (3,)),
        l_i=jnp.zeros(shape + (3,)), valid=jnp.zeros(shape, bool))


def empty_reservoir(shape) -> Reservoir:
    return Reservoir(sample=empty_light_sample(shape),
                     w_sum=jnp.zeros(shape), w=jnp.zeros(shape),
                     confidence=jnp.zeros(shape))


def add_sample_u(res: Reservoir, u: jnp.ndarray, cand: LightSample,
                 w: jnp.ndarray, conf_inc: jnp.ndarray):
    """Streaming WRS update (reference Reservoir::addSample,
    pg/Reservoir.h:33-47): accumulate w_sum/confidence, replace the kept
    sample w.p. w / w_sum'. u is the acceptance uniform per pixel.
    Returns (reservoir, accepted_mask)."""
    w_sum = res.w_sum + w
    conf = res.confidence + conf_inc
    accept = (w_sum > 0.0) & (u < w / jnp.maximum(w_sum, 1e-30))
    a3 = accept[..., None]
    sample = LightSample(
        point=jnp.where(a3, cand.point, res.sample.point),
        normal=jnp.where(a3, cand.normal, res.sample.normal),
        l_i=jnp.where(a3, cand.l_i, res.sample.l_i),
        valid=jnp.where(accept, cand.valid, res.sample.valid))
    return Reservoir(sample=sample, w_sum=w_sum, w=res.w, confidence=conf), \
        accept


def add_sample(res: Reservoir, key: jax.Array, cand: LightSample,
               w: jnp.ndarray, conf_inc: jnp.ndarray):
    """Key-based wrapper around add_sample_u."""
    return add_sample_u(res, jax.random.uniform(key, w.shape), cand, w,
                        conf_inc)


def cap_confidence(res: Reservoir, cap: float) -> Reservoir:
    """reference Reservoir::capConfidence."""
    return res.replace(confidence=jnp.minimum(res.confidence, cap))


def select(mask: jnp.ndarray, a: Reservoir, b: Reservoir) -> Reservoir:
    """Per-pixel reservoir select: mask ? a : b."""
    m1 = mask
    m3 = mask[..., None]
    return Reservoir(
        sample=LightSample(
            point=jnp.where(m3, a.sample.point, b.sample.point),
            normal=jnp.where(m3, a.sample.normal, b.sample.normal),
            l_i=jnp.where(m3, a.sample.l_i, b.sample.l_i),
            valid=jnp.where(m1, a.sample.valid, b.sample.valid)),
        w_sum=jnp.where(m1, a.w_sum, b.w_sum),
        w=jnp.where(m1, a.w, b.w),
        confidence=jnp.where(m1, a.confidence, b.confidence))


def gather(res: Reservoir, ys: jnp.ndarray, xs: jnp.ndarray) -> Reservoir:
    """Gather reservoirs at integer pixel coords (for spatial/temporal
    reuse neighbor taps)."""
    return jax.tree.map(lambda x: x[ys, xs], res)
