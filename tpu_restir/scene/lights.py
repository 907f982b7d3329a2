"""Emissive-triangle light sampling: area-weighted CDF.

Array-program equivalent of the reference's TriangleCDF
(pg/TriangleCDF.cpp:8-57): the CDF is a device array searched with
vectorized jnp.searchsorted instead of std::lower_bound per sample, so a
whole frame's light picks happen in one gather. The key identity is kept:
pdf of a sampled light point in area measure is
(area_i/total) * (1/area_i) = 1/total_area (pg/TriangleCDF.cpp:46-50).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir import mathx, struct
from tpu_restir.render import sampling


class EmissiveCDF(struct.PyTreeNode):
    tri_idx: jnp.ndarray     # (L,) int32 — scene triangle indices
    cdf: jnp.ndarray         # (L,) float32 — normalized cumulative areas
    areas: jnp.ndarray       # (L,) float32
    total_area: jnp.ndarray  # () float32

    @property
    def count(self) -> int:
        return self.tri_idx.shape[0]

    @property
    def is_valid(self) -> bool:
        """Static validity — gates all NEE (reference TriangleCDF::isValid)."""
        return self.count > 0


def build_emissive_cdf(tri_areas: np.ndarray, emissive_mask: np.ndarray) -> EmissiveCDF:
    idx = np.nonzero(emissive_mask)[0].astype(np.int32)
    areas = tri_areas[idx].astype(np.float32)
    total = float(areas.sum())
    if len(idx) and total > 0:
        cdf = np.cumsum(areas / total).astype(np.float32)
        cdf[-1] = 1.0
    else:
        cdf = np.zeros((len(idx),), np.float32)
    return EmissiveCDF(
        tri_idx=jnp.asarray(idx), cdf=jnp.asarray(cdf),
        areas=jnp.asarray(areas), total_area=jnp.asarray(total, jnp.float32))


def pick_triangle_from_uniform(u, lights: EmissiveCDF):
    """Sample light-triangle indices ~ area (reference TriangleCDF::getTriangle).

    Returns (scene_tri_idx, prob) with prob = area_i / total_area.
    """
    # std::lower_bound(first ge u) == searchsorted side='left'
    k = pick_light_index(u, lights)
    packed = jnp.stack([lights.areas,
                        lights.tri_idx.astype(jnp.float32)], axis=1)
    r = mathx.take_rows(packed, k)
    prob = r[..., 0] / lights.total_area
    return r[..., 1].astype(jnp.int32), prob


def pick_light_index(u, lights: EmissiveCDF):
    """CDF pick -> index into the light list (not the scene tri list).

    method='compare_all' turns the per-ray binary search into one dense
    (rays, lights) compare-sum that fuses with its consumer; the
    O(rays*lights) form is gated to modest light counts. The gate at
    8192 lights is a starting point, not measured on the GPU."""
    method = "compare_all" if lights.count <= 8192 else "scan"
    k = jnp.searchsorted(lights.cdf, u, side="left", method=method)
    return jnp.clip(k, 0, lights.count - 1)


def pick_triangle(key: jax.Array, lights: EmissiveCDF, shape):
    return pick_triangle_from_uniform(jax.random.uniform(key, shape), lights)


def light_point_from_uniforms(u3, scene):
    """Pick an emissive triangle + a uniform point on it from (..., 3)
    uniforms [cdf pick, r1, r2].

    Returns dict with point, normal (interpolated, normalized), L_i
    (material emission), pdf_area (== 1/total_area), and the scene
    triangle index. Mirrors areaSampleLight's light-side math
    (pg/ReSTIRIntegrator.cpp:89-122).
    """
    shape = u3.shape[:-1]
    lights = scene.lights
    k = pick_light_index(u3[..., 0], lights)
    w = sampling.triangle_barycentrics_from_uniforms(u3[..., 1:3])  # (..., 3)
    # packed per-LIGHT table (L is tiny): verts 0:9, vertex normals 9:18,
    # emission 18:21, scene tri index 21 — one row-select per frame
    li = lights.tri_idx
    nl = li.shape[0]
    packed = jnp.concatenate([
        scene.tri_v[li].reshape(nl, 9),
        scene.vtx_normal[li].reshape(nl, 9),
        scene.materials.emission[scene.tri_mat[li]],
        li.astype(jnp.float32)[:, None]], axis=1)           # (L, 22)
    r = mathx.take_rows(packed, k)
    point = jnp.sum(r[..., 0:9].reshape(shape + (3, 3))
                    * w[..., :, None], axis=-2)
    normal = mathx.normalize(jnp.sum(r[..., 9:18].reshape(shape + (3, 3))
                                     * w[..., :, None], axis=-2))
    l_i = r[..., 18:21]
    tri = r[..., 21].astype(jnp.int32)
    pdf_area = jnp.broadcast_to(1.0 / lights.total_area, shape)
    return dict(point=point, normal=normal, l_i=l_i, pdf_area=pdf_area,
                tri=tri)


def sample_light_point(key: jax.Array, scene, shape):
    """Key-based wrapper around light_point_from_uniforms."""
    return light_point_from_uniforms(jax.random.uniform(key, shape + (3,)),
                                     scene)


def pdf_for_any_light_point(scene, shape):
    """Area pdf of sampling *any* point on the emissive set: 1/total_area
    (reference TriangleCDF::getPDFForTriangle, pg/TriangleCDF.cpp:46-50)."""
    return jnp.broadcast_to(1.0 / scene.lights.total_area, shape)
