"""Packed reuse payload: one flat row-gather for neighbor/reprojection taps.

The reference reads neighbor G-buffer elements and reservoirs through
per-field random access (GBuffer::getAt, pg/GBufferElement.h:44-57;
reservoir indexing in spatialReusePass, pg/ReSTIRIntegrator.cpp:334-478).
A literal translation issues one XLA gather per field per tap. Instead,
concatenate every per-pixel reuse field into a single channel-packed f32
image once per pass, then serve ALL taps with one flat row gather: a
32-channel row is 128 contiguous bytes per tap, a coalesced read.

Channel layout (full, 32 = GB_CH + RES_CH):
  G-buffer (19): pos 0:3, normal 3:6, diffuse 6:9, specular 9:12,
                 emission 12:15, shininess 15, depth 16, inv_i_m 17,
                 mat_type (bitcast f32) 18
  Reservoir (13): sample.point 19:22, sample.normal 22:25,
                  sample.l_i 25:28, sample.valid 28, w_sum 29, w 30,
                  confidence 31

SLIM layout (24 = 12 + 12), selected statically when the material table
contains no specular-lobed type (reuse_slim): the tap consumers
(evaluate_p_hat at a neighbor/reprojected surface, neighbor rejection,
WRS resampling) read emission only as an is-emissive flag, never read a
neighbor's w_sum, and — with every material Lambert/Normal — never read
specular/shininess/inv_i_m. The gather and its scatter-add transpose
move bytes per channel, so 8 fewer channels move 25% fewer bytes.
  G-buffer (12): pos 0:3, normal 3:6, diffuse 6:9, emissive flag 9,
                 depth 10, mat_type 11
  Reservoir (12): point 0:3, normal 3:6, l_i 6:9, valid 9, w 10,
                  confidence 11 (w_sum omitted — tap-unused)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_restir.render.integrators.restir.gbuffer import GBuffer
from tpu_restir.render.integrators.restir.reservoir import (LightSample,
                                                            Reservoir)
from tpu_restir.scene.materials import MatType

GB_CH = 19
RES_CH = 13
GB_CH_SLIM = 12
RES_CH_SLIM = 12

# Types whose BRDF eval reads specular/shininess/inv_i_m at a surface.
_SPEC_TYPES = frozenset({MatType.PHONG, MatType.MIRROR, MatType.DIELECTRIC,
                         MatType.TRANSPARENT, MatType.UNSUPPORTED,
                         MatType.TS})


def reuse_slim(materials) -> bool:
    """Static: may the reuse payload drop the specular channel group?
    True when the table's types are known and none is specular-lobed."""
    tp = getattr(materials, "types_present", ())
    return bool(tp) and not (set(tp) & _SPEC_TYPES)


def gb_ch(slim: bool) -> int:
    return GB_CH_SLIM if slim else GB_CH


def pack_gb(gb: GBuffer, slim: bool = False) -> jnp.ndarray:
    """(h, w) GBuffer -> (h, w, 19|12) f32 payload."""
    if slim:
        flag = jnp.any(gb.emission > 0.0, axis=-1).astype(jnp.float32)
        return jnp.concatenate([
            gb.pos, gb.normal, gb.diffuse, flag[..., None],
            gb.depth[..., None],
            gb.mat_type.astype(jnp.float32)[..., None]], axis=-1)
    mt = jax.lax.bitcast_convert_type(gb.mat_type, jnp.float32)
    return jnp.concatenate([
        gb.pos, gb.normal, gb.diffuse, gb.specular, gb.emission,
        gb.shininess[..., None], gb.depth[..., None],
        gb.inv_i_m[..., None], mt[..., None]], axis=-1)


def unpack_gb(a: jnp.ndarray, cam_of: GBuffer,
              slim: bool = False) -> GBuffer:
    """(..., 19|12) payload -> GBuffer view (camera snapshot from cam_of).

    Slim taps reconstruct the dropped fields with values that are dead
    under the Lambert-only guarantee (specular=0, shininess=0,
    inv_i_m=1) and the emissive flag in emission channel 0 (is_emissive
    stays correct; emission VALUES are never read from taps)."""
    if slim:
        z3 = jnp.zeros(a.shape[:-1] + (3,), a.dtype)
        z1 = jnp.zeros(a.shape[:-1], a.dtype)
        return GBuffer(
            pos=a[..., 0:3], normal=a[..., 3:6], diffuse=a[..., 6:9],
            specular=z3,
            emission=jnp.concatenate([a[..., 9:10], z3[..., :2]], axis=-1),
            shininess=z1, depth=a[..., 10], inv_i_m=jnp.ones_like(z1),
            mat_type=a[..., 11].astype(jnp.int32),
            cam_pos=cam_of.cam_pos, view_mat=cam_of.view_mat,
            focal=cam_of.focal)
    return GBuffer(
        pos=a[..., 0:3], normal=a[..., 3:6], diffuse=a[..., 6:9],
        specular=a[..., 9:12], emission=a[..., 12:15],
        shininess=a[..., 15], depth=a[..., 16], inv_i_m=a[..., 17],
        mat_type=jax.lax.bitcast_convert_type(a[..., 18], jnp.int32),
        cam_pos=cam_of.cam_pos, view_mat=cam_of.view_mat,
        focal=cam_of.focal)


def pack_res(res: Reservoir, slim: bool = False) -> jnp.ndarray:
    """(h, w) Reservoir -> (h, w, 13|12) f32 payload."""
    s = res.sample
    cols = [s.point, s.normal, s.l_i,
            s.valid.astype(jnp.float32)[..., None]]
    if not slim:
        cols.append(res.w_sum[..., None])
    cols += [res.w[..., None], res.confidence[..., None]]
    return jnp.concatenate(cols, axis=-1)


def unpack_res(a: jnp.ndarray, slim: bool = False) -> Reservoir:
    """(..., 13|12) payload -> Reservoir view (slim taps read w_sum as 0
    — no consumer reads a tap's w_sum)."""
    sample = LightSample(point=a[..., 0:3], normal=a[..., 3:6],
                         l_i=a[..., 6:9], valid=a[..., 9] > 0.5)
    if slim:
        return Reservoir(sample=sample, w_sum=jnp.zeros_like(a[..., 10]),
                         w=a[..., 10], confidence=a[..., 11])
    return Reservoir(sample=sample, w_sum=a[..., 10], w=a[..., 11],
                     confidence=a[..., 12])


def pack_reuse(gb: GBuffer, res: Reservoir, slim: bool = False) -> jnp.ndarray:
    """Combined (h, w, 32|24) payload for spatial-reuse taps."""
    return jnp.concatenate([pack_gb(gb, slim), pack_res(res, slim)],
                           axis=-1)


def gather_packed(packed: jnp.ndarray, ys: jnp.ndarray,
                  xs: jnp.ndarray) -> jnp.ndarray:
    """Tap packed (h, w, C) at integer coords of any shape -> shape + (C,).

    Lowered as a single flat row gather (fast path) instead of a 2-D
    coordinate gather per field (slow path)."""
    h, w, c = packed.shape
    flat = packed.reshape(h * w, c)
    idx = (ys * w + xs).reshape(-1)
    return flat[idx].reshape(ys.shape + (c,))
