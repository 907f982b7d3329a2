"""Screen-space G-buffer: SoA arrays + fill pass.

Reference: GBuffer/GBufferElement (pg/GBufferElement.h:6-140) and
gBufferFillPass (pg/ReSTIRIntegrator.cpp:213-234). One pytree holds the
per-pixel surface attributes plus the camera snapshot (pos, view matrix,
focal length) used by reprojection — state the reference keeps in statics
on SimpleGuiDX11 and that here threads explicitly between frames.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_restir import mathx, struct
from tpu_restir.render import camera as cam_mod, intersect
from tpu_restir.scene.envmap import sky_radiance
from tpu_restir.scene.materials import (MatType,  # noqa: F401
                                        apply_normal_map, apply_textures,
                                        gather_materials)


class GBuffer(struct.PyTreeNode):
    pos: jnp.ndarray        # (..., 3) world-space position
    normal: jnp.ndarray     # (..., 3)
    diffuse: jnp.ndarray    # (..., 3)
    specular: jnp.ndarray   # (..., 3)
    emission: jnp.ndarray   # (..., 3) (sky/bg radiance on miss)
    shininess: jnp.ndarray  # (...,)
    depth: jnp.ndarray      # (...,)
    mat_type: jnp.ndarray   # (...,) int32
    # cached 1/I_M (Mallett-Yuksel Phong normalization) for the camera
    # view direction: it depends only on (N.V, shininess), both frozen at
    # G-buffer fill, so the iterative incomplete-beta evaluation runs once
    # per frame instead of once per p_hat evaluation.
    inv_i_m: jnp.ndarray    # (...,)
    # camera snapshot
    cam_pos: jnp.ndarray    # (3,)
    view_mat: jnp.ndarray   # (4, 4)
    focal: jnp.ndarray      # ()

    def is_emissive(self) -> jnp.ndarray:
        """Pixels displayed directly (lights & environment):
        emission > 0 on any channel (pg/GBufferElement.h:20-22)."""
        return jnp.any(self.emission > 0.0, axis=-1)


def gather(gb: GBuffer, ys: jnp.ndarray, xs: jnp.ndarray) -> GBuffer:
    """Gather per-pixel fields at integer coords, keeping the camera
    snapshot — the getAt() used for neighbor/reprojected taps."""
    pixel_fields = dict(
        pos=gb.pos[ys, xs], normal=gb.normal[ys, xs],
        diffuse=gb.diffuse[ys, xs], specular=gb.specular[ys, xs],
        emission=gb.emission[ys, xs], shininess=gb.shininess[ys, xs],
        depth=gb.depth[ys, xs], mat_type=gb.mat_type[ys, xs],
        inv_i_m=gb.inv_i_m[ys, xs])
    return GBuffer(cam_pos=gb.cam_pos, view_mat=gb.view_mat, focal=gb.focal,
                   **pixel_fields)


def empty_gbuffer(h: int, w: int) -> GBuffer:
    return GBuffer(
        pos=jnp.zeros((h, w, 3)), normal=jnp.zeros((h, w, 3)),
        diffuse=jnp.zeros((h, w, 3)), specular=jnp.zeros((h, w, 3)),
        emission=jnp.zeros((h, w, 3)), shininess=jnp.zeros((h, w)),
        depth=jnp.zeros((h, w)), mat_type=jnp.zeros((h, w), jnp.int32),
        inv_i_m=jnp.ones((h, w)),
        cam_pos=jnp.zeros((3,)), view_mat=jnp.eye(4), focal=jnp.zeros(()))


def gbuffer_fill(scene, cam, cfg, frame_seed, ys, xs) -> GBuffer:
    """PASS 1: primary visibility -> surface attributes
    (pg/ReSTIRIntegrator.cpp:213-234). Misses store the sky/bg radiance in
    the emission channel so they are displayed directly and excluded from
    resampling. ys/xs are GLOBAL pixel coords (a shard's row slice when
    sharded)."""
    p = cfg.params
    o, d = cam_mod.generate_rays_at(cam, cfg.camera, frame_seed, ys, xs)
    hit = intersect.intersect_closest(scene, o, d, p.tnear_offset, jnp.inf,
                                      cfg.intersector)
    hi = intersect.hit_attributes(scene, o, d, hit)
    m = gather_materials(scene.materials, hi.mat_id)
    m = apply_textures(scene, m, hi.uv)
    hi = hi.replace(normal=apply_normal_map(scene, m, hi.normal,
                                            hi.tangent, hi.uv))
    sky = sky_radiance(scene, p, d)

    from tpu_restir import mathx
    from tpu_restir.mathx.special import calc_i_m

    n_dot_v = mathx.dot(mathx.normalize(cam.pos - hi.point), hi.normal)
    inv_i_m = 1.0 / calc_i_m(n_dot_v, m.shininess)

    h3 = hi.did_hit[..., None]
    return GBuffer(
        pos=jnp.where(h3, hi.point, 0.0),
        normal=jnp.where(h3, hi.normal, 0.0),
        diffuse=jnp.where(h3, m.diffuse, 0.0),
        specular=jnp.where(h3, m.specular, 0.0),
        emission=jnp.where(h3, m.emission, sky),
        shininess=jnp.where(hi.did_hit, m.shininess, 0.0),
        depth=jnp.where(hi.did_hit, hi.dst, 0.0),
        # TS reports LAMBERT to the screen-space layer, like the
        # reference's MaterialTS::getType() (the G-buffer dispatch never
        # sees its specular lobe — faithful quirk)
        mat_type=jnp.where(
            hi.did_hit,
            jnp.where(m.mat_type == MatType.TS, MatType.LAMBERT,
                      m.mat_type), 0),
        inv_i_m=jnp.where(hi.did_hit, inv_i_m, 1.0),
        cam_pos=cam.pos, view_mat=cam.view_mat, focal=cam.focal)
