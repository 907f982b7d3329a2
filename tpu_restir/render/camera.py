"""Pinhole camera: ray generation + reprojection matrices.

Faithful to the reference camera model (pg/camera.cpp:12-84): z-up
look-at frame, vertical-FOV focal length f_y = h / (2 tan(fov/2)),
camera-space direction (x - w/2, h/2 - y, -f_y) rotated to world by the
inverse view rotation. Rays for the whole image are generated in one
shaped op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir import mathx, rng, struct
from tpu_restir.config import CameraConfig
from tpu_restir.render import sampling


class Camera(struct.PyTreeNode):
    pos: jnp.ndarray          # (3,)
    view_at: jnp.ndarray      # (3,)
    view_mat: jnp.ndarray     # (4, 4) world -> camera (glm::lookAt)
    inv_view_dir: jnp.ndarray  # (3, 3) camera -> world rotation
    focal: jnp.ndarray        # () f_y in pixels


def look_at(eye, at, up):
    """glm::lookAt — rows of R are (s, u, -f); t = (-s.e, -u.e, f.e).

    Host-side numpy (eager jnp ops pay per-op XLA compiles)."""
    eye = np.asarray(eye, np.float32)
    at = np.asarray(at, np.float32)
    up = np.asarray(up, np.float32)

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-20)

    f = nrm(at - eye)
    s = nrm(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[0, 3] = s, -np.dot(s, eye)
    m[1, :3], m[1, 3] = u, -np.dot(u, eye)
    m[2, :3], m[2, 3] = -f, np.dot(f, eye)
    return m


def make_camera(cfg: CameraConfig, view_from=None, view_at=None) -> Camera:
    """Build the camera pytree. The orthonormal up (y_c) is recomputed from
    the fixed world up exactly like Camera::recalculate_m_c_w
    (pg/camera.cpp:44-58)."""
    eye = np.asarray(view_from if view_from is not None else cfg.view_from,
                     np.float32)
    at = np.asarray(view_at if view_at is not None else cfg.view_at,
                    np.float32)
    up = np.asarray(cfg.up, np.float32)

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-20)

    z_c = nrm(eye - at)
    x_c = nrm(np.cross(up, z_c))
    y_c = nrm(np.cross(z_c, x_c))
    vm = look_at(eye, at, y_c)
    inv_dir = vm[:3, :3].T  # inverse of the rotation part
    focal = cfg.height / (2.0 * np.tan(np.radians(cfg.fov_y_deg) / 2.0))
    return Camera(pos=jnp.asarray(eye), view_at=jnp.asarray(at),
                  view_mat=jnp.asarray(vm),
                  inv_view_dir=jnp.asarray(np.ascontiguousarray(inv_dir)),
                  focal=jnp.asarray(focal, jnp.float32))


def generate_rays_at(cam: Camera, cfg: CameraConfig, frame_seed, ys, xs):
    """Primary rays for the GLOBAL integer pixel grid (ys, xs): origins and
    unit dirs shaped like ys + (3,).

    Pixel (x, y) + AA offset maps to camera-space direction
    (x+sx - w/2, h/2 - (y+sy), -f_y) (pg/camera.cpp:20-42). The CENTER
    sampler offset is (0,0) — the reference aims through pixel corners.
    AA jitter is a PCG4D draw keyed by the global coords, so a row-sharded
    render produces identical rays to the single-chip render.
    """
    h, w = cfg.height, cfg.width
    u4 = rng.pixel_uniforms(frame_seed,
                            rng.stream_id(rng.PASS_PIXEL_JITTER), ys, xs, 4)
    jitter = sampling.pixel_offsets_u(u4, cfg.pixel_sampler, cfg.jitter_grid)
    dx = xs.astype(jnp.float32) + jitter[..., 0] - w / 2.0
    dy = h / 2.0 - (ys.astype(jnp.float32) + jitter[..., 1])
    d_c = jnp.stack([dx, dy, -jnp.broadcast_to(cam.focal, dx.shape)], axis=-1)
    d_w = mathx.normalize(jnp.einsum("ij,...j->...i", cam.inv_view_dir, d_c,
                                     precision=jax.lax.Precision.HIGHEST))
    o = jnp.broadcast_to(cam.pos, d_w.shape)
    return o, d_w


def generate_rays(cam: Camera, cfg: CameraConfig, key: jax.Array):
    """Whole-image rays (key-based path used by naive/NEE integrators)."""
    h, w = cfg.height, cfg.width
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    seed = jax.random.randint(rng.pass_key(key, rng.PASS_PIXEL_JITTER),
                              (), 0, jnp.iinfo(jnp.int32).max,
                              dtype=jnp.int32).astype(jnp.uint32)
    return generate_rays_at(cam, cfg, seed, ys, xs)


def project_to_screen(cam_view_mat, focal, width, height, ws_pos):
    """World position -> integer pixel coords + validity, per the
    reference reprojection (pg/ReSTIRIntegrator.cpp:544-565).

    Returns (x, y, valid); invalid when behind the camera or off screen.
    """
    p = ws_pos
    vx = (cam_view_mat[0, :3] * p).sum(-1) + cam_view_mat[0, 3]
    vy = (cam_view_mat[1, :3] * p).sum(-1) + cam_view_mat[1, 3]
    vz = (cam_view_mat[2, :3] * p).sum(-1) + cam_view_mat[2, 3]
    in_front = vz < 0.0
    vz_safe = jnp.where(in_front, vz, -1.0)
    sx = jnp.round((-vx / vz_safe) * focal + width / 2.0).astype(jnp.int32)
    sy = jnp.round((vy / vz_safe) * focal + height / 2.0).astype(jnp.int32)
    on_screen = (sx >= 0) & (sx <= width - 1) & (sy >= 0) & (sy <= height - 1)
    valid = in_front & on_screen
    return sx, sy, valid
