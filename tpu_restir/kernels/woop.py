"""Matmul ray-triangle intersection via per-triangle affine (Woop) transforms.

Reformulation of the intersection test: instead of
per-(ray, triangle) cross products, precompute for every
triangle the affine map W that sends it to the unit triangle
{(0,0,0),(1,0,0),(0,1,0)} with the third coordinate along the (unscaled)
normal. Then for rays (o, d):

    o' = W [o; 1],  d' = W [d; 0]
    t  = -o'_w / d'_w,   u = o'_u + t d'_u,   v = o'_v + t d'_v
    hit <=> u >= 0, v >= 0, u + v <= 1, tnear <= t <= tfar

The 6 dot products per pair become two (R,4) x (4,3N) matmuls at
Precision.HIGHEST, which keeps full float32 (no TF32 on the GPU). XLA
writes their (R, 3N) outputs to device memory before the elementwise
epilogue. The `woop_mxu` backend scans all triangles this way; the
`cluster` backend intersects the clusters it does not cull the same way.
The Woop rows are also the per-triangle table of the fused kernel
(kernels/ray_tri.py) and of the detached-winner VJPs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_INF = np.float32(np.inf)  # np scalar: no device op at import time


def build_woop_matrices(tri_v: np.ndarray) -> np.ndarray:
    """Host-side: per-triangle 3x4 world->unit-triangle affine maps.

    Returns (N, 3, 4) float32. Rows are the (u, v, w) coefficient rows;
    column 3 is the translation. Degenerate triangles get a map that can
    never produce a valid (u, v, t) triple.
    """
    v = np.asarray(tri_v, np.float64)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    a = np.stack([e1, e2, n], axis=-1)          # (N, 3, 3) columns e1,e2,n
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-18
    a_safe = np.where(ok[:, None, None], a, np.eye(3)[None])
    inv = np.linalg.inv(a_safe)                  # (N, 3, 3)
    trans = -np.einsum("nij,nj->ni", inv, v[:, 0])
    m = np.concatenate([inv, trans[:, :, None]], axis=-1)  # (N, 3, 4)
    # degenerate: send everything to u=v=+inf so the hit test fails
    m[~ok] = 0.0
    m[~ok, 0, 3] = np.inf
    m[~ok, 1, 3] = np.inf
    return m.astype(np.float32)


def _pack(m: jnp.ndarray) -> jnp.ndarray:
    """(N, 3, 4) -> (4, 3N) matmul operand (u,v,w rows interleaved per tri)."""
    n = m.shape[0]
    return m.reshape(n * 3, 4).T


def intersect_block(o, d, w_packed, tnear, tfar):
    """Rays (C,3) x packed triangles (4, 3B) -> t, u, v, ok of shape (C,B).

    Two matmuls + elementwise epilogue.
    """
    c = o.shape[0]
    b = w_packed.shape[1] // 3
    oh = jnp.concatenate([o, jnp.ones((c, 1), o.dtype)], axis=1)
    dh = jnp.concatenate([d, jnp.zeros((c, 1), d.dtype)], axis=1)
    op = jnp.dot(oh, w_packed, precision=jax.lax.Precision.HIGHEST)
    dp = jnp.dot(dh, w_packed, precision=jax.lax.Precision.HIGHEST)
    op = op.reshape(c, b, 3)
    dp = dp.reshape(c, b, 3)
    dw = dp[..., 2]
    ok_dw = jnp.abs(dw) > 1e-18
    # AD-safe division (0 * inf = NaN through the where otherwise)
    t = jnp.where(ok_dw, -op[..., 2] / jnp.where(ok_dw, dw, 1.0), _INF)
    u = op[..., 0] + t * dp[..., 0]
    v = op[..., 1] + t * dp[..., 1]
    # small barycentric slack for watertightness: rays exactly on shared
    # edges (e.g. pixel-corner rays through quad diagonals) must not slip
    # between both triangles after f32 rounding; duplicates resolve by
    # closest-t.
    eps = 1e-5
    ok = (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps) \
        & jnp.isfinite(t) & (t >= tnear[:, None]) & (t <= tfar[:, None])
    return t, u, v, ok
