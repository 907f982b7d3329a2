"""Ray-scene intersection: the framework's Embree replacement.

The reference delegates closest-hit and occlusion queries to Embree's BVH
(rtcIntersect1/rtcOccluded1, pg/Intersection.h:8-113). Here the same
queries are answered by data-parallel triangle tests:

* `brute` backend: vectorized Möller-Trumbore over triangle blocks with a
  running-min carry — the correctness reference.
* `woop_mxu` backend (tpu_restir.kernels.woop): per-triangle affine
  world->unit-triangle transforms turn the test into two matmuls.
* `fused` backend (tpu_restir.kernels.ray_tri, GPU only): a Pallas-Triton
  kernel that keeps the whole test in registers (small scenes).
* `cluster`, `fcluster` and `bvh` backends (tpu_restir.accel): cluster
  culling and wide-BVH traversal for large scenes.

All entry points accept (..., 3) ray SoA and broadcast scalars; large ray
counts are processed in fixed-size chunks via lax.map to bound memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir import mathx, struct
from tpu_restir.config import IntersectorConfig

_INF = np.float32(np.inf)  # np scalar: no device op at import time
_DET_EPS = 1e-18

# Instrumented query log (speed-of-light accounting, tpu_restir.roofline):
# set to a list before tracing a frame and every closest/any query appends
# its static ray count AT TRACE TIME — the exact per-frame ray totals,
# cross-checking bench.py's analytic rays-per-pixel model. None = off.
QUERY_LOG = None


def _log_query(kind: str, backend: str, shape) -> None:
    if QUERY_LOG is not None:
        QUERY_LOG.append({"kind": kind, "backend": backend,
                          "rays": int(np.prod(shape, dtype=np.int64))})


class Hit(struct.PyTreeNode):
    t: jnp.ndarray     # (...,) distance along the ray
    u: jnp.ndarray     # (...,) barycentric (vertex 1 weight)
    v: jnp.ndarray     # (...,) barycentric (vertex 2 weight)
    tri: jnp.ndarray   # (...,) int32 triangle index (-1 on miss)
    hit: jnp.ndarray   # (...,) bool


class HitInfo(struct.PyTreeNode):
    """Interpolated hit payload (reference pg/HitInfo.h:4-23)."""

    did_hit: jnp.ndarray      # (...,) bool
    point: jnp.ndarray        # (..., 3)
    normal: jnp.ndarray       # (..., 3) shading normal, flipped toward viewer
    uv: jnp.ndarray           # (..., 2)
    tangent: jnp.ndarray      # (..., 3)
    from_inside: jnp.ndarray  # (...,) bool
    dst: jnp.ndarray          # (...,)
    tri: jnp.ndarray          # (...,) int32
    mat_id: jnp.ndarray       # (...,) int32


def _mt_block(o, d, v0, e1, e2):
    """Möller-Trumbore: rays (C,3) x triangles (B,3) -> t,u,v,(det ok) (C,B)."""
    p = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.sum(e1[None, :, :] * p, axis=-1)
    ok_det = jnp.abs(det) > _DET_EPS
    # AD-safe reciprocal: 1/det on degenerate (padding) triangles would
    # backprop 0 * inf = NaN through the where
    inv = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    tv = o[:, None, :] - v0[None, :, :]
    u = jnp.sum(tv * p, axis=-1) * inv
    q = jnp.cross(tv, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * q, axis=-1) * inv
    t = jnp.sum(e2[None, :, :] * q, axis=-1) * inv
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _min_update(carry, t, u, v, ok, base):
    """Fold a (C, B) block of candidate hits into the per-ray running-min
    carry (t, u, v, tri) using pure reductions: min + one-hot masked sums
    fuse with the producer instead of an argmin + per-row gather."""
    bt, bu, bv, btri = carry
    tt = jnp.where(ok, t, _INF)
    tmin = jnp.min(tt, axis=1)
    iota = jax.lax.broadcasted_iota(jnp.int32, tt.shape, 1)
    jwin = jnp.min(jnp.where(tt <= tmin[:, None], iota, jnp.int32(1 << 30)),
                   axis=1)
    onehot = iota == jwin[:, None]
    mu = jnp.sum(jnp.where(onehot, u, 0.0), axis=1)
    mv = jnp.sum(jnp.where(onehot, v, 0.0), axis=1)
    better = tmin < bt
    return (jnp.where(better, tmin, bt), jnp.where(better, mu, bu),
            jnp.where(better, mv, bv),
            jnp.where(better, base + jwin, btri))


def _pad_tris(scene, block: int):
    n = scene.tri_v0.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    big = jnp.float32(1e30)

    def padv(x):
        return jnp.concatenate(
            [x, jnp.full((pad, 3), big, x.dtype)], axis=0) if pad else x

    v0 = padv(scene.tri_v0)
    # zero-extent edges on padding => det == 0 => never hits
    e1 = jnp.concatenate([scene.tri_e1, jnp.zeros((pad, 3), jnp.float32)]) \
        if pad else scene.tri_e1
    e2 = jnp.concatenate([scene.tri_e2, jnp.zeros((pad, 3), jnp.float32)]) \
        if pad else scene.tri_e2
    return v0.reshape(nb, block, 3), e1.reshape(nb, block, 3), \
        e2.reshape(nb, block, 3)


def _closest_chunk(o, d, tnear, tfar, v0b, e1b, e2b):
    """Closest hit for one ray chunk, scanning triangle blocks."""
    c = o.shape[0]
    block = v0b.shape[1]
    init = (jnp.full((c,), _INF), jnp.zeros((c,)), jnp.zeros((c,)),
            jnp.full((c,), -1, jnp.int32))

    def body(carry, blk):
        v0, e1, e2, base = blk
        t, u, v, ok = _mt_block(o, d, v0, e1, e2)
        ok &= (t >= tnear[:, None]) & (t <= tfar[:, None])
        return _min_update(carry, t, u, v, ok, base), None

    nb = v0b.shape[0]
    bases = jnp.arange(nb, dtype=jnp.int32) * block
    (bt, bu, bv, btri), _ = jax.lax.scan(body, init, (v0b, e1b, e2b, bases))
    return bt, bu, bv, btri


def _any_chunk(o, d, tnear, tfar, v0b, e1b, e2b):
    c = o.shape[0]

    def body(carry, blk):
        v0, e1, e2 = blk
        t, _u, _v, ok = _mt_block(o, d, v0, e1, e2)
        ok &= (t >= tnear[:, None]) & (t <= tfar[:, None])
        return carry | jnp.any(ok, axis=1), None

    out, _ = jax.lax.scan(body, jnp.zeros((c,), bool), (v0b, e1b, e2b))
    return out


def _tile_fold(x, h, w, q: int = 1):
    """Row-major flat (q*h*w, ...) -> packet-major 8x32-tile order per
    image, as a reshape+transpose (no gather). q = product of leading
    batch dims (a batched query folds each image independently)."""
    rest = x.shape[1:]
    xr = x.reshape(q, h // _TILE_H, _TILE_H, w // _TILE_W, _TILE_W, *rest)
    xr = jnp.swapaxes(xr, 2, 3)
    return xr.reshape((q * h * w,) + rest)


def _tile_unfold(x, h, w, q: int = 1):
    """Inverse of _tile_fold."""
    rest = x.shape[1:]
    xr = x.reshape(q, h // _TILE_H, w // _TILE_W, _TILE_H, _TILE_W, *rest)
    xr = jnp.swapaxes(xr, 2, 3)
    return xr.reshape((q * h * w,) + rest)


def _run_chunked(fn, o, d, tnear, tfar, chunk, swizzle: bool = False):
    """Flatten rays, pad to a chunk multiple, lax.map the chunk kernel.
    With swizzle=True (packet backends on a 2-D pixel grid), rays are
    permuted to 8x32-tile packet order first and results permuted back."""
    shape = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    r = of.shape[0]
    tn = jnp.broadcast_to(jnp.asarray(tnear, jnp.float32), shape).reshape(-1)
    tf = jnp.broadcast_to(jnp.asarray(tfar, jnp.float32), shape).reshape(-1)
    if swizzle:
        h, w = shape[-2], shape[-1]
        q = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
        of, df, tn, tf = (_tile_fold(x, h, w, q) for x in (of, df, tn, tf))
    if r <= chunk:
        out = fn(of, df, tn, tf)
    else:
        nc = -(-r // chunk)
        pad = nc * chunk - r

        def padr(x, fill=0.0):
            return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                           constant_values=fill)

        xs = (padr(of).reshape(nc, chunk, 3), padr(df).reshape(nc, chunk, 3),
              padr(tn).reshape(nc, chunk), padr(tf, -1.0).reshape(nc, chunk))
        out = jax.lax.map(lambda a: fn(*a), xs)
        out = jax.tree.map(lambda x: x.reshape((nc * chunk,) + x.shape[2:])[:r],
                           out)
    if swizzle:
        h, w = shape[-2], shape[-1]
        q = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
        out = jax.tree.map(lambda x: _tile_unfold(x, h, w, q), out)
    return jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]), out)


# ---------------------------------------------------------------------------
# Woop-transform backend: tpu_restir.kernels.woop — ray x triangle as two
# matmuls at full float32 precision.
# ---------------------------------------------------------------------------

def _pad_woop(scene, block: int):
    from tpu_restir.kernels.woop import build_woop_matrices

    m = scene.woop
    if m is None:
        m = jnp.asarray(build_woop_matrices(np.asarray(scene.tri_v)))
    n = m.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        filler = jnp.zeros((pad, 3, 4), m.dtype)
        # degenerate padding: translation inf -> u/v never valid
        filler = filler.at[:, 0, 3].set(jnp.inf).at[:, 1, 3].set(jnp.inf)
        m = jnp.concatenate([m, filler], axis=0)
    # (nb, 4, 3*block) packed matmul operands
    return m.reshape(nb, block * 3, 4).transpose(0, 2, 1)


def _closest_chunk_woop(o, d, tnear, tfar, wb):
    from tpu_restir.kernels.woop import intersect_block as woop_block

    c = o.shape[0]
    block = wb.shape[2] // 3
    init = (jnp.full((c,), _INF), jnp.zeros((c,)), jnp.zeros((c,)),
            jnp.full((c,), -1, jnp.int32))

    def body(carry, blk):
        w_packed, base = blk
        t, u, v, ok = woop_block(o, d, w_packed, tnear, tfar)
        return _min_update(carry, t, u, v, ok, base), None

    nb = wb.shape[0]
    bases = jnp.arange(nb, dtype=jnp.int32) * block
    (bt, bu, bv, btri), _ = jax.lax.scan(body, init, (wb, bases))
    return bt, bu, bv, btri


def _any_chunk_woop(o, d, tnear, tfar, wb):
    from tpu_restir.kernels.woop import intersect_block as woop_block

    c = o.shape[0]

    def body(carry, w_packed):
        _t, _u, _v, ok = woop_block(o, d, w_packed, tnear, tfar)
        return carry | jnp.any(ok, axis=1), None

    out, _ = jax.lax.scan(body, jnp.zeros((c,), bool), wb)
    return out


# ---------------------------------------------------------------------------
# Wide-BVH backend (tpu_restir.accel.wide): a large-scene path.
# Traversal is a lockstep while_loop; reverse-mode AD cannot flow
# through it, so the queries carry the same detached-winner custom VJP as
# the fused Pallas kernel (analytic d(t,u,v)/d(o,d) of the winning
# triangle's Woop transform; occlusion is data).
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _bvh_closest_core(max_depth, max_leaf, boxes, meta, v0, e1, e2, woop,
                      o, d, tnear, tfar):
    from tpu_restir.accel.wide import BVH8Arrays, bvh8_closest

    bvh = BVH8Arrays(boxes=boxes, meta=meta, max_depth=max_depth,
                     max_leaf=max_leaf)
    return bvh8_closest(bvh, v0, e1, e2, o, d, tnear, tfar)


def _bvh_closest_fwd(max_depth, max_leaf, boxes, meta, v0, e1, e2, woop,
                     o, d, tnear, tfar):
    out = _bvh_closest_core(max_depth, max_leaf, boxes, meta, v0, e1, e2,
                            woop, o, d, tnear, tfar)
    t, _u, _v, tri = out
    return out, (boxes, meta, v0, e1, e2, woop, d, t, tri,
                 tnear.shape, tfar.shape)


def _bvh_closest_bwd(max_depth, max_leaf, res, g):
    """Same derivation as kernels.ray_tri._closest_bwd: with W the
    winner's Woop rows, t = -(w_w.o + c_w)/(w_w.d), u/v affine in (o, d);
    the discrete winner and the geometry are detached."""
    boxes, meta, v0, e1, e2, woop, d, t, tri, tns, tfs = res
    gt, gu, gv, _gtri = g
    rows = woop.reshape(woop.shape[0], 12)[jnp.maximum(tri, 0)]
    wu = rows[:, 0:3]
    wv = rows[:, 4:7]
    ww = rows[:, 8:11]
    lw = jnp.sum(ww * d, axis=-1)
    lu = jnp.sum(wu * d, axis=-1)
    lv = jnp.sum(wv * d, axis=-1)
    inv_lw = jnp.where(jnp.abs(lw) > 1e-18, 1.0 / lw, 0.0)
    live = ((tri >= 0) & jnp.isfinite(t)).astype(jnp.float32)
    tt = jnp.where(jnp.isfinite(t), t, 0.0)
    a = (gu * lu + gv * lv + gt) * inv_lw * live
    go = (gu * live)[:, None] * wu + (gv * live)[:, None] * wv \
        - a[:, None] * ww
    gd = tt[:, None] * go
    return (jnp.zeros_like(boxes), jnp.zeros_like(meta), jnp.zeros_like(v0),
            jnp.zeros_like(e1), jnp.zeros_like(e2), jnp.zeros_like(woop),
            go, gd, jnp.zeros(tns), jnp.zeros(tfs))


_bvh_closest_core.defvjp(_bvh_closest_fwd, _bvh_closest_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _bvh_any_core(max_depth, max_leaf, boxes, meta, v0, e1, e2,
                  o, d, tnear, tfar):
    from tpu_restir.accel.wide import BVH8Arrays, bvh8_any

    bvh = BVH8Arrays(boxes=boxes, meta=meta, max_depth=max_depth,
                     max_leaf=max_leaf)
    return bvh8_any(bvh, v0, e1, e2, o, d, tnear, tfar)


def _bvh_any_fwd(max_depth, max_leaf, boxes, meta, v0, e1, e2,
                 o, d, tnear, tfar):
    out = _bvh_any_core(max_depth, max_leaf, boxes, meta, v0, e1, e2,
                        o, d, tnear, tfar)
    return out, jax.tree.map(jnp.shape, (boxes, meta, v0, e1, e2,
                                         o, d, tnear, tfar))


def _bvh_any_bwd(max_depth, max_leaf, res, _g):
    # boolean visibility is detached (the estimator treats V as data)
    return tuple(jnp.zeros(s) for s in res)


_bvh_any_core.defvjp(_bvh_any_fwd, _bvh_any_bwd)


def _closest_chunk_bvh(o, d, tnear, tfar, scene):
    return _bvh_closest_core(scene.bvh.max_depth, scene.bvh.max_leaf,
                             scene.bvh.boxes, scene.bvh.meta, scene.tri_v0,
                             scene.tri_e1, scene.tri_e2, scene.woop,
                             o, d, tnear, tfar)


# ---------------------------------------------------------------------------
# Packet-cluster backend (tpu_restir.accel.fcluster): the production
# large-scene path — dense interval culling + shortlist-round
# intersection; see that module's docstring. Reverse AD cannot flow
# through the round while_loop, so the queries carry the detached-winner
# custom VJP (analytic d(t,u,v)/d(o,d) of the winning triangle's Woop
# transform; occlusion is data).
# ---------------------------------------------------------------------------

def _detached_woop_bwd(woop_rows, d, t, tri, g):
    """Shared backward: analytic d(t,u,v)/d(o,d) of the detached winning
    triangle's Woop transform (same derivation as kernels.ray_tri
    _closest_bwd). woop_rows: (N, 12). Returns (go, gd)."""
    gt, gu, gv, _gtri = g
    rows = woop_rows[jnp.maximum(tri, 0)]
    wu = rows[:, 0:3]
    wv = rows[:, 4:7]
    ww = rows[:, 8:11]
    lw = jnp.sum(ww * d, axis=-1)
    lu = jnp.sum(wu * d, axis=-1)
    lv = jnp.sum(wv * d, axis=-1)
    inv_lw = jnp.where(jnp.abs(lw) > 1e-18, 1.0 / lw, 0.0)
    live = ((tri >= 0) & jnp.isfinite(t)).astype(jnp.float32)
    tt = jnp.where(jnp.isfinite(t), t, 0.0)
    a = (gu * lu + gv * lv + gt) * inv_lw * live
    go = (gu * live)[:, None] * wu + (gv * live)[:, None] * wv \
        - a[:, None] * ww
    gd = tt[:, None] * go
    return go, gd


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _fc_closest_core(p, k, bin_rays, v0b, e1b, e2b, cmin, cmax, woop, o, d,
                     tnear, tfar):
    from tpu_restir.accel.fcluster import fcluster_closest

    return fcluster_closest(o, d, tnear, tfar, v0b, e1b, e2b, cmin, cmax,
                            p=p, k=k, bin_rays=bin_rays)


def _fc_closest_fwd(p, k, bin_rays, v0b, e1b, e2b, cmin, cmax, woop, o, d,
                    tnear, tfar):
    out = _fc_closest_core(p, k, bin_rays, v0b, e1b, e2b, cmin, cmax, woop,
                           o, d, tnear, tfar)
    t, _u, _v, tri = out
    return out, (v0b.shape, cmin.shape, cmax.shape, woop, d, t, tri,
                 tnear.shape, tfar.shape)


def _fc_closest_bwd(p, k, bin_rays, res, g):
    tbs, cns, cxs, woop, d, t, tri, tns, tfs = res
    go, gd = _detached_woop_bwd(woop.reshape(woop.shape[0], 12), d, t,
                                tri, g)
    return (jnp.zeros(tbs), jnp.zeros(tbs), jnp.zeros(tbs),
            jnp.zeros(cns), jnp.zeros(cxs), jnp.zeros_like(woop),
            go, gd, jnp.zeros(tns), jnp.zeros(tfs))


_fc_closest_core.defvjp(_fc_closest_fwd, _fc_closest_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _fc_any_core(p, k, bin_rays, v0b, e1b, e2b, cmin, cmax, o, d,
                 tnear, tfar):
    from tpu_restir.accel.fcluster import fcluster_any

    return fcluster_any(o, d, tnear, tfar, v0b, e1b, e2b, cmin, cmax,
                        p=p, k=k, bin_rays=bin_rays)


def _fc_any_fwd(p, k, bin_rays, v0b, e1b, e2b, cmin, cmax, o, d,
                tnear, tfar):
    out = _fc_any_core(p, k, bin_rays, v0b, e1b, e2b, cmin, cmax, o, d,
                       tnear, tfar)
    return out, jax.tree.map(jnp.shape, (v0b, e1b, e2b, cmin, cmax,
                                         o, d, tnear, tfar))


def _fc_any_bwd(p, k, bin_rays, res, _g):
    # boolean visibility is detached (the estimator treats V as data)
    return tuple(jnp.zeros(s) for s in res)


_fc_any_core.defvjp(_fc_any_fwd, _fc_any_bwd)


def _closest_chunk_fcluster(o, d, tnear, tfar, scene, p, k, bin_rays):
    v0b, e1b, e2b = _pad_tris(scene, scene.cluster_size)
    return _fc_closest_core(p, k, bin_rays, v0b, e1b, e2b, scene.cluster_min,
                            scene.cluster_max, scene.woop, o, d, tnear, tfar)


def _any_chunk_fcluster(o, d, tnear, tfar, scene, p, k, bin_rays):
    v0b, e1b, e2b = _pad_tris(scene, scene.cluster_size)
    return _fc_any_core(p, k, bin_rays, v0b, e1b, e2b, scene.cluster_min,
                        scene.cluster_max, o, d, tnear, tfar)


def _any_chunk_bvh(o, d, tnear, tfar, scene):
    return _bvh_any_core(scene.bvh.max_depth, scene.bvh.max_leaf,
                         scene.bvh.boxes, scene.bvh.meta, scene.tri_v0,
                         scene.tri_e1, scene.tri_e2, o, d, tnear, tfar)


# ---------------------------------------------------------------------------
# Cluster backend: Morton-cluster AABB culling (tpu_restir.accel.bvh) with
# chunk-lockstep skipping — a ray chunk scans clusters and lax.cond-skips
# any cluster none of its rays touch; visited clusters run the woop
# test. Coherent chunks (primary/shadow rays in image-tile order) visit a
# small fraction of clusters.
# ---------------------------------------------------------------------------

def _aabb_hits(o, d, tnear, tfar, cmin, cmax):
    """Slab test rays (C,3) x boxes (K,3) -> bool (C,K)."""
    # clamp near-zero components to +/-1e-20 so inv stays finite (no 0*inf)
    d_safe = jnp.where(jnp.abs(d) > 1e-20, d,
                       jnp.where(d >= 0.0, 1e-20, -1e-20))
    inv = 1.0 / d_safe
    t1 = (cmin[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t2 = (cmax[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tn = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (tn <= tf) & (tf >= tnear[:, None]) & (tn <= tfar[:, None])


def _closest_chunk_cluster(o, d, tnear, tfar, wb, cmin, cmax):
    from tpu_restir.kernels.woop import intersect_block as woop_block

    c = o.shape[0]
    block = wb.shape[2] // 3
    hits = _aabb_hits(o, d, tnear, tfar, cmin, cmax)   # (c, C)
    any_hit = jnp.any(hits, axis=0)                    # (C,)
    init = (jnp.full((c,), _INF), jnp.zeros((c,)), jnp.zeros((c,)),
            jnp.full((c,), -1, jnp.int32))

    def body(carry, blk):
        w_packed, base, visit = blk

        def do(carry):
            t, u, v, ok = woop_block(o, d, w_packed, tnear, tfar)
            return _min_update(carry, t, u, v, ok, base)

        return jax.lax.cond(visit, do, lambda x: x, carry), None

    nb = wb.shape[0]
    bases = jnp.arange(nb, dtype=jnp.int32) * block
    (bt, bu, bv, btri), _ = jax.lax.scan(body, init, (wb, bases, any_hit))
    return bt, bu, bv, btri


def _any_chunk_cluster(o, d, tnear, tfar, wb, cmin, cmax):
    from tpu_restir.kernels.woop import intersect_block as woop_block

    c = o.shape[0]
    hits = _aabb_hits(o, d, tnear, tfar, cmin, cmax)
    any_hit = jnp.any(hits, axis=0)

    def body(carry, blk):
        w_packed, visit = blk

        def do(carry):
            _t, _u, _v, ok = woop_block(o, d, w_packed, tnear, tfar)
            return carry | jnp.any(ok, axis=1)

        # skip when no ray touches the cluster OR every ray already occluded
        return jax.lax.cond(visit & ~jnp.all(carry), do, lambda x: x,
                            carry), None

    out, _ = jax.lax.scan(body, jnp.zeros((c,), bool), (wb, any_hit))
    return out


_TILE_H, _TILE_W = 8, 32  # 8*32 == fcluster packet (256 rays)


def _tile_perm(h: int, w: int) -> jnp.ndarray:
    """Packet-major -> row-major pixel index: packet j covers an 8x32
    pixel tile, so fcluster packets see compact frusta instead of
    1x256 scanline strips. Pure iota arithmetic — no host constants."""
    j = jnp.arange(h * w)
    tpr = w // _TILE_W
    tile, within = j // (_TILE_H * _TILE_W), j % (_TILE_H * _TILE_W)
    ty, tx = within // _TILE_W, within % _TILE_W
    t_y, t_x = tile // tpr, tile % tpr
    return (t_y * _TILE_H + ty) * w + (t_x * _TILE_W + tx)


def _tile_perm_inv(h: int, w: int) -> jnp.ndarray:
    """Row-major pixel index -> packet-major position (closed form)."""
    src = jnp.arange(h * w)
    y, x = src // w, src % w
    tpr = w // _TILE_W
    tile = (y // _TILE_H) * tpr + x // _TILE_W
    return tile * (_TILE_H * _TILE_W) + (y % _TILE_H) * _TILE_W \
        + (x % _TILE_W)


def _swizzle_applicable(backend: str, shape) -> bool:
    # 2-D pixel grids and batched (Q, ..., H, W) query stacks both fold
    # per-image into 8x32-tile packets
    return (backend == "fcluster" and len(shape) >= 2
            and shape[-2] % _TILE_H == 0 and shape[-1] % _TILE_W == 0)


def _backend(scene, cfg: IntersectorConfig) -> str:
    if cfg.backend != "auto":
        if cfg.backend == "bvh" and scene.bvh is None:
            raise ValueError(
                "backend='bvh' requested but the scene has no wide BVH "
                f"(num_tris={scene.num_tris} <= cluster threshold; "
                "build_scene only builds one for larger scenes)")
        if cfg.backend in ("fcluster", "cluster") \
                and scene.cluster_min is None:
            raise ValueError(
                f"backend={cfg.backend!r} requested but the scene has no "
                "cluster arrays (scene too small; use 'fused'/'woop_mxu')")
        return cfg.backend
    from tpu_restir.kernels import ray_tri
    if ray_tri.supports(scene, cfg.fused_max_tris):
        # fused Pallas-Triton kernel (GPU only): the whole test stays in
        # registers; on an H100 it beat every culling backend on the
        # 1,034-triangle many-light scene (PERF.md)
        return "fused"
    if scene.cluster_min is not None:
        # clustered scenes: packet-culled clusters had the fastest
        # 100k-triangle frame on an H100, ahead of the wide-BVH walk
        # (PERF.md). Chosen on frame time; its longer compile is set-up,
        # kept by the persistent compilation cache.
        return "fcluster"
    return "woop_mxu" if scene.woop is not None else "brute"


def intersect_closest(scene, o, d, tnear, tfar,
                      cfg: IntersectorConfig = IntersectorConfig()) -> Hit:
    """Closest-hit query (reference Intersection::getClosestIntersection)."""
    backend = _backend(scene, cfg)
    _log_query("closest", backend, o.shape[:-1])
    if backend == "fused":
        from tpu_restir.kernels import ray_tri
        shape = o.shape[:-1]
        tn = jnp.broadcast_to(jnp.asarray(tnear, jnp.float32),
                              shape).reshape(-1)
        tf = jnp.broadcast_to(jnp.asarray(tfar, jnp.float32),
                              shape).reshape(-1)
        bt, bu, bv, btri = ray_tri.closest_hit(
            scene, o.reshape(-1, 3), d.reshape(-1, 3), tn, tf)
        hit = (btri >= 0).reshape(shape)
        return Hit(t=jnp.where(hit, bt.reshape(shape), 0.0),
                   u=bu.reshape(shape), v=bv.reshape(shape),
                   tri=btri.reshape(shape), hit=hit)
    if backend == "bvh":
        fn = partial(_closest_chunk_bvh, scene=scene)
    elif backend == "fcluster":
        fn = partial(_closest_chunk_fcluster, scene=scene,
                     p=cfg.packet_size, k=cfg.shortlist_k,
                     bin_rays=cfg.bin_rays)
    elif backend == "cluster":
        wb = _pad_woop(scene, scene.cluster_size)
        fn = partial(_closest_chunk_cluster, wb=wb, cmin=scene.cluster_min,
                     cmax=scene.cluster_max)
    elif backend == "woop_mxu":
        wb = _pad_woop(scene, min(cfg.tri_block, scene.num_tris))
        fn = partial(_closest_chunk_woop, wb=wb)
    else:
        v0b, e1b, e2b = _pad_tris(scene, min(cfg.tri_block, scene.num_tris))
        fn = partial(_closest_chunk, v0b=v0b, e1b=e1b, e2b=e2b)
    bt, bu, bv, btri = _run_chunked(
        fn, o, d, tnear, tfar, cfg.ray_chunk,
        swizzle=_swizzle_applicable(backend, o.shape[:-1]))
    hit = btri >= 0
    return Hit(t=jnp.where(hit, bt, 0.0), u=bu, v=bv, tri=btri, hit=hit)


def intersect_any(scene, o, d, tnear, tfar,
                  cfg: IntersectorConfig = IntersectorConfig()) -> jnp.ndarray:
    """Any-hit (shadow) query (reference rtcOccluded1 path)."""
    backend = _backend(scene, cfg)
    _log_query("any", backend, o.shape[:-1])
    if backend == "fused":
        from tpu_restir.kernels import ray_tri
        shape = o.shape[:-1]
        tn = jnp.broadcast_to(jnp.asarray(tnear, jnp.float32),
                              shape).reshape(-1)
        tf = jnp.broadcast_to(jnp.asarray(tfar, jnp.float32),
                              shape).reshape(-1)
        return ray_tri.any_hit(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                               tn, tf).reshape(shape)
    if backend == "bvh":
        fn = partial(_any_chunk_bvh, scene=scene)
    elif backend == "fcluster":
        fn = partial(_any_chunk_fcluster, scene=scene,
                     p=cfg.packet_size, k=cfg.shortlist_k,
                     bin_rays=cfg.bin_rays)
    elif backend == "cluster":
        wb = _pad_woop(scene, scene.cluster_size)
        fn = partial(_any_chunk_cluster, wb=wb, cmin=scene.cluster_min,
                     cmax=scene.cluster_max)
    elif backend == "woop_mxu":
        wb = _pad_woop(scene, min(cfg.tri_block, scene.num_tris))
        fn = partial(_any_chunk_woop, wb=wb)
    else:
        v0b, e1b, e2b = _pad_tris(scene, min(cfg.tri_block, scene.num_tris))
        fn = partial(_any_chunk, v0b=v0b, e1b=e1b, e2b=e2b)
    return _run_chunked(fn, o, d, tnear, tfar, cfg.ray_chunk,
                        swizzle=_swizzle_applicable(backend, o.shape[:-1]))


def test_occlusion(scene, from_p, to_p, params,
                   cfg: IntersectorConfig = IntersectorConfig()) -> jnp.ndarray:
    """Shadow test between two points, with the reference's epsilon policy:
    tnear = tnear_offset, tfar = dist - tfar_offset
    (Intersection::testOcclusion, pg/Intersection.h:42-60).
    Returns True where occluded."""
    seg = to_p - from_p
    dist = mathx.length(seg)
    direction = mathx.normalize(seg)
    return intersect_any(scene, from_p, direction,
                         jnp.full(dist.shape, params.tnear_offset),
                         dist - params.tfar_offset, cfg)


def hit_attributes(scene, o, d, hit: Hit) -> HitInfo:
    """Interpolate vertex attributes at hits and build the HitInfo payload
    (reference Intersection::getGeometryAttributes + intersectEmbree,
    pg/Intersection.h:8-113): barycentric interpolation, normal
    normalization, and backface flip with from_inside tagging."""
    tri = jnp.maximum(hit.tri, 0)
    w = jnp.stack([1.0 - hit.u - hit.v, hit.u, hit.v], axis=-1)  # (..., 3)
    nt = scene.num_tris
    # one row-select for all per-triangle attributes (25 channels);
    # mat ids are small ints, exact as f32
    attr = jnp.concatenate([
        scene.vtx_normal.reshape(nt, 9), scene.vtx_uv.reshape(nt, 6),
        scene.vtx_tangent.reshape(nt, 9),
        scene.tri_mat.astype(jnp.float32)[:, None]], axis=1)
    rows = mathx.take_rows(attr, tri)
    n = jnp.sum(rows[..., 0:9].reshape(w.shape[:-1] + (3, 3))
                * w[..., None], axis=-2)
    n = mathx.normalize(n)
    facing = mathx.dot(-d, n)
    from_inside = (facing <= 0.0) & hit.hit
    n = jnp.where(from_inside[..., None], -n, n)
    uv = jnp.sum(rows[..., 9:15].reshape(w.shape[:-1] + (3, 2))
                 * w[..., None], axis=-2)
    tangent = jnp.sum(rows[..., 15:24].reshape(w.shape[:-1] + (3, 3))
                      * w[..., None], axis=-2)
    point = o + d * hit.t[..., None]
    mat_id = jnp.where(hit.hit, rows[..., 24].astype(jnp.int32), 0)
    return HitInfo(did_hit=hit.hit, point=point, normal=n, uv=uv,
                   tangent=tangent, from_inside=from_inside, dst=hit.t,
                   tri=hit.tri, mat_id=mat_id)
