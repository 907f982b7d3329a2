"""BVH2 stack traversal as vmapped lax.while_loop.

The classic per-ray BVH walk (the reference's Embree rtcIntersect1
equivalent; structure mirrors the reference's dead hand-rolled BVH,
pg/BVH.cpp:20-217) expressed as a fixed-stack while_loop and vmapped over
ray batches. This is the asymptotically-right backend for very large
scenes; the benchmark scenes take the backends render.intersect picks. Used as a correctness oracle and the large-scene
fallback.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir import struct
from tpu_restir.accel.bvh import BVH2, build_bvh2

_INF = np.float32(np.inf)  # np scalar: no device op at import time


class BVHArrays(struct.PyTreeNode):
    node_min: jnp.ndarray
    node_max: jnp.ndarray
    left: jnp.ndarray
    right: jnp.ndarray
    start: jnp.ndarray
    count: jnp.ndarray
    order: jnp.ndarray
    max_depth: int = struct.field(pytree_node=False, default=64)
    leaf_size: int = struct.field(pytree_node=False, default=4)


def bvh_to_device(bvh: BVH2, leaf_size: int = 4) -> BVHArrays:
    return BVHArrays(
        node_min=jnp.asarray(bvh.node_min), node_max=jnp.asarray(bvh.node_max),
        left=jnp.asarray(bvh.left), right=jnp.asarray(bvh.right),
        start=jnp.asarray(bvh.start), count=jnp.asarray(bvh.count),
        order=jnp.asarray(bvh.order), max_depth=int(bvh.max_depth),
        leaf_size=leaf_size)


def _slab1(o, d_inv, nmin, nmax, tnear, tfar):
    t1 = (nmin - o) * d_inv
    t2 = (nmax - o) * d_inv
    tn = jnp.max(jnp.minimum(t1, t2))
    tf = jnp.min(jnp.maximum(t1, t2))
    return (tn <= tf) & (tf >= tnear) & (tn <= tfar)


def _mt1(o, d, v0, e1, e2):
    p = jnp.cross(d, e2)
    dot = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    det = dot(e1, p)
    inv = jnp.where(jnp.abs(det) > 1e-18, 1.0 / det, 0.0)
    tv = o - v0
    u = dot(tv, p) * inv
    q = jnp.cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    ok = (jnp.abs(det) > 1e-18) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _traverse_one(o, d, tnear, tfar, bvh: BVHArrays, v0, e1, e2, any_hit):
    d_safe = jnp.where(jnp.abs(d) > 1e-20, d,
                       jnp.where(d >= 0.0, 1e-20, -1e-20))
    d_inv = 1.0 / d_safe
    depth = bvh.max_depth + 2
    n_prims = v0.shape[0]

    def cond(c):
        stack, sp, bt, bu, bv, btri = c
        live = sp > 0
        if any_hit:
            live &= btri < 0
        return live

    def body(c):
        stack, sp, bt, bu, bv, btri = c
        sp = sp - 1
        node = stack[sp]
        box_hit = _slab1(o, d_inv, bvh.node_min[node], bvh.node_max[node],
                         tnear, jnp.minimum(tfar, bt))
        l = bvh.left[node]
        r = bvh.right[node]
        is_leaf = l < 0

        # leaf: masked tests of up to leaf_size primitives
        for k in range(bvh.leaf_size):
            in_leaf = is_leaf & box_hit & (k < bvh.count[node])
            prim = bvh.order[jnp.clip(bvh.start[node] + k, 0, n_prims - 1)]
            t, u, v, ok = _mt1(o, d, v0[prim], e1[prim], e2[prim])
            ok &= in_leaf & (t >= tnear) & (t <= tfar) & (t < bt)
            bt = jnp.where(ok, t, bt)
            bu = jnp.where(ok, u, bu)
            bv = jnp.where(ok, v, bv)
            btri = jnp.where(ok, prim, btri)

        # internal: push both children
        push = (~is_leaf) & box_hit
        stack = stack.at[sp].set(jnp.where(push, l, stack[sp]))
        stack = stack.at[jnp.minimum(sp + 1, depth - 1)].set(
            jnp.where(push, r, stack[jnp.minimum(sp + 1, depth - 1)]))
        sp = sp + jnp.where(push, 2, 0)
        return stack, sp, bt, bu, bv, btri

    stack0 = jnp.zeros((depth,), jnp.int32)
    init = (stack0, jnp.int32(1), _INF, jnp.float32(0), jnp.float32(0),
            jnp.int32(-1))
    _, _, bt, bu, bv, btri = jax.lax.while_loop(cond, body, init)
    return bt, bu, bv, btri


def bvh_closest(bvh: BVHArrays, v0, e1, e2, o, d, tnear, tfar):
    """Vmapped closest-hit traversal for flat ray arrays (R, 3)."""
    f = jax.vmap(lambda oo, dd, tn, tf: _traverse_one(
        oo, dd, tn, tf, bvh, v0, e1, e2, any_hit=False))
    return f(o, d, tnear, tfar)


def bvh_any(bvh: BVHArrays, v0, e1, e2, o, d, tnear, tfar):
    f = jax.vmap(lambda oo, dd, tn, tf: _traverse_one(
        oo, dd, tn, tf, bvh, v0, e1, e2, any_hit=True))
    _bt, _bu, _bv, btri = f(o, d, tnear, tfar)
    return btri >= 0
