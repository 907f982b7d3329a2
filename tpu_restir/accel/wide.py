"""Wide (8-ary) BVH: build-by-collapse + lockstep XLA traversal.

A large-scene answer to Embree's rtcIntersect1/rtcOccluded1
(reference pg/Intersection.h:8-113; the dead hand-rolled spec at
pg/BVH.cpp:20-217 is the minimal binary structure this widens). A binary
BVH walk is pointer-chasing with ~1 box test per step — the worst shape
for a vector machine. The wide BVH instead:

  * tests all 8 children of a node with ONE dense (R, 8) slab test —
    vector work amortizes the per-step gather;
  * needs ~3x fewer sequential steps than a BVH2 walk, which matters
    because rays advance in lockstep (a batched while_loop runs until
    the slowest ray finishes);
  * keeps per-ray state tiny: a (node, remaining-children bitmask)
    stack of one entry per depth level, so re-visiting a node re-tests
    its boxes against the CURRENT best-t — free early-out culling.

Traversal is pure XLA (gathers + masked vector math over ray chunks,
no matmuls). Triangles are stored leaf-contiguous
(scene build permutes by BVH leaf order) so leaf tests index start+k
directly with no indirection.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir import struct
from tpu_restir.accel.bvh import BVH2

_INF = np.float32(np.inf)

# leaf slot encoding in meta: 0 = empty, >0 = internal child node id,
# <0 = leaf with enc = -(meta + 1), start = enc >> 5, count = enc & 31
_CNT_BITS = 5
_CNT_MASK = (1 << _CNT_BITS) - 1


class BVH8Arrays(struct.PyTreeNode):
    """Flat device arrays; node i's children live in boxes[i]/meta[i]."""

    boxes: jnp.ndarray   # (M, 8, 6) f32: cmin|cmax per child (empty: +inf/-inf)
    meta: jnp.ndarray    # (M, 8) int32, encoding above
    max_depth: int = struct.field(pytree_node=False, default=24)
    max_leaf: int = struct.field(pytree_node=False, default=4)


@dataclasses.dataclass
class BVH8Host:
    boxes: np.ndarray
    meta: np.ndarray
    order: np.ndarray    # (N,) primitive permutation (leaf-contiguous)
    max_depth: int
    max_leaf: int

    def to_device(self) -> BVH8Arrays:
        return BVH8Arrays(boxes=jnp.asarray(self.boxes),
                          meta=jnp.asarray(self.meta),
                          max_depth=int(self.max_depth),
                          max_leaf=int(self.max_leaf))


def collapse_bvh8(bvh: BVH2, branching: int = 8) -> BVH8Host:
    """Collapse a binary BVH into an 8-ary one: each wide node expands
    its slot set by splitting the largest-area internal BVH2 node until
    `branching` slots are filled or only leaves remain (the standard
    SAH-greedy collapse). Leaf slots keep the BVH2 leaf prim ranges,
    which are contiguous in bvh.order."""
    nmin, nmax = bvh.node_min, bvh.node_max
    left, right = bvh.left, bvh.right
    start, count = bvh.start, bvh.count

    def area(i: int) -> float:
        e = nmax[i] - nmin[i]
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    boxes: list = []
    meta: list = []
    max_leaf = 1

    # queue of (bvh8 slot to patch, bvh2 subtree root, depth)
    boxes.append(np.zeros((8, 6), np.float32))
    meta.append(np.zeros(8, np.int32))
    root_slots = _expand(0, left, right, area, branching)
    work = [(0, root_slots, 1)]
    max_depth = 1
    while work:
        node_id, slots, depth = work.pop()
        max_depth = max(max_depth, depth)
        b = np.zeros((8, 6), np.float32)
        b[:, 0:3] = _INF
        b[:, 3:6] = -_INF
        m = np.zeros(8, np.int32)
        for s, n2 in enumerate(slots):
            b[s, 0:3] = nmin[n2]
            b[s, 3:6] = nmax[n2]
            if left[n2] < 0:  # BVH2 leaf
                c = int(count[n2])
                assert c <= _CNT_MASK
                max_leaf = max(max_leaf, c)
                m[s] = -((int(start[n2]) << _CNT_BITS) | c) - 1
            else:
                child_id = len(boxes)
                boxes.append(np.zeros((8, 6), np.float32))
                meta.append(np.zeros(8, np.int32))
                m[s] = child_id
                work.append((child_id,
                             _expand(n2, left, right, area, branching),
                             depth + 1))
        boxes[node_id] = b
        meta[node_id] = m

    return BVH8Host(boxes=np.stack(boxes), meta=np.stack(meta),
                    order=np.asarray(bvh.order, np.int32),
                    max_depth=max_depth, max_leaf=max_leaf)


def _expand(root: int, left, right, area, branching: int):
    """Slot set for the wide node rooted at BVH2 node `root`."""
    if left[root] < 0:
        return [root]
    slots = [int(left[root]), int(right[root])]
    while len(slots) < branching:
        best = -1
        best_a = -1.0
        for i, n2 in enumerate(slots):
            if left[n2] >= 0:
                a = area(n2)
                if a > best_a:
                    best_a = a
                    best = i
        if best < 0:
            break
        n2 = slots.pop(best)
        slots.extend([int(left[n2]), int(right[n2])])
    return slots


def _mt_rows(o, d, v0, e1, e2):
    """Moller-Trumbore on per-ray triangle rows: all inputs (R, 3).
    Elementwise op sequence identical to intersect._mt_block so a BVH hit
    reproduces the brute backend's t bit-for-bit."""
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    ok_det = jnp.abs(det) > 1e-18
    inv = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    tv = o - v0
    u = jnp.sum(tv * p, axis=-1) * inv
    q = jnp.cross(tv, e1)
    v = jnp.sum(d * q, axis=-1) * inv
    t = jnp.sum(e2 * q, axis=-1) * inv
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _traverse8(o, d, tnear, tfar, bvh: BVH8Arrays, v0, e1, e2,
               any_hit: bool):
    """Batched lockstep traversal over a flat ray chunk (R, 3).

    Per step each live ray: gathers its top-of-stack node row, slab-tests
    the 8 children against (mask, current best t), descends into the
    nearest surviving child (leaf -> inline prim tests; internal -> push)
    and clears its bit. Stack writes go to a junk slot when masked off,
    so no gather-modify-scatter is needed.
    """
    r = o.shape[0]
    rows = jnp.arange(r)
    depth = bvh.max_depth + 2
    n_prims = v0.shape[0]
    d_safe = jnp.where(jnp.abs(d) > 1e-20, d,
                       jnp.where(d >= 0.0, 1e-20, -1e-20))
    inv = 1.0 / d_safe
    bits = (1 << jnp.arange(8, dtype=jnp.int32))

    snode0 = jnp.zeros((r, depth + 1), jnp.int32)
    smask0 = jnp.zeros((r, depth + 1), jnp.int32).at[:, 0].set(0xFF)
    init = (snode0, smask0, jnp.ones((r,), jnp.int32),
            jnp.full((r,), _INF), jnp.zeros((r,)), jnp.zeros((r,)),
            jnp.full((r,), -1, jnp.int32))

    def cond(c):
        _sn, _sm, sp, _bt, _bu, _bv, btri = c
        live = sp > 0
        if any_hit:
            live &= btri < 0
        return jnp.any(live)

    def body(c):
        snode, smask, sp, bt, bu, bv, btri = c
        live = sp > 0
        if any_hit:
            live &= btri < 0
        top = jnp.maximum(sp - 1, 0)
        node = snode[rows, top]
        mask = smask[rows, top]
        nb = bvh.boxes[node]                      # (R, 8, 6)
        nm = bvh.meta[node]                       # (R, 8)

        t1 = (nb[..., 0:3] - o[:, None, :]) * inv[:, None, :]
        t2 = (nb[..., 3:6] - o[:, None, :]) * inv[:, None, :]
        tn_c = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tf_c = jnp.min(jnp.maximum(t1, t2), axis=-1)
        lim = tfar if any_hit else jnp.minimum(tfar, bt)
        hit = ((tn_c <= tf_c) & (tf_c >= tnear[:, None])
               & (tn_c <= lim[:, None]) & ((mask[:, None] & bits) != 0)
               & (nm != 0) & live[:, None])
        entry = jnp.where(hit, tn_c, _INF)
        cbest = jnp.argmin(entry, axis=-1).astype(jnp.int32)
        found = jnp.any(hit, axis=-1)

        # write back the reduced mask at top (junk slot when popping)
        newmask = mask & ~(jnp.int32(1) << cbest)
        wb = jnp.where(found & live, top, depth)
        smask = smask.at[rows, wb].set(jnp.where(found, newmask, 0))
        sp1 = jnp.where(live & ~found, sp - 1, sp)

        cmeta = jnp.take_along_axis(nm, cbest[:, None], axis=1)[:, 0]
        is_int = found & (cmeta > 0)
        is_leaf = found & (cmeta < 0)
        enc = -cmeta - 1
        pstart = enc >> _CNT_BITS
        pcnt = enc & _CNT_MASK

        for k in range(bvh.max_leaf):
            pok = is_leaf & (k < pcnt)
            prim = jnp.clip(pstart + k, 0, n_prims - 1)
            t, u, v, ok = _mt_rows(o, d, v0[prim], e1[prim], e2[prim])
            ok &= pok & (t >= tnear) & (t <= tfar) & (t < bt)
            bt = jnp.where(ok, t, bt)
            bu = jnp.where(ok, u, bu)
            bv = jnp.where(ok, v, bv)
            btri = jnp.where(ok, prim, btri)

        # push internal child (junk slot when not pushing)
        pidx = jnp.where(is_int, sp1, depth)
        snode = snode.at[rows, pidx].set(jnp.where(is_int, cmeta, 0))
        smask = smask.at[rows, pidx].set(jnp.where(is_int, 0xFF, 0))
        sp2 = jnp.where(is_int, sp1 + 1, sp1)
        return snode, smask, sp2, bt, bu, bv, btri

    _sn, _sm, _sp, bt, bu, bv, btri = jax.lax.while_loop(cond, body, init)
    return bt, bu, bv, btri


def bvh8_closest(bvh: BVH8Arrays, v0, e1, e2, o, d, tnear, tfar):
    return _traverse8(o, d, tnear, tfar, bvh, v0, e1, e2, any_hit=False)


def bvh8_any(bvh: BVH8Arrays, v0, e1, e2, o, d, tnear, tfar):
    _bt, _bu, _bv, btri = _traverse8(o, d, tnear, tfar, bvh, v0, e1, e2,
                                     any_hit=True)
    return btri >= 0
