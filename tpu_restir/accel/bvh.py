"""Acceleration structures: the Embree-BVH replacement.

Two structures, both built on the host (numpy) and flattened to device
arrays (SURVEY.md §2.3 "Rebuild answer" for Embree):

1. **Morton clusters** (`build_clusters`): triangles sorted by Morton code
   of their centroid and chunked into fixed-size clusters with AABBs.
   Traversal (render.intersect backend "cluster"): a chunk of coherent
   rays tests all cluster AABBs with dense vector ops, then scans
   clusters, lax.cond-skipping any cluster no ray in the chunk touches;
   surviving clusters are intersected via the Woop matmul formulation.
   Culling without pointer-chasing.

2. **BVH2** (`build_bvh2`): binned-SAH binary BVH with a classic
   per-ray stack traversal (vmapped lax.while_loop) — the asymptotically
   right structure for very large scenes and the correctness oracle for
   the cluster path. Mirrors the minimal structure of the reference's
   dead hand-rolled BVH (pg/BVH.cpp:20-217): midpoint/SAH split, small
   leaves, stack traversal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Morton clustering
# ---------------------------------------------------------------------------

def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << 2)) & np.uint64(0x1249249249249249)
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """21-bit-per-axis 3-D Morton codes for points normalized to the AABB."""
    lo = points.min(0)
    hi = points.max(0)
    ext = np.maximum(hi - lo, 1e-20)
    q = np.clip(((points - lo) / ext) * ((1 << 21) - 1), 0,
                (1 << 21) - 1).astype(np.uint64)
    return (_expand_bits(q[:, 0]) << np.uint64(2)) \
        | (_expand_bits(q[:, 1]) << np.uint64(1)) | _expand_bits(q[:, 2])


@dataclasses.dataclass
class Clusters:
    """Flattened cluster arrays (host-side; SceneArrays carries the device
    copies)."""

    order: np.ndarray         # (N,) int32 — permutation: cluster-major tri order
    cluster_min: np.ndarray   # (C, 3)
    cluster_max: np.ndarray   # (C, 3)
    cluster_size: int         # triangles per cluster (last padded)
    n_tris: int


def build_clusters(tri_v: np.ndarray, cluster_size: int = 128) -> Clusters:
    # native C++ builder when the toolchain is available
    from tpu_restir.accel import native

    nat = native.build_clusters_native(np.asarray(tri_v, np.float32),
                                       cluster_size)
    if nat is not None:
        order, cmin, cmax = nat
        return Clusters(order=order, cluster_min=cmin, cluster_max=cmax,
                        cluster_size=cluster_size,
                        n_tris=np.asarray(tri_v).shape[0])

    v = np.asarray(tri_v, np.float64)
    n = v.shape[0]
    centroids = v.mean(axis=1)
    order = np.argsort(morton_codes(centroids), kind="stable").astype(np.int32)
    n_clusters = -(-n // cluster_size)
    cmin = np.full((n_clusters, 3), np.inf, np.float32)
    cmax = np.full((n_clusters, 3), -np.inf, np.float32)
    for c in range(n_clusters):
        idx = order[c * cluster_size:(c + 1) * cluster_size]
        verts = v[idx].reshape(-1, 3)
        cmin[c] = verts.min(0)
        cmax[c] = verts.max(0)
    return Clusters(order=order, cluster_min=cmin, cluster_max=cmax,
                    cluster_size=cluster_size, n_tris=n)


# ---------------------------------------------------------------------------
# Binned-SAH BVH2
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BVH2:
    """Flat binary BVH. Node i: children/leaf encoded as
    left[i] >= 0 -> internal (left/right are node ids);
    left[i] < 0  -> leaf with prims order[start[i] : start[i]+count[i]]."""

    node_min: np.ndarray   # (M, 3)
    node_max: np.ndarray   # (M, 3)
    left: np.ndarray       # (M,) int32
    right: np.ndarray      # (M,) int32
    start: np.ndarray      # (M,) int32
    count: np.ndarray      # (M,) int32
    order: np.ndarray      # (N,) int32 primitive permutation
    max_depth: int


def build_bvh2(tri_v: np.ndarray, leaf_size: int = 4,
               n_bins: int = 16) -> BVH2:
    from tpu_restir.accel import native

    nat = native.build_bvh2_native(np.asarray(tri_v, np.float32), leaf_size,
                                   n_bins)
    if nat is not None:
        return BVH2(**nat)

    v = np.asarray(tri_v, np.float64)
    n = v.shape[0]
    tmin = v.min(axis=1)
    tmax = v.max(axis=1)
    cent = (tmin + tmax) * 0.5

    order = np.arange(n, dtype=np.int32)
    node_min, node_max = [], []
    left, right, start, count = [], [], [], []
    max_depth = [0]

    def new_node():
        node_min.append(None)
        node_max.append(None)
        left.append(-1)
        right.append(-1)
        start.append(0)
        count.append(0)
        return len(left) - 1

    # iterative build with an explicit stack of (node, lo, hi, depth)
    root = new_node()
    stack = [(root, 0, n, 1)]
    while stack:
        node, lo, hi, depth = stack.pop()
        max_depth[0] = max(max_depth[0], depth)
        idx = order[lo:hi]
        bmin = tmin[idx].min(0)
        bmax = tmax[idx].max(0)
        node_min[node] = bmin
        node_max[node] = bmax
        m = hi - lo
        if m <= leaf_size:
            left[node] = -1
            start[node] = lo
            count[node] = m
            continue

        # binned SAH over the widest centroid axis
        c = cent[idx]
        cmin = c.min(0)
        cmax = c.max(0)
        axis = int(np.argmax(cmax - cmin))
        extent = cmax[axis] - cmin[axis]
        if extent <= 1e-12:
            mid = lo + m // 2
        else:
            bins = np.minimum(((c[:, axis] - cmin[axis]) / extent
                               * n_bins).astype(np.int32), n_bins - 1)
            best_cost = np.inf
            best_split = None
            for b in range(1, n_bins):
                lmask = bins < b
                nl = int(lmask.sum())
                nr = m - nl
                if nl == 0 or nr == 0:
                    continue
                lext = tmax[idx[lmask]].max(0) - tmin[idx[lmask]].min(0)
                rext = tmax[idx[~lmask]].max(0) - tmin[idx[~lmask]].min(0)

                def area(e):
                    return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]

                cost = nl * area(lext) + nr * area(rext)
                if cost < best_cost:
                    best_cost = cost
                    best_split = b
            if best_split is None:
                mid = lo + m // 2
            else:
                lmask = bins < best_split
                perm = np.concatenate([idx[lmask], idx[~lmask]])
                order[lo:hi] = perm
                mid = lo + int(lmask.sum())
                if mid == lo or mid == hi:
                    mid = lo + m // 2

        l_node = new_node()
        r_node = new_node()
        left[node] = l_node
        right[node] = r_node
        stack.append((l_node, lo, mid, depth + 1))
        stack.append((r_node, mid, hi, depth + 1))

    return BVH2(node_min=np.asarray(node_min, np.float32),
                node_max=np.asarray(node_max, np.float32),
                left=np.asarray(left, np.int32),
                right=np.asarray(right, np.int32),
                start=np.asarray(start, np.int32),
                count=np.asarray(count, np.int32),
                order=order, max_depth=max_depth[0])
