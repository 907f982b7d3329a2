"""SceneArrays: the whole scene as one pytree of device arrays.

Replaces the reference's Scene/Surface/Triangle/Vertex object graph +
Embree RTCScene (pg/Scene.cpp, pg/surface.cpp, pg/triangle.cpp) with flat
SoA arrays resident in device memory: triangle vertices, per-vertex attributes,
per-triangle material ids, the emissive CDF, optional texture stack and
environment map. Geometry is replicated across devices; pixels shard.
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from tpu_restir import struct
from tpu_restir.accel.wide import BVH8Arrays
from tpu_restir.scene.lights import EmissiveCDF, build_emissive_cdf
from tpu_restir.scene.materials import (MaterialSpec, MaterialTable,
                                        build_material_table)
from tpu_restir.scene.textures import TextureStack


class SceneArrays(struct.PyTreeNode):
    # geometry
    tri_v: jnp.ndarray        # (N, 3, 3) vertex positions
    tri_v0: jnp.ndarray       # (N, 3)   == tri_v[:, 0] (intersection fast path)
    tri_e1: jnp.ndarray       # (N, 3)   v1 - v0
    tri_e2: jnp.ndarray       # (N, 3)   v2 - v0
    tri_area: jnp.ndarray     # (N,)     0.5 * |e1 x e2| (pg/triangle.cpp:4-38)
    # per-vertex attributes (interpolated at hits like rtcInterpolate0)
    vtx_normal: jnp.ndarray   # (N, 3, 3)
    vtx_uv: jnp.ndarray       # (N, 3, 2)
    vtx_tangent: jnp.ndarray  # (N, 3, 3)
    # per-triangle material
    tri_mat: jnp.ndarray      # (N,) int32
    materials: MaterialTable
    lights: EmissiveCDF
    # intersection acceleration
    woop: Optional[jnp.ndarray] = None          # (N, 3, 4) Woop affine maps
    cluster_min: Optional[jnp.ndarray] = None   # (C, 3) Morton-cluster AABBs
    cluster_max: Optional[jnp.ndarray] = None   # (C, 3)
    cluster_size: int = struct.field(pytree_node=False, default=0)
    bvh: Optional["BVH8Arrays"] = None          # wide BVH (accel.wide)
    # optional resources
    textures: Optional[TextureStack] = None  # native-res padded stack
    envmap: Optional[jnp.ndarray] = None     # (He, We, 3) float32 equirect

    @property
    def num_tris(self) -> int:
        return self.tri_v.shape[0]

    def tri_emissive_mask(self) -> jnp.ndarray:
        return self.materials.is_emissive()[self.tri_mat]


def build_scene(
    vertices: np.ndarray,          # (N, 3, 3)
    material_ids: np.ndarray,      # (N,)
    specs: List[MaterialSpec],
    vertex_normals: Optional[np.ndarray] = None,   # (N, 3, 3)
    vertex_uvs: Optional[np.ndarray] = None,       # (N, 3, 2)
    vertex_tangents: Optional[np.ndarray] = None,  # (N, 3, 3)
    textures: Optional[np.ndarray] = None,
    envmap: Optional[np.ndarray] = None,
    cluster_size: int = 64,
) -> SceneArrays:
    v = np.asarray(vertices, np.float32)
    n_tris = v.shape[0]

    # Build the wide BVH and permute everything leaf-major so hit/leaf
    # indices need no indirection (tpu_restir.accel.{bvh,wide}). BVH leaf
    # order is spatially coherent, so the Morton-cluster AABBs for the
    # cluster-culling backend are just per-chunk bounds of the same order.
    cluster_min = cluster_max = None
    bvh8 = None
    if n_tris > cluster_size:
        from tpu_restir.accel.bvh import build_bvh2
        from tpu_restir.accel.wide import collapse_bvh8

        bvh8 = collapse_bvh8(build_bvh2(v, leaf_size=4))
        perm = bvh8.order
        v = v[perm]
        material_ids = np.asarray(material_ids)[perm]
        if vertex_normals is not None:
            vertex_normals = np.asarray(vertex_normals)[perm]
        if vertex_uvs is not None:
            vertex_uvs = np.asarray(vertex_uvs)[perm]
        if vertex_tangents is not None:
            vertex_tangents = np.asarray(vertex_tangents)[perm]
        # cluster AABBs over consecutive chunks of the permuted order
        n_cl = -(-n_tris // cluster_size)
        pad = n_cl * cluster_size - n_tris
        vp = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) if pad else v
        vc = vp.reshape(n_cl, cluster_size * 3, 3)
        cluster_min = vc.min(axis=1).astype(np.float32)
        cluster_max = vc.max(axis=1).astype(np.float32)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    if vertex_normals is None:
        # face normals, replicated to vertices (right-handed winding)
        fn = np.cross(e1, e2)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        vertex_normals = np.repeat(fn[:, None, :], 3, axis=1)
    if vertex_uvs is None:
        vertex_uvs = np.zeros((n_tris, 3, 2), np.float32)
    if vertex_tangents is None:
        t = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-20)
        vertex_tangents = np.repeat(t[:, None, :], 3, axis=1)

    from tpu_restir.kernels.woop import build_woop_matrices

    mat_ids = np.asarray(material_ids, np.int32)
    table = build_material_table(specs)
    emissive_mat = np.array(
        [any(c > 0 for c in s.emission) for s in specs], bool)
    lights = build_emissive_cdf(areas.astype(np.float32),
                                emissive_mat[mat_ids])

    return SceneArrays(
        tri_v=jnp.asarray(v),
        tri_v0=jnp.asarray(v[:, 0]),
        tri_e1=jnp.asarray(e1.astype(np.float32)),
        tri_e2=jnp.asarray(e2.astype(np.float32)),
        tri_area=jnp.asarray(areas.astype(np.float32)),
        vtx_normal=jnp.asarray(np.asarray(vertex_normals, np.float32)),
        vtx_uv=jnp.asarray(np.asarray(vertex_uvs, np.float32)),
        vtx_tangent=jnp.asarray(np.asarray(vertex_tangents, np.float32)),
        tri_mat=jnp.asarray(mat_ids),
        materials=table,
        lights=lights,
        woop=jnp.asarray(build_woop_matrices(v)),
        cluster_min=jnp.asarray(cluster_min) if cluster_min is not None
        else None,
        cluster_max=jnp.asarray(cluster_max) if cluster_max is not None
        else None,
        cluster_size=cluster_size if cluster_min is not None else 0,
        bvh=bvh8.to_device() if bvh8 is not None else None,
        textures=_as_texture_stack(textures),
        envmap=jnp.asarray(envmap) if envmap is not None else None,
    )


def _as_texture_stack(textures) -> Optional[TextureStack]:
    """Accept a TextureStack or a raw uniform (T, H, W, 3) array."""
    if textures is None or isinstance(textures, TextureStack):
        return textures
    arr = np.asarray(textures, np.float32)
    t, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
    return TextureStack(data=jnp.asarray(arr),
                        sizes=jnp.tile(jnp.asarray([h, w], jnp.int32),
                                       (t, 1)),
                        modes=jnp.zeros((t,), jnp.int32))
