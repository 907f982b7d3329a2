"""Material table: SoA arrays indexed by material id.

The reference models materials as a C++ class hierarchy dispatched by
virtual calls (pg/material.h:31-149 and subclasses). Here dynamic
dispatch becomes data: one int8-style `mat_type` column plus dense
parameter columns, consumed branchlessly by tpu_restir.render.brdf via
masked selects.

Type ids match the reference's enum AND its ASSIMP clearcoat-as-type
loader convention (pg/enums.h:3-12, pg/ModelLoader.cpp:52-72):
0=NORMAL(base), 1=LAMBERT, 2=PHONG, 3=MIRROR, 4=DIELECTRIC, 5=TRANSPARENT.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from tpu_restir import struct


class MatType:
    # NORMAL is the reference's tag-only class (pg/MaterialNormal.h:4-7):
    # it inherits the BASE Material behavior, which returns an empty
    # PTInfoGI/BRDFEval — zero BRDF, invalid sample (pg/material.cpp:84-90).
    # The dispatch below reproduces exactly that: NORMAL evaluates to zero
    # and never produces a valid bounce.
    NORMAL = 0
    LAMBERT = 1
    PHONG = 2
    MIRROR = 3
    DIELECTRIC = 4
    TRANSPARENT = 5
    UNSUPPORTED = 6
    # Torrance-Sparrow GGX microfacet (reference MaterialTS.cpp:7-69):
    # eval-only — its getType() reports LAMBERT so samplers and the
    # screen-space (ReSTIR) layer treat it as diffuse, but evaluateBRDF
    # adds the D*F*G specular lobe.
    TS = 7


class VertexType:
    """Path vertex tags driving NEE double-count avoidance
    (reference pg/enums.h:14-21, pg/NEEPathIntegrator.cpp:93-97)."""

    INVALID = -1
    CAMERA = 0
    DIFFUSE = 1
    SPECULAR = 2
    MIRROR = 3
    REFRACTIVE = 4


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material record (builder input)."""

    name: str = "default"
    mat_type: int = MatType.LAMBERT
    ambient: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    diffuse: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    ior: float = 1.5
    reflectivity: float = 1.0
    roughness: float = 1.0   # GGX roughness (MaterialTS; alpha = r^2)
    attenuation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # texture slots (indices into the scene texture stack; -1 = none);
    # same 4 slots as the reference (pg/material.h kDiffuseMapSlot..):
    tex_diffuse: int = -1
    tex_specular: int = -1
    tex_shininess: int = -1  # stores roughness; s = 2/r^2 - 2 (pg/material.cpp:123-133)
    tex_normal: int = -1


class MaterialTable(struct.PyTreeNode):
    diffuse: jnp.ndarray       # (M, 3)
    specular: jnp.ndarray      # (M, 3)
    emission: jnp.ndarray      # (M, 3)
    ambient: jnp.ndarray       # (M, 3)
    attenuation: jnp.ndarray   # (M, 3)
    shininess: jnp.ndarray     # (M,)
    ior: jnp.ndarray           # (M,)
    reflectivity: jnp.ndarray  # (M,)
    roughness: jnp.ndarray     # (M,) — GGX alpha = roughness^2 (MaterialTS)
    mat_type: jnp.ndarray      # (M,) int32
    tex_index: jnp.ndarray     # (M, 4) int32 — diffuse/specular/shininess/normal
    # Static: sorted distinct mat_type values in the table. Lets passes
    # specialize at trace time (e.g. the slim reuse payload when no
    # specular-lobed material exists); () = unknown (no specialization).
    types_present: Tuple[int, ...] = struct.field(pytree_node=False,
                                                  default=())

    @property
    def count(self) -> int:
        return self.diffuse.shape[0]

    def is_emissive(self) -> jnp.ndarray:
        """emission > 0 on any channel (reference Material::isEmitter,
        pg/material.cpp:92-94)."""
        return jnp.any(self.emission > 0.0, axis=-1)


def build_material_table(specs: List[MaterialSpec]) -> MaterialTable:
    def f3(field):
        return jnp.asarray(np.array([getattr(s, field) for s in specs],
                                    dtype=np.float32))

    def f1(field):
        return jnp.asarray(np.array([getattr(s, field) for s in specs],
                                    dtype=np.float32))

    tex = np.array([[s.tex_diffuse, s.tex_specular, s.tex_shininess,
                     s.tex_normal] for s in specs], dtype=np.int32)
    return MaterialTable(
        diffuse=f3("diffuse"), specular=f3("specular"),
        emission=f3("emission"), ambient=f3("ambient"),
        attenuation=f3("attenuation"),
        shininess=f1("shininess"), ior=f1("ior"),
        reflectivity=f1("reflectivity"), roughness=f1("roughness"),
        mat_type=jnp.asarray(np.array([s.mat_type for s in specs],
                                      dtype=np.int32)),
        tex_index=jnp.asarray(tex),
        types_present=tuple(sorted({s.mat_type for s in specs})),
    )


def gather_materials(table: MaterialTable, mat_id: jnp.ndarray):
    """Per-ray material columns for a flat array of material ids.

    One packed row-select (mathx.take_rows) instead of ten XLA
    gathers — the table is tiny, the index array is the whole frame.
    Int columns (mat_type, tex slots) are small ints, exact as f32."""
    from tpu_restir import mathx

    i = jnp.clip(mat_id, 0, table.count - 1)
    packed = jnp.concatenate([
        table.diffuse, table.specular, table.emission, table.ambient,
        table.attenuation, table.shininess[:, None], table.ior[:, None],
        table.reflectivity[:, None], table.roughness[:, None],
        table.mat_type.astype(jnp.float32)[:, None],
        table.tex_index.astype(jnp.float32)], axis=1)       # (M, 24)
    r = mathx.take_rows(packed, i)
    return MaterialTable(
        diffuse=r[..., 0:3], specular=r[..., 3:6], emission=r[..., 6:9],
        ambient=r[..., 9:12], attenuation=r[..., 12:15],
        shininess=r[..., 15], ior=r[..., 16], reflectivity=r[..., 17],
        roughness=r[..., 18],
        mat_type=r[..., 19].astype(jnp.int32),
        tex_index=r[..., 20:24].astype(jnp.int32),
        types_present=table.types_present,
    )


def apply_textures(scene, m: MaterialTable, uv: jnp.ndarray) -> MaterialTable:
    """Texture-backed material values at hit UVs: diffuse/specular texels
    replace the flat colors, and the shininess slot stores roughness
    converted via s = 2/r^2 - 2 (reference Material::getDiffuseColor/
    getSpecularColor/getShininess, pg/material.cpp:105-133)."""
    if scene.textures is None:
        return m
    from tpu_restir.scene.textures import sample_stack

    diffuse = sample_stack(scene.textures, m.tex_index[..., 0], uv,
                           m.diffuse)
    specular = sample_stack(scene.textures, m.tex_index[..., 1], uv,
                            m.specular)
    rough = sample_stack(scene.textures, m.tex_index[..., 2], uv,
                         jnp.zeros_like(m.diffuse))[..., 0]
    shin_from_tex = 2.0 / jnp.maximum(rough * rough, 1e-6) - 2.0
    shininess = jnp.where(m.tex_index[..., 2] >= 0, shin_from_tex,
                          m.shininess)
    return m.replace(diffuse=diffuse, specular=specular, shininess=shininess)


def apply_normal_map(scene, m: MaterialTable, normal, tangent, uv):
    """Tangent-space normal mapping (reference Intersection.h:26-39):
    orthogonalize the tangent against the shading normal, build TBN, and
    replace the normal where a normal map is assigned."""
    if scene.textures is None:
        return normal
    from tpu_restir import mathx
    from tpu_restir.scene.textures import sample_stack

    has_map = m.tex_index[..., 3] >= 0
    texel = sample_stack(scene.textures, m.tex_index[..., 3], uv,
                         jnp.broadcast_to(jnp.asarray([0.5, 0.5, 1.0]),
                                          normal.shape))
    n_ts = texel * 2.0 - 1.0
    t = tangent - mathx.dot1(tangent, normal) * normal
    t = mathx.normalize(t)
    b = mathx.normalize(jnp.cross(normal, t))
    mapped = (n_ts[..., 0:1] * t + n_ts[..., 1:2] * b
              + n_ts[..., 2:3] * normal)
    return jnp.where(has_map[..., None], mapped, normal)
