"""OBJ/MTL scene loading — the ASSIMP replacement (pure Python).

Covers what the reference actually uses from ASSIMP
(pg/ModelLoader.cpp:18-321): triangulated OBJ geometry with per-vertex
normals/uvs, MTL materials with the reference's **clearcoat-as-type
convention** (`Pc` value selects the material class: 0=Normal, 1=Lambert,
2=Phong, 3=Mirror, 4=Dielectric, 5=Transparent — pg/ModelLoader.cpp:52-72),
gamma expansion of ambient/diffuse/specular colors and diffuse/specular
textures, texture slots (diffuse/specular/shininess/normal), per-face
tangents from UVs (CalcTangentSpace equivalent), and emissive-triangle
collection for the light CDF (done by build_scene).

When no Pc key is present (assets authored outside the reference's
pipeline), the type falls back to Phong when Ks > 0 else Lambert.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_restir.mathx.color import srgb_expand
from tpu_restir.scene.materials import MaterialSpec, MatType
from tpu_restir.scene.scene import SceneArrays, build_scene
from tpu_restir.scene.textures import build_texture_stack

_PC_TO_TYPE = {0: MatType.NORMAL, 1: MatType.LAMBERT, 2: MatType.PHONG,
               3: MatType.MIRROR, 4: MatType.DIELECTRIC,
               5: MatType.TRANSPARENT}


def _expand_np(c):
    c = np.clip(np.asarray(c, np.float32), 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92,
                    np.power((c + 0.055) / 1.055, 2.4)).astype(np.float32)


def _load_image(path: str, srgb: bool) -> Optional[np.ndarray]:
    """LDR via PIL (sRGB-expanded like the reference's gamma handling);
    HDR formats load as linear float and skip the expand (the reference's
    pixel_size > 4 path, pg/Texture.cpp:91-98)."""
    if path.lower().endswith((".hdr", ".exr", ".pfm")):
        try:
            from tpu_restir.scene.envmap import load_hdr

            return load_hdr(path)
        except ImportError:
            raise
        except Exception:
            return None
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"loading the LDR texture {path!r} needs the 'Pillow' package "
            "(import PIL), which is not installed") from e
    try:
        img = np.asarray(Image.open(path).convert("RGB"),
                         np.float32) / 255.0
    except Exception:
        return None
    if srgb:
        img = _expand_np(img)
    return img


def parse_mtl(path: str, gamma_correct: bool = True):
    """Returns (specs_by_name, texture_paths) — texture paths resolved
    relative to the MTL file; slot -> (path, srgb) per material."""
    mats: Dict[str, dict] = {}
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = dict(name=tok[1], Ka=(0.1,) * 3, Kd=(0.5,) * 3,
                           Ks=(0.0,) * 3, Ke=(0.0,) * 3, Ns=1.0, Ni=1.5,
                           Tf=(0.0,) * 3, Pc=None, textures={})
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks", "Ke", "Tf"):
                cur[key] = tuple(float(v) for v in tok[1:4])
            elif key == "Ns":
                cur["Ns"] = float(tok[1])
            elif key == "Ni":
                cur["Ni"] = float(tok[1])
            elif key == "Pc":
                cur["Pc"] = float(tok[1])
            elif key == "map_Kd":
                cur["textures"]["diffuse"] = (os.path.join(base, tok[-1]),
                                              True)
            elif key == "map_Ks":
                cur["textures"]["specular"] = (os.path.join(base, tok[-1]),
                                               True)
            elif key == "map_Ns":
                cur["textures"]["shininess"] = (os.path.join(base, tok[-1]),
                                                False)
            elif key in ("map_bump", "bump", "norm", "map_Kn"):
                cur["textures"]["normal"] = (os.path.join(base, tok[-1]),
                                             False)
    return mats


def _mat_spec(m: dict, tex_ids: Dict[str, int],
              gamma_correct: bool) -> MaterialSpec:
    pc = m["Pc"]
    if pc is not None and int(pc) in _PC_TO_TYPE:
        mtype = _PC_TO_TYPE[int(pc)]
    elif max(m["Ks"]) > 0.0:
        mtype = MatType.PHONG
    else:
        mtype = MatType.LAMBERT

    def gam(c):
        return tuple(_expand_np(c).tolist()) if gamma_correct else tuple(c)

    return MaterialSpec(
        name=m["name"], mat_type=mtype,
        ambient=gam(m["Ka"]), diffuse=gam(m["Kd"]), specular=gam(m["Ks"]),
        emission=tuple(m["Ke"]), shininess=m["Ns"], ior=m["Ni"],
        attenuation=tuple(m["Tf"]),
        tex_diffuse=tex_ids.get("diffuse", -1),
        tex_specular=tex_ids.get("specular", -1),
        tex_shininess=tex_ids.get("shininess", -1),
        tex_normal=tex_ids.get("normal", -1))


def _compute_tangents(v, uv):
    """Per-face tangents from UV parametrization (ASSIMP CalcTangentSpace
    equivalent); falls back to edge direction on degenerate UVs."""
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    du1 = uv[:, 1, 0] - uv[:, 0, 0]
    dv1 = uv[:, 1, 1] - uv[:, 0, 1]
    du2 = uv[:, 2, 0] - uv[:, 0, 0]
    dv2 = uv[:, 2, 1] - uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    fallback = e1
    tan = np.where(ok[:, None], tan, fallback)
    norm = np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)
    return (tan / norm).astype(np.float32)


def load_obj(path: str, gamma_correct: bool = True):
    """Parse an OBJ file. Returns dict with triangle arrays, material ids,
    specs, texture stack."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    faces = []  # (list of (vi, ti, ni), material index)
    mtl: Dict[str, dict] = {}
    mat_order: List[str] = []
    cur_mat = 0

    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append(tuple(float(x) for x in tok[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in tok[1:4]))
            elif key == "vt":
                uvs.append(tuple(float(x) for x in tok[1:3]))
            elif key == "mtllib":
                p = os.path.join(base, " ".join(tok[1:]))
                if os.path.exists(p):
                    mtl.update(parse_mtl(p, gamma_correct))
            elif key == "usemtl":
                name = tok[1]
                if name not in mat_order:
                    mat_order.append(name)
                cur_mat = mat_order.index(name)
            elif key == "f":
                verts = []
                for vstr in tok[1:]:
                    parts = vstr.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    verts.append((vi, ti, ni))
                # triangulate fans
                for k in range(1, len(verts) - 1):
                    faces.append(((verts[0], verts[k], verts[k + 1]),
                                  cur_mat))

    if not mat_order:
        mat_order = ["default"]

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32) if normals else None
    uvarr = np.asarray(uvs, np.float32) if uvs else None

    def resolve(idx, n):
        return idx - 1 if idx > 0 else n + idx

    n_f = len(faces)
    tri_v = np.zeros((n_f, 3, 3), np.float32)
    tri_n = np.zeros((n_f, 3, 3), np.float32)
    tri_uv = np.zeros((n_f, 3, 2), np.float32)
    mat_ids = np.zeros((n_f,), np.int32)
    have_n = np.zeros((n_f,), bool)
    for i, (vs, m) in enumerate(faces):
        mat_ids[i] = m
        for j, (vi, ti, ni) in enumerate(vs):
            tri_v[i, j] = pos[resolve(vi, len(pos))]
            if ti and uvarr is not None:
                tri_uv[i, j] = uvarr[resolve(ti, len(uvarr))]
            if ni and nrm is not None:
                tri_n[i, j] = nrm[resolve(ni, len(nrm))]
                have_n[i] = True
    # faces without normals get face normals (computed by build_scene when
    # we pass None); mix: fill missing with face normal
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    tri_n[~have_n] = fn[~have_n][:, None, :]

    # textures: gather unique (path, srgb), build stack
    tex_paths: List[Tuple[str, bool]] = []
    specs: List[MaterialSpec] = []
    for name in mat_order:
        m = mtl.get(name, dict(name=name, Ka=(0.1,) * 3, Kd=(0.5,) * 3,
                               Ks=(0.0,) * 3, Ke=(0.0,) * 3, Ns=1.0,
                               Ni=1.5, Tf=(0.0,) * 3, Pc=None, textures={}))
        ids = {}
        for slot, (tpath, srgb) in m.get("textures", {}).items():
            keyt = (tpath, srgb)
            if keyt not in tex_paths:
                img = _load_image(tpath, srgb)
                if img is None:
                    continue
                tex_paths.append(keyt)
            ids[slot] = tex_paths.index(keyt)
        specs.append(_mat_spec(m, ids, gamma_correct))

    stack = None
    if tex_paths:
        imgs = [_load_image(p, srgb) for p, srgb in tex_paths]
        stack = build_texture_stack([im for im in imgs if im is not None])

    return dict(tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, mat_ids=mat_ids,
                specs=specs, textures=stack,
                tangents=_compute_tangents(tri_v, tri_uv)[:, None, :].repeat(
                    3, axis=1))


def load_obj_scene(path: str, gamma_correct: bool = True,
                   cluster_size: int = 32) -> SceneArrays:
    d = load_obj(path, gamma_correct)
    return build_scene(d["tri_v"], d["mat_ids"], d["specs"],
                       vertex_normals=d["tri_n"], vertex_uvs=d["tri_uv"],
                       vertex_tangents=d["tangents"],
                       textures=d["textures"], cluster_size=cluster_size)
