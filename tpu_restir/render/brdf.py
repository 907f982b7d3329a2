"""BRDF layer: sample / evaluate / pdf for every material family.

The reference dispatches materials through C++ virtuals
(pg/material.h:31-149; MaterialLambert/Phong/Dielectric/Mirror/Transparent)
plus a parallel set of static G-buffer variants used by ReSTIR
(pg/MaterialPhong.cpp:122-222). Here both APIs are branchless SoA
functions: every family is evaluated with dense vector ops and the result
is selected by `mat_type` — virtual dispatch as data.

Conventions match the reference exactly:
* `d` is the incident ray direction (unit, pointing INTO the surface).
* `n` is the shading normal, already flipped toward the viewer.
* Phong specular uses the Mallett-Yuksel 1/I_M energy normalization.
* The diffuse/specular lobe pick uses r0 ~ U(0, maxDiff+maxSpec) with the
  diffuse branch on r0 < maxDiff (pg/MaterialPhong.cpp:29-56).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_restir import mathx, struct
from tpu_restir.mathx.special import calc_i_m
from tpu_restir.render import sampling
from tpu_restir.scene.materials import MatType, VertexType

_INV_PI = 1.0 / jnp.pi
_EPS = 1e-12


class BsdfSample(struct.PyTreeNode):
    omega_i: jnp.ndarray  # (..., 3)
    f_r: jnp.ndarray      # (..., 3)
    pdf: jnp.ndarray      # (...,)
    vtype: jnp.ndarray    # (...,) int32 VertexType


# ---------------------------------------------------------------------------
# shared phong-family machinery (PHONG + DIELECTRIC; LAMBERT is the
# degenerate specular=0 case)
# ---------------------------------------------------------------------------

def _phong_reflectances(m, n, d):
    """Per-type (diffuseReflectance, specularReflectance).

    PHONG/LAMBERT use raw colors; DIELECTRIC modulates by Schlick fresnel
    with F0 = specular (pg/MaterialDielectric.cpp:16-17)."""
    spec_fresnel = mathx.schlick_f0(d, n, m.specular)
    max_sf = mathx.max_component(spec_fresnel)
    max_s = mathx.max_component(m.specular)
    scale = (1.0 - max_sf) / jnp.maximum(1.0 - max_s, _EPS)
    d_diel = scale[..., None] * m.diffuse
    is_diel = (m.mat_type == MatType.DIELECTRIC)[..., None]
    d_refl = jnp.where(is_diel, d_diel, m.diffuse)
    s_refl = jnp.where(is_diel, spec_fresnel, m.specular)
    return d_refl, s_refl


def _phong_eval(d_refl, s_refl, shininess, n, d, omega_i, inv_i_m=None):
    """diffuse/pi + spec * (1/I_M) * max(wi.wr, 0)^shininess
    (pg/MaterialPhong.cpp:69-92). inv_i_m: precomputed 1/I_M (the
    G-buffer caches it per frame since N.V is fixed there)."""
    omega_r = mathx.normalize(mathx.reflect(d, n))
    if inv_i_m is None:
        inv_i_m = 1.0 / calc_i_m(mathx.dot(-d, n), shininess)
    lobe = mathx.safe_pow(jnp.maximum(mathx.dot(omega_i, omega_r), 0.0),
                          shininess)
    return d_refl * _INV_PI + s_refl * (inv_i_m * lobe)[..., None]


def _phong_pdf(d_refl, s_refl, shininess, n, d, omega_i):
    """pdfFactor-weighted sum of cosine + cosine-lobe pdfs
    (pg/MaterialPhong.cpp:94-119)."""
    max_d = mathx.max_component(d_refl)
    max_s = mathx.max_component(s_refl)
    pdf_factor = max_d / jnp.maximum(max_d + max_s, _EPS)
    omega_r = mathx.normalize(mathx.reflect(d, n))
    pdf = sampling.pdf_cosine_hemisphere(n, omega_i) * pdf_factor
    pdf += sampling.pdf_cosine_lobe(omega_i, omega_r, shininess) \
        * (1.0 - pdf_factor)
    return pdf


def _phong_sample_u(u5, d_refl, s_refl, shininess, n, d, inv_i_m=None):
    """Lobe-pick + sample + combined pdf (pg/MaterialPhong.cpp:18-67).
    u5: (..., 5) uniforms [lobe pick, diff r1, diff r2, spec r1, spec r2]."""
    max_d = mathx.max_component(d_refl)
    max_s = mathx.max_component(s_refl)
    total = jnp.maximum(max_d + max_s, _EPS)
    r0 = u5[..., 0] * total
    diffuse_branch = r0 < max_d

    omega_r = mathx.normalize(mathx.reflect(d, n))
    wi_d = sampling.cosine_hemisphere_from_uniforms(u5[..., 1:3], n)
    wi_s = sampling.cosine_lobe_from_uniforms(u5[..., 3:5], omega_r,
                                              shininess)
    omega_i = jnp.where(diffuse_branch[..., None], wi_d, wi_s)

    if inv_i_m is None:
        inv_i_m = 1.0 / calc_i_m(mathx.dot(-d, n), shininess)
    lobe = mathx.safe_pow(jnp.maximum(mathx.dot(omega_i, omega_r), 0.0),
                          shininess)
    f_d = d_refl * _INV_PI
    f_s = s_refl * (inv_i_m * lobe)[..., None]
    f_r = jnp.where(diffuse_branch[..., None], f_d, f_s)

    pdf_factor = max_d / total
    pdf = sampling.pdf_cosine_hemisphere(n, omega_i) * pdf_factor \
        + sampling.pdf_cosine_lobe(omega_i, omega_r, shininess) \
        * (1.0 - pdf_factor)

    # below-horizon samples keep their pdf but contribute zero
    # (pg/MaterialPhong.cpp:62-64)
    below = mathx.dot(n, omega_i) < 0.0
    f_r = jnp.where(below[..., None], 0.0, f_r)
    vtype = jnp.where(diffuse_branch, VertexType.DIFFUSE, VertexType.SPECULAR)
    return omega_i, f_r, pdf, vtype.astype(jnp.int32)


def _phong_sample(key, d_refl, s_refl, shininess, n, d):
    u5 = jax.random.uniform(key, mathx.max_component(d_refl).shape + (5,))
    return _phong_sample_u(u5, d_refl, s_refl, shininess, n, d)


# ---------------------------------------------------------------------------
# delta materials
# ---------------------------------------------------------------------------

def _mirror_sample(m, n, d):
    """Delta reflection (pg/MaterialMirror.cpp:4-13)."""
    omega_i = mathx.reflect(d, n)
    theta_i = jnp.maximum(mathx.dot(omega_i, n), 0.0)
    f_r = jnp.where(theta_i[..., None] > 0.0,
                    m.specular / jnp.maximum(theta_i, _EPS)[..., None], 0.0)
    pdf = jnp.ones_like(theta_i)
    return omega_i, f_r, pdf


def _transparent_sample(key, m, n, d, from_inside, dst):
    """Delta reflect/refract by Schlick coefficient + Beer attenuation on
    exit (pg/MaterialTransparent.cpp:6-37)."""
    refl = mathx.reflect(d, n)
    eta = jnp.where(from_inside, m.ior, 1.0 / m.ior)
    refr = mathx.refract(d, n, eta)
    theta_i = jnp.abs(mathx.dot(refl, n))
    ior1 = jnp.where(from_inside, m.ior, 1.0)
    ior2 = jnp.where(from_inside, 1.0, m.ior)
    f0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    cos_t = jnp.maximum(mathx.dot(-d, n), 0.0)
    refl_coeff = f0 + (1.0 - f0) * (1.0 - cos_t) ** 5

    base = jnp.where(theta_i[..., None] > 0.0,
                     m.specular / jnp.maximum(theta_i, _EPS)[..., None], 0.0)
    u = jax.random.uniform(key, theta_i.shape)
    take_refl = u < refl_coeff
    omega_i = jnp.where(take_refl[..., None], refl, refr)
    pdf = jnp.where(take_refl, refl_coeff, 1.0 - refl_coeff)
    f_r = base * pdf[..., None]
    beer = jnp.exp(-m.attenuation * dst[..., None])
    f_r = jnp.where((~take_refl & from_inside)[..., None], f_r * beer, f_r)
    vtype = jnp.where(take_refl, VertexType.SPECULAR, VertexType.REFRACTIVE)
    return omega_i, f_r, pdf, vtype.astype(jnp.int32)


# ---------------------------------------------------------------------------
# instance API (wavefront path tracing) — dispatch over mat_type
# ---------------------------------------------------------------------------

def sample_bsdf(key, m, n, d, from_inside, dst) -> BsdfSample:
    """Material::evaluateLightingGI equivalent for a batch of hits.

    `m` is a per-ray gather of MaterialTable columns
    (scene.materials.gather_materials)."""
    k_ph, k_la, k_tr = jax.random.split(key, 3)
    t = m.mat_type

    d_refl, s_refl = _phong_reflectances(m, n, d)
    wi_p, f_p, pdf_p, vt_p = _phong_sample(k_ph, d_refl, s_refl,
                                           m.shininess, n, d)

    wi_l = sampling.sample_cosine_hemisphere(k_la, n)
    f_l = m.diffuse * _INV_PI
    pdf_l = sampling.pdf_cosine_hemisphere(n, wi_l)

    wi_m, f_m, pdf_m = _mirror_sample(m, n, d)
    wi_t, f_t, pdf_t, vt_t = _transparent_sample(k_tr, m, n, d,
                                                 from_inside, dst)

    is_ts = t == MatType.TS
    is_lam = (t == MatType.LAMBERT) | is_ts  # TS samples as LAMBERT
    is_phg = (t == MatType.PHONG) | (t == MatType.DIELECTRIC)
    is_mir = t == MatType.MIRROR
    is_trn = t == MatType.TRANSPARENT

    def pick(lam, phg, mir, trn, zero):
        out = jnp.where(_bc(is_lam, lam), lam, zero)
        out = jnp.where(_bc(is_phg, phg), phg, out)
        out = jnp.where(_bc(is_mir, mir), mir, out)
        out = jnp.where(_bc(is_trn, trn), trn, out)
        return out

    zero3 = jnp.zeros_like(f_p)
    zero1 = jnp.zeros_like(pdf_p)
    omega_i = pick(wi_l, wi_p, wi_m, wi_t, zero3)
    f_r = pick(f_l, f_p, f_m, f_t, zero3)
    # TS: cosine-sampled direction, but the full D*F*G eval as f_r
    f_r = jnp.where(_bc(is_ts, f_r), _ts_eval(m, n, d, omega_i), f_r)
    pdf = pick(pdf_l, pdf_p, pdf_m, pdf_t, zero1)
    vtype = pick(jnp.full_like(t, VertexType.DIFFUSE), vt_p,
                 jnp.full_like(t, VertexType.MIRROR), vt_t,
                 jnp.full_like(t, VertexType.INVALID))
    return BsdfSample(omega_i=omega_i, f_r=f_r, pdf=pdf, vtype=vtype)


def _ts_eval(m, n, d, omega_i) -> jnp.ndarray:
    """Torrance-Sparrow GGX evaluation, replicating the reference's
    formulas exactly (pg/MaterialTS.cpp:7-69) including its quirks: the
    half vector is (o+i)/2 WITHOUT normalization, Smith G is fed the
    half-vector dots, and alpha == 1 short-circuits D to 1/pi."""
    omega_o = -d
    omega_m = (omega_o + omega_i) * 0.5          # unnormalized (quirk)
    m_dot_i = jnp.maximum(mathx.dot(omega_i, omega_m), 0.0)
    m_dot_o = jnp.maximum(mathx.dot(omega_o, omega_m), 0.0)
    n_dot_m = jnp.maximum(mathx.dot(omega_m, n), 0.0)
    alpha = m.roughness * m.roughness
    a2 = alpha * alpha

    inner = (a2 - 1.0) * n_dot_m * n_dot_m + 1.0
    d_ggx = jnp.where(alpha == 1.0, _INV_PI,
                      _INV_PI * a2 / jnp.maximum(inner * inner, 1e-20))

    def g_aux(dd):
        frac = 1.0 / jnp.maximum(dd * dd, 1e-20) - 1.0
        return (jnp.sqrt(1.0 + a2 * frac) - 1.0) * 0.5

    g = 1.0 / (1.0 + g_aux(m_dot_o) + g_aux(m_dot_i))
    f0 = ((1.0 - m.ior) / (1.0 + m.ior)) ** 2
    f = f0 + (1.0 - f0) * (1.0 - m_dot_i) ** 5
    denom = jnp.maximum(m_dot_i * m_dot_o, 1e-20)
    spec = 0.25 * d_ggx * f * g / denom
    return m.diffuse * _INV_PI + spec[..., None]


def eval_bsdf(m, n, d, omega_i) -> jnp.ndarray:
    """Material::evaluateBRDF: Lambert/Phong/Dielectric/TS evaluate; delta
    and base materials evaluate to 0."""
    t = m.mat_type
    d_refl, s_refl = _phong_reflectances(m, n, d)
    f_phong = _phong_eval(d_refl, s_refl, m.shininess, n, d, omega_i)
    f_lam = m.diffuse * _INV_PI
    out = jnp.zeros_like(f_phong)
    out = jnp.where(_bc(t == MatType.LAMBERT, out), f_lam, out)
    is_phg = (t == MatType.PHONG) | (t == MatType.DIELECTRIC)
    out = jnp.where(_bc(is_phg, out), f_phong, out)
    out = jnp.where(_bc(t == MatType.TS, out), _ts_eval(m, n, d, omega_i),
                    out)
    return out


def pdf_bsdf(m, n, d, omega_i) -> jnp.ndarray:
    """Material::getPdfForSample; 0 for delta/base materials."""
    t = m.mat_type
    d_refl, s_refl = _phong_reflectances(m, n, d)
    pdf_phong = _phong_pdf(d_refl, s_refl, m.shininess, n, d, omega_i)
    pdf_lam = sampling.pdf_cosine_hemisphere(n, omega_i)
    out = jnp.zeros_like(pdf_phong)
    # TS samples like LAMBERT (reference MaterialTS::getType() == LAMBERT)
    out = jnp.where((t == MatType.LAMBERT) | (t == MatType.TS), pdf_lam,
                    out)
    is_phg = (t == MatType.PHONG) | (t == MatType.DIELECTRIC)
    out = jnp.where(is_phg, pdf_phong, out)
    return out


def _bc(mask, ref):
    """Broadcast a (...,) mask against (...,) or (...,3) data."""
    return mask[..., None] if ref.ndim == mask.ndim + 1 else mask


# ---------------------------------------------------------------------------
# G-buffer (screen-space) API used by ReSTIR — reference static variants.
#
# Faithful dispatch quirk: getMaterialBRDFEvalFunc/getMaterialSampleFunc/
# getMaterialPDFEvalFunc (pg/ReSTIRIntegrator.h:32-59) resolve DIELECTRIC
# to MaterialPhong's *inherited* statics, so the screen-space layer only
# distinguishes LAMBERT vs everything-else(Phong); the pdf is always
# Phong's.
# ---------------------------------------------------------------------------

def gbuf_eval_brdf(gb, omega_i):
    """ReSTIR's brdfEval(gBufferElem, cameraPos, omega_i).

    gb: a GBuffer pytree slice with pos/normal/diffuse/specular/shininess/
    mat_type fields plus cam_pos."""
    v = mathx.normalize(gb.cam_pos - gb.pos)
    d = -v
    f_phong = _phong_eval(gb.diffuse, gb.specular, gb.shininess,
                          gb.normal, d, omega_i,
                          inv_i_m=getattr(gb, "inv_i_m", None))
    f_lam = gb.diffuse * _INV_PI
    return jnp.where((gb.mat_type == MatType.LAMBERT)[..., None],
                     f_lam, f_phong)


def gbuf_eval_pdf(gb, omega_i):
    """Always MaterialPhong::evalPdf (pg/MaterialPhong.cpp:150-172)."""
    d = mathx.normalize(gb.pos - gb.cam_pos)
    return _phong_pdf(gb.diffuse, gb.specular, gb.shininess,
                      gb.normal, d, omega_i)


def gbuf_sample_brdf_u(u5, gb):
    """LAMBERT -> cosine sample; everything else -> Phong sample
    (pg/MaterialLambert.cpp:43-53, pg/MaterialPhong.cpp:174-222).
    u5: (..., 5) uniforms; the Lambert branch reuses the diffuse pair."""
    d = mathx.normalize(gb.pos - gb.cam_pos)
    wi_p, f_p, pdf_p, vt_p = _phong_sample_u(
        u5, gb.diffuse, gb.specular, gb.shininess, gb.normal, d,
        inv_i_m=getattr(gb, "inv_i_m", None))
    wi_l = sampling.cosine_hemisphere_from_uniforms(u5[..., 1:3], gb.normal)
    f_l = gb.diffuse * _INV_PI
    pdf_l = sampling.pdf_cosine_hemisphere(gb.normal, wi_l)
    is_lam = gb.mat_type == MatType.LAMBERT
    return BsdfSample(
        omega_i=jnp.where(is_lam[..., None], wi_l, wi_p),
        f_r=jnp.where(is_lam[..., None], f_l, f_p),
        pdf=jnp.where(is_lam, pdf_l, pdf_p),
        vtype=jnp.where(is_lam, VertexType.DIFFUSE, vt_p).astype(jnp.int32))


def gbuf_sample_brdf(key, gb):
    u5 = jax.random.uniform(key, gb.shininess.shape + (5,))
    return gbuf_sample_brdf_u(u5, gb)
