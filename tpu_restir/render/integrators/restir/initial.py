"""PASS 2: initial RIS candidate generation.

Reference: initialRenderPass + areaSampleLight + brdfSampleLight
(pg/ReSTIRIntegrator.cpp:89-177, 236-298). M_Area light-CDF candidates
and M_Brdf BSDF-sampled candidates stream into a per-pixel reservoir with
the per-candidate weight
  w = misWeight * p_hat * W_candidate        (both families in use)
  w = (1/M_family) * p_hat * W_candidate     (single family)
where misWeight is the area/brdf balance heuristic in area measure
(m_area/m_brdf, pg/ReSTIRIntegrator.h:62-74). Candidates are generated
one family-index at a time so peak memory stays at one image per field.

All randomness is PCG4D keyed by (frame_seed, stream, global pixel) —
bit-identical under row sharding.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu_restir import mathx, rng
from tpu_restir.render import brdf, intersect
from tpu_restir.render.integrators.restir import reservoir as rsv
from tpu_restir.render.integrators.restir.gbuffer import GBuffer
from tpu_restir.render.integrators.restir.phat import evaluate_p_hat
from tpu_restir.scene import lights as lights_mod
from tpu_restir.scene.materials import gather_materials


def _mis_m_area(pdf_area, pdf_brdf, m_area, m_brdf):
    """m_area = p_A / (M_A p_A + M_B p_B), 0 when both pdfs vanish
    (pg/ReSTIRIntegrator.h:62-67)."""
    denom = m_area * pdf_area + m_brdf * pdf_brdf
    return jnp.where(denom > 0.0, pdf_area / jnp.maximum(denom, 1e-30), 0.0)


def _mis_m_brdf(pdf_brdf, pdf_area, m_area, m_brdf):
    denom = m_area * pdf_area + m_brdf * pdf_brdf
    return jnp.where(denom > 0.0, pdf_brdf / jnp.maximum(denom, 1e-30), 0.0)


def _area_candidate(u3, scene, gb: GBuffer, cfg):
    """One area-sampled candidate per pixel (areaSampleLight,
    pg/ReSTIRIntegrator.cpp:89-124). Returns (LightSample, W, misWeight)."""
    r = cfg.restir
    ls = lights_mod.light_point_from_uniforms(u3, scene)
    pdf_area = ls["pdf_area"]

    seg = ls["point"] - gb.pos
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_y = jnp.maximum(mathx.dot(-wi, ls["normal"]), 0.0)
    area_factor = jnp.where(r_sqr > 0.0,
                            cos_y / jnp.maximum(r_sqr, 1e-20), 0.0)
    pdf_if_brdf_area = brdf.gbuf_eval_pdf(gb, wi) * area_factor

    cand = rsv.LightSample(point=ls["point"], normal=ls["normal"],
                           l_i=ls["l_i"],
                           valid=jnp.any(ls["l_i"] > 0.0, axis=-1))
    w_c = 1.0 / jnp.maximum(pdf_area, 1e-30)
    mis = _mis_m_area(pdf_area, pdf_if_brdf_area, r.m_area, r.m_brdf)
    return cand, w_c, mis


_EMISSIVE_SUBSET_MAX = 4096


def _closest_emissive_visible(scene, o, d, tnear, cfg):
    """Closest hit restricted to emissive triangles, then one bounded
    occlusion segment against the whole scene.

    brdfSampleLight only keeps EMISSIVE hits (pg/ReSTIRIntegrator.cpp:
    126-177), and emissive triangles are a tiny subset of the scene —
    so instead of a full unbounded closest-hit over incoherent bounce
    rays (the single most expensive query at scale), intersect the
    emissive subset brute-force (E is small), then ask "is anything
    closer?" with an any-hit bounded at t_e - tfar_offset (the
    reference's own shadow-segment epsilon policy,
    pg/Intersection.h:42-60). Rays that miss every emissive die before
    the scene query entirely."""
    import jax

    from tpu_restir.kernels import ray_tri
    from tpu_restir.render.intersect import (Hit, _closest_chunk,
                                             _run_chunked)
    p = cfg.params
    idx = scene.lights.tri_idx
    e = idx.shape[0]
    if scene.woop is not None and (jax.default_backend() == "gpu"
                                   or ray_tri.INTERPRET):
        # fused Pallas-Triton kernel over a subset "scene view": the XLA
        # brute scan puts (chunk, E) Möller-Trumbore intermediates in
        # device memory, the kernel keeps them in registers
        sub = scene.replace(tri_v=scene.tri_v[idx], woop=scene.woop[idx])
        shape = o.shape[:-1]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        tnf = jnp.broadcast_to(jnp.asarray(tnear, jnp.float32),
                               shape).reshape(-1)
        bt, bu, bv, btri = ray_tri.closest_hit(
            sub, o.reshape(-1, 3), d.reshape(-1, 3), tnf,
            jnp.full((n,), jnp.inf, jnp.float32))
        bt, bu, bv, btri = (x.reshape(shape) for x in (bt, bu, bv, btri))
        bt = jnp.where(btri >= 0, bt, jnp.inf)
    else:
        block = min(cfg.intersector.tri_block, e)
        nb = -(-e // block)
        pad = nb * block - e

        def padv(x, fill):
            return jnp.concatenate(
                [x, jnp.full((pad,) + x.shape[1:], fill,
                             x.dtype)]) if pad else x

        v0b = padv(scene.tri_v0[idx], 1e30).reshape(nb, block, 3)
        e1b = padv(scene.tri_e1[idx], 0.0).reshape(nb, block, 3)
        e2b = padv(scene.tri_e2[idx], 0.0).reshape(nb, block, 3)
        from functools import partial
        bt, bu, bv, btri = _run_chunked(
            partial(_closest_chunk, v0b=v0b, e1b=e1b, e2b=e2b),
            o, d, tnear, jnp.inf, cfg.intersector.ray_chunk)
    hit_e = btri >= 0
    # global triangle ids for the subset winners
    gtri = mathx.take_rows(idx.astype(jnp.float32)[:, None],
                           jnp.maximum(btri, 0))[..., 0].astype(jnp.int32)
    # anything closer? dead segment where no emissive was hit
    tf_occ = jnp.where(hit_e, bt - p.tfar_offset, tnear - 1.0)
    occ = intersect.intersect_any(scene, o, d, tnear, tf_occ,
                                  cfg.intersector)
    ok = hit_e & ~occ
    return Hit(t=jnp.where(ok, bt, 0.0), u=bu, v=bv,
               tri=jnp.where(ok, gtri, -1), hit=ok)


def _brdf_candidate(u5, scene, gb: GBuffer, cfg):
    """One BSDF-sampled candidate per pixel (brdfSampleLight,
    pg/ReSTIRIntegrator.cpp:126-177): sample the G-buffer BRDF, trace, and
    accept only emissive hits."""
    p = cfg.params
    r = cfg.restir
    shape = gb.depth.shape

    s = brdf.gbuf_sample_brdf_u(u5, gb)
    o2 = gb.pos + p.normal_offset * gb.normal
    if 0 < scene.lights.count <= _EMISSIVE_SUBSET_MAX:
        hit = _closest_emissive_visible(scene, o2, s.omega_i,
                                        p.tnear_offset, cfg)
    else:
        # bounce directions are per-pixel incoherent: let the fcluster
        # backend re-bin them into direction-coherent packets
        import dataclasses
        icfg = dataclasses.replace(cfg.intersector, bin_rays=True)
        hit = intersect.intersect_closest(scene, o2, s.omega_i,
                                          p.tnear_offset, jnp.inf, icfg)
    hi = intersect.hit_attributes(scene, o2, s.omega_i, hit)
    m2 = gather_materials(scene.materials, hi.mat_id)
    emissive = hi.did_hit & m2.is_emissive()

    seg = hi.point - gb.pos
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_y = jnp.maximum(mathx.dot(-wi, hi.normal), 0.0)
    area_factor = jnp.where(r_sqr > 0.0,
                            cos_y / jnp.maximum(r_sqr, 1e-20), 0.0)
    pdf_brdf_area = s.pdf * area_factor
    pdf_area = lights_mod.pdf_for_any_light_point(scene, shape)

    cand = rsv.LightSample(
        point=jnp.where(emissive[..., None], hi.point, 0.0),
        normal=jnp.where(emissive[..., None], hi.normal, 0.0),
        l_i=jnp.where(emissive[..., None], m2.emission, 0.0),
        valid=emissive)
    w_c = jnp.where(emissive & (pdf_brdf_area > 0.0),
                    1.0 / jnp.maximum(pdf_brdf_area, 1e-30), 0.0)
    mis = jnp.where(emissive,
                    _mis_m_brdf(pdf_brdf_area, pdf_area, r.m_area, r.m_brdf),
                    0.0)
    return cand, w_c, mis


def initial_pass(frame_seed, scene, gb: GBuffer, cfg, ys, xs) -> rsv.Reservoir:
    r = cfg.restir
    p = cfg.params
    shape = gb.depth.shape
    res = rsv.empty_reservoir(shape)

    if not scene.lights.is_valid:
        return res

    test_vis = not r.do_visibility_pass
    one = jnp.ones(shape)

    def u(pass_id, draw, n, slot=0):
        return rng.pixel_uniforms(frame_seed,
                                  rng.stream_id(pass_id, draw, slot),
                                  ys, xs, n)

    for i in range(r.m_area):
        cand, w_c, mis = _area_candidate(u(rng.PASS_INITIAL_AREA, i, 3),
                                         scene, gb, cfg)
        p_hat = evaluate_p_hat(cand, scene, gb, test_vis, p, cfg.intersector)
        weight_term = mis if r.m_brdf > 0 else 1.0 / r.m_area
        w = weight_term * p_hat * w_c
        res, _ = rsv.add_sample_u(
            res, u(rng.PASS_INITIAL_WRS, i, 1)[..., 0], cand, w, one)

    for i in range(r.m_brdf):
        u5 = jnp.concatenate([u(rng.PASS_INITIAL_BRDF, i, 4, 0),
                              u(rng.PASS_INITIAL_BRDF, i, 1, 1)], axis=-1)
        cand, w_c, mis = _brdf_candidate(u5, scene, gb, cfg)
        p_hat = evaluate_p_hat(cand, scene, gb, test_vis, p, cfg.intersector)
        weight_term = mis if r.m_area > 0 else 1.0 / r.m_brdf
        w = weight_term * p_hat * w_c
        res, _ = rsv.add_sample_u(
            res, u(rng.PASS_INITIAL_WRS, 1000 + i, 1)[..., 0], cand, w, one)

    # finalize unbiased contribution weight W = w_sum / p_hat(best)
    # (pg/ReSTIRIntegrator.cpp:289-293)
    p_hat_best = evaluate_p_hat(res.sample, scene, gb, test_vis, p,
                                cfg.intersector)
    w_final = jnp.where(p_hat_best > 0.0,
                        res.w_sum / jnp.maximum(p_hat_best, 1e-30), 0.0)
    res = res.replace(w=w_final)
    res = rsv.cap_confidence(res, r.confidence_cap)

    # emissive pixels get an empty reservoir (pg/ReSTIRIntegrator.cpp:241-244)
    return rsv.select(gb.is_emissive(), rsv.empty_reservoir(shape), res)


def visibility_pass(scene, gb: GBuffer, res: rsv.Reservoir, cfg) -> rsv.Reservoir:
    """PASS 3 (optional): shadow-test the surviving sample; occluded -> W=0
    (pg/ReSTIRIntegrator.cpp:302-312)."""
    occ = intersect.test_occlusion(scene, gb.pos, res.sample.point,
                                   cfg.params, cfg.intersector)
    return res.replace(w=jnp.where(occ, 0.0, res.w))
