"""PASS 5: spatial reuse with selectable MIS/debiasing schemes.

Reference: spatialReusePass (pg/ReSTIRIntegrator.cpp:316-542). Per pixel:
pick up to K disk neighbors (center always candidate 0), reject emissive
and optionally dissimilar neighbors, then resample all candidates with a
scheme-dependent MIS weight:
  CONSTANT                — 1/M (biased)
  CONSTANT_DEBIAS_Z       — 1/M then multiply W by M/|Z|
  CONSTANT_DEBIAS_CONTRIB — 1/M then multiply W by M * contribution weight
  BALANCE_HEURISTIC       — generalized balance heuristic, O(M^2) p_hat
  PAIRWISE                — pairwise MIS vs the canonical sample, O(M)
All per-pixel control flow is masked vector math; every p_hat evaluation
with visibility is one batched occlusion query over the whole image.

Sharded mode: neighbor taps read halo-extended reservoir/G-buffer strips
(tpu_restir.dist.halo); disk offsets and WRS acceptance are PCG4D draws
keyed by GLOBAL pixel coords, so the sharded pass is bit-identical to the
single-chip pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_restir import mathx, rng
from tpu_restir.config import SpatialMis
from tpu_restir.dist.halo import local_row
from tpu_restir.render import intersect
from tpu_restir.render.integrators.restir import gbuffer as gb_mod
from tpu_restir.render.integrators.restir import packed as pk
from tpu_restir.render.integrators.restir import reservoir as rsv
from tpu_restir.render.integrators.restir.phat import evaluate_p_hat
from tpu_restir.render.sampling import disk_int_from_uniform


def spatial_pass(frame_seed, pass_idx: int, scene, gb: gb_mod.GBuffer,
                 res_in: rsv.Reservoir, cfg, ys, xs, *,
                 gb_ext=None, res_ext=None,
                 ext_row0=0) -> rsv.Reservoir:
    p = cfg.params
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    shape = gb.depth.shape
    gb_ext = gb if gb_ext is None else gb_ext
    res_ext = res_in if res_ext is None else res_ext
    ext_h = gb_ext.depth.shape[0]
    n_cand = r.spatial_neighbor_count + 1  # index 0 = center

    def uni(draw, n, slot):
        return rng.pixel_uniforms(
            frame_seed,
            rng.stream_id(rng.PASS_SPATIAL, pass_idx * 64 + draw, slot),
            ys, xs, n)

    # neighbor coords: integer disk offsets distributed as the
    # reference's trunc(float disk sample) (glm vec2->ivec2 conversion,
    # pg/ReSTIRIntegrator.cpp:334-341), drawn via a static table so the
    # pick is BITWISE identical in every compilation — the float
    # cos/sin path could round differently between the sharded and
    # unsharded programs and flip trunc() at a cell boundary, the one
    # divergence source of round-4's 2%-tolerance sharding oracle
    cand_gy = [ys]
    cand_gx = [xs]
    for k in range(r.spatial_neighbor_count):
        offi = disk_int_from_uniform(uni(k, 2, 2)[..., 0],
                                     r.spatial_reuse_radius)
        cand_gx.append(jnp.clip(xs + offi[..., 0], 0, w - 1))
        cand_gy.append(jnp.clip(ys + offi[..., 1], 0, h - 1))

    # one packed payload + ONE gather for all neighbor taps (candidate 0
    # is the identity tap: use the center buffers directly)
    slim = pk.reuse_slim(scene.materials)
    payload = pk.pack_reuse(gb_ext, res_ext, slim)    # (ext_h, w, 32|24)
    tap_ys = jnp.stack([local_row(cand_gy[i], ext_row0, ext_h)
                        for i in range(1, n_cand)])
    tap_xs = jnp.stack(cand_gx[1:])
    taps = pk.gather_packed(payload, tap_ys, tap_xs)  # (K, h, w, 32|24)
    gbc = pk.gb_ch(slim)
    gbs = [gb] + [pk.unpack_gb(taps[i - 1, ..., :gbc], gb, slim)
                  for i in range(1, n_cand)]
    ress = [res_in] + [pk.unpack_res(taps[i - 1, ..., gbc:], slim)
                       for i in range(1, n_cand)]

    # candidate validity (pg/ReSTIRIntegrator.cpp:344-374)
    valid = [jnp.ones(shape, bool)]
    for i in range(1, n_cand):
        ok = ~gbs[i].is_emissive()
        if r.reject_dissimilar_neighbors:
            n_sim = mathx.dot(gbs[i].normal, gb.normal)
            ok &= n_sim >= r.min_normal_similarity
            depth_ratio = jnp.where(gbs[i].depth > 0.0,
                                    gb.depth / jnp.maximum(gbs[i].depth,
                                                           1e-20), 0.0)
            half = r.max_depth_difference * 0.5
            ok &= (depth_ratio >= 1.0 - half) & (depth_ratio <= 1.0 + half)
        valid.append(ok)
    valid = jnp.stack(valid)                       # (n_cand, h, w)
    m_count = jnp.sum(valid, axis=0).astype(jnp.float32)
    rcp_m = jnp.where(m_count > 0.0, 1.0 / m_count, 0.0)

    conf = jnp.stack([jnp.where(valid[i], ress[i].confidence, 0.0)
                      for i in range(n_cand)])
    conf_sum = jnp.sum(conf, axis=0)
    conf_nc = conf_sum - conf[0]

    def ph(sample, surf):
        return evaluate_p_hat(sample, scene, surf, True, p, cfg.intersector)

    # resampling p_hat: every candidate's sample at the center surface —
    # needed by all schemes (pg/ReSTIRIntegrator.cpp:472)
    p_center = jnp.stack([ph(ress[i].sample, gb) for i in range(n_cand)])

    # --- MIS weights per scheme
    if r.spatial_mis == SpatialMis.BALANCE_HEURISTIC:
        # O(M^2): p_hat of sample_i at every neighbor surface j
        # (pg/ReSTIRIntegrator.cpp:406-424)
        mis = []
        for i in range(n_cand):
            nom = jnp.zeros(shape)
            denom = jnp.zeros(shape)
            for j in range(n_cand):
                pij = p_center[i] if j == 0 else ph(ress[i].sample, gbs[j])
                pij = jnp.where(valid[j], pij, 0.0)
                denom += pij * conf[j]
                if i == j:
                    nom = pij * conf[i]
            mis.append(jnp.where(denom > 0.0,
                                 nom / jnp.maximum(denom, 1e-30), 0.0))
        mis = jnp.stack(mis)
    elif r.spatial_mis == SpatialMis.PAIRWISE:
        # O(M) pairwise vs the canonical (center) candidate
        # (pg/ReSTIRIntegrator.cpp:427-467)
        p_diag = [p_center[0]] + [ph(ress[i].sample, gbs[i])
                                  for i in range(1, n_cand)]
        p_c_at_j = [p_center[0]] + [ph(ress[0].sample, gbs[j])
                                    for j in range(1, n_cand)]
        safe_conf_sum = jnp.maximum(conf_sum, 1e-30)
        mis = []
        # canonical weight
        p_hat_c = p_diag[0] * conf[0]
        acc = jnp.zeros(shape)
        for j in range(1, n_cand):
            p_hat_j = jnp.where(valid[j], p_c_at_j[j], 0.0)
            denom = p_hat_c + p_hat_j * conf_nc
            term = jnp.where((denom > 0.0) & valid[j],
                             (conf[j] / safe_conf_sum)
                             * (p_hat_c / jnp.maximum(denom, 1e-30)), 0.0)
            acc += term
        mis.append(jnp.where(conf_sum > 0.0, conf[0] / safe_conf_sum + acc,
                             0.0))
        # non-canonical weights; p_hat of sample_i at the canonical surface
        # is exactly the resampling p_hat already computed (gbs[0] == gb)
        for i in range(1, n_cand):
            p_hat_i = jnp.where(valid[i], p_diag[i], 0.0) * conf_nc
            denom = p_hat_i + p_center[i] * conf[0]
            w_i = jnp.where((denom > 0.0) & (conf_sum > 0.0),
                            (conf[i] / safe_conf_sum)
                            * (p_hat_i / jnp.maximum(denom, 1e-30)), 0.0)
            mis.append(w_i)
        mis = jnp.stack(mis)
    else:
        mis = jnp.broadcast_to(rcp_m, (n_cand,) + shape)

    # --- resample (pg/ReSTIRIntegrator.cpp:470-478)
    out = rsv.empty_reservoir(shape)
    sel_idx = jnp.zeros(shape, jnp.int32)
    for i in range(n_cand):
        w_i = jnp.where(valid[i], mis[i] * p_center[i] * ress[i].w, 0.0)
        out, acc = rsv.add_sample_u(out, uni(i, 1, 3)[..., 0],
                                    ress[i].sample, w_i, conf[i])
        sel_idx = jnp.where(acc, i, sel_idx)

    # --- finalize W per scheme (pg/ReSTIRIntegrator.cpp:480-538)
    final_p_hat = ph(out.sample, gb)
    base_w = jnp.where(final_p_hat > 0.0,
                       out.w_sum / jnp.maximum(final_p_hat, 1e-30), 0.0)

    if r.spatial_mis == SpatialMis.CONSTANT_DEBIAS_Z:
        z = jnp.zeros(shape)
        for i in range(n_cand):
            occ = intersect.test_occlusion(scene, gbs[i].pos,
                                           out.sample.point, p,
                                           cfg.intersector)
            z += jnp.where(valid[i] & ~occ, 1.0, 0.0)
        corr = jnp.where((z > 0.0) & (m_count > 0.0),
                         (1.0 / jnp.maximum(z, 1e-30)) /
                         jnp.maximum(rcp_m, 1e-30), 1.0)
        w_final = corr * base_w
    elif r.spatial_mis == SpatialMis.CONSTANT_DEBIAS_CONTRIB:
        nom = jnp.zeros(shape)
        denom = jnp.zeros(shape)
        for i in range(n_cand):
            p_sel_i = jnp.where(valid[i], ph(out.sample, gbs[i]), 0.0)
            denom += p_sel_i * conf[i]
            nom = jnp.where(sel_idx == i, p_sel_i * conf[i], nom)
        contrib = jnp.where(denom > 0.0, nom / jnp.maximum(denom, 1e-30),
                            0.0)
        corr = jnp.where(m_count > 0.0,
                         contrib / jnp.maximum(rcp_m, 1e-30), 0.0)
        w_final = corr * base_w
    else:
        w_final = base_w

    out = out.replace(w=w_final)
    out = rsv.cap_confidence(out, r.confidence_cap)

    # emissive center pixels pass through (pg/ReSTIRIntegrator.cpp:318-324)
    return rsv.select(gb.is_emissive(), res_in, out)
