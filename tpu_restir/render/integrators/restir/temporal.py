"""PASS 4: temporal reuse with bidirectional reprojection.

Reference: temporalReusePass + reprojectBackward/Forward
(pg/ReSTIRIntegrator.cpp:544-587, 625-732). Rejection cascade: invalid
backward reprojection -> depth-ratio < 0.9 -> invalid forward
reprojection -> forward depth-ratio < 0.9; on any rejection the current
reservoir passes through unchanged. Accepted pixels MIS-combine the
current and previous reservoirs with confidence-weighted balance
heuristic weights.

Faithful quirk (SURVEY.md §2.5): the *previous reservoir* is read at the
CURRENT pixel while the previous *G-buffer element* is read at the
reprojected pixel (pg/ReSTIRIntegrator.cpp:641 vs :652).

Sharded mode: reprojected taps read the halo-extended previous G-buffer;
coordinates are clamped into shard+halo (motion-bounded reuse,
SURVEY.md §5.7). WRS acceptance draws are PCG4D keyed by global coords.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_restir import mathx, rng
from tpu_restir.dist.halo import local_row
from tpu_restir.render import camera as cam_mod
from tpu_restir.render.integrators.restir import gbuffer as gb_mod
from tpu_restir.render.integrators.restir import packed as pk
from tpu_restir.render.integrators.restir import reservoir as rsv
from tpu_restir.render.integrators.restir.phat import evaluate_p_hat


def temporal_pass(frame_seed, scene, gb: gb_mod.GBuffer,
                  gb_prev: gb_mod.GBuffer, res_cur: rsv.Reservoir,
                  res_prev: rsv.Reservoir, cfg, ys, xs, *,
                  gb_ext=None, gb_prev_ext=None,
                  ext_row0=0, return_reasons: bool = False):
    p = cfg.params
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    gb_ext = gb if gb_ext is None else gb_ext
    gb_prev_ext = gb_prev if gb_prev_ext is None else gb_prev_ext
    ext_h = gb_prev_ext.depth.shape[0]

    # backward: current surface into the previous camera
    bx, by, valid_b = cam_mod.project_to_screen(
        gb_prev.view_mat, gb_prev.focal, w, h, gb.pos)
    bxc = jnp.clip(bx, 0, w - 1)
    byc = local_row(jnp.clip(by, 0, h - 1), ext_row0, ext_h)
    # snap irrelevant taps (invalid reprojection / miss pixels) to the
    # identity: their gathered values are masked out by `accept` or hit
    # empty reservoirs
    rel_b = valid_b & (gb.depth > 0.0)
    byc = jnp.where(rel_b, byc, local_row(ys, ext_row0, ext_h))
    bxc = jnp.where(rel_b, bxc, xs)
    slim = pk.reuse_slim(scene.materials)
    prev_elem = pk.unpack_gb(
        pk.gather_packed(pk.pack_gb(gb_prev_ext, slim), byc, bxc),
        gb_prev_ext, slim)

    cur_depth = mathx.length(gb.pos - gb.cam_pos)
    prev_depth = mathx.length(prev_elem.pos - gb_prev.cam_pos)
    ratio = jnp.minimum(cur_depth, prev_depth) / jnp.maximum(
        jnp.maximum(cur_depth, prev_depth), 1e-20)
    depth_ok = ratio >= 0.9

    # forward: last frame's surface at this pixel into the current camera
    prev_at_cur_pos = gb_prev.pos  # gb_prev at the current pixel (no gather)
    fx, fy, valid_f = cam_mod.project_to_screen(
        gb.view_mat, gb.focal, w, h, prev_at_cur_pos)
    fxc = jnp.clip(fx, 0, w - 1)
    fyc = local_row(jnp.clip(fy, 0, h - 1), ext_row0,
                    gb_ext.depth.shape[0])
    rel_f = valid_f & (gb_prev.depth > 0.0)
    fyc = jnp.where(rel_f, fyc, local_row(ys, ext_row0,
                                          gb_ext.depth.shape[0]))
    fxc = jnp.where(rel_f, fxc, xs)
    fw_elem_pos = pk.gather_packed(gb_ext.pos, fyc, fxc)
    cur_depth_p = mathx.length(prev_at_cur_pos - gb_prev.cam_pos)
    prev_depth_p = mathx.length(fw_elem_pos - gb.cam_pos)
    ratio_p = jnp.minimum(cur_depth_p, prev_depth_p) / jnp.maximum(
        jnp.maximum(cur_depth_p, prev_depth_p), 1e-20)
    depth_ok_p = ratio_p >= 0.9

    # rel_b/rel_f fold in explicitly: where a tap was snapped to the
    # identity its gathered depth ratio is meaningless, so acceptance must
    # not rest on prev reservoirs happening to be empty for such pixels
    accept = rel_b & depth_ok & rel_f & depth_ok_p

    # --- confidence-weighted MIS combine (pg/ReSTIRIntegrator.cpp:694-731)
    cur_s = res_cur.sample
    prev_s = res_prev.sample
    conf_c = res_cur.confidence
    conf_p = res_prev.confidence

    def ph(sample, surf):
        return evaluate_p_hat(sample, scene, surf, True, p, cfg.intersector)

    p_cur_cs = ph(cur_s, gb)          # current sample at current surface
    p_prev_cs = ph(cur_s, prev_elem)  # current sample at previous surface
    denom_c = p_cur_cs * conf_c + p_prev_cs * conf_p
    m_cur = jnp.where(denom_c > 0.0,
                      p_cur_cs * conf_c / jnp.maximum(denom_c, 1e-30), 0.0)

    p_cur_ps = ph(prev_s, gb)
    p_prev_ps = ph(prev_s, prev_elem)
    denom_p = p_cur_ps * conf_c + p_prev_ps * conf_p
    m_prev = jnp.where(denom_p > 0.0,
                       p_prev_ps * conf_p / jnp.maximum(denom_p, 1e-30), 0.0)

    out = rsv.empty_reservoir(gb.depth.shape)
    u1 = rng.pixel_uniform(frame_seed, rng.stream_id(rng.PASS_TEMPORAL, 0),
                           ys, xs)
    u2 = rng.pixel_uniform(frame_seed, rng.stream_id(rng.PASS_TEMPORAL, 1),
                           ys, xs)
    out, _ = rsv.add_sample_u(out, u1, cur_s, m_cur * p_cur_cs * res_cur.w,
                              conf_c)
    out, _ = rsv.add_sample_u(out, u2, prev_s, m_prev * p_cur_ps * res_prev.w,
                              conf_p)
    out = rsv.cap_confidence(out, r.confidence_cap)

    final_p_hat = ph(out.sample, gb)
    out = out.replace(w=jnp.where(
        final_p_hat > 0.0, out.w_sum / jnp.maximum(final_p_hat, 1e-30), 0.0))

    result = rsv.select(accept, out, res_cur)
    if not return_reasons:
        return result
    # rejection reason in cascade order (for the debugReprojection view,
    # pg/ReSTIRIntegrator.cpp:644-689): 0 accepted, 1 invalid backward
    # reprojection, 2 depth rejection, 3 invalid forward reprojection,
    # 4 forward depth rejection
    reasons = jnp.where(
        ~rel_b, 1, jnp.where(~depth_ok, 2, jnp.where(
            ~rel_f, 3, jnp.where(~depth_ok_p, 4, 0)))).astype(jnp.int32)
    return result, reasons
