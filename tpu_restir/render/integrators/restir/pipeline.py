"""ReSTIR frame pipeline: the pass schedule with explicit state threading.

Reference: produceRestir (pg/simpleguidx11.cpp:359-487). Where the
reference owns reservoir ping-pong buffers and last-frame copies as
static globals (pg/simpleguidx11.h:49-66), here the whole inter-frame
state is a RestirState pytree returned from each step — the functional
ping-pong. Pass order: G-buffer fill -> initial candidates ->
[visibility] -> [temporal] -> [spatial x N] -> shade.

The same pass code runs single-chip and row-sharded: in sharded mode
(axis_name set, called inside shard_map) each device renders its row
slice, exchanging reservoir/G-buffer halos before reuse passes
(tpu_restir.dist). All randomness is PCG4D keyed by global pixel coords,
so both modes are bit-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_restir import rng, struct
from tpu_restir.dist import halo as halo_mod
from tpu_restir.render.integrators.restir import gbuffer as gb_mod
from tpu_restir.render.integrators.restir import reservoir as rsv
from tpu_restir.render.integrators.restir.initial import (initial_pass,
                                                          visibility_pass)
from tpu_restir.render.integrators.restir.shade import shade_pass
from tpu_restir.render.integrators.restir.spatial import spatial_pass
from tpu_restir.render.integrators.restir.temporal import temporal_pass


class RestirState(struct.PyTreeNode):
    """Inter-frame state: last frame's final reservoirs + G-buffer
    (the reference's reservoirsLastFrame / gBufferLastFrame,
    pg/simpleguidx11.cpp:478-481)."""

    res_prev: rsv.Reservoir
    gb_prev: gb_mod.GBuffer


def init_restir_state(h: int, w: int) -> RestirState:
    return RestirState(res_prev=rsv.empty_reservoir((h, w)),
                       gb_prev=gb_mod.empty_gbuffer(h, w))


def restir_step(scene, cam, cfg, frame_seed, state: RestirState, frame_ctr,
                *, axis_name=None, n_devices: int = 1):
    """One ReSTIR frame. Returns (radiance image, new state).

    frame_seed: uint32 from rng.make_frame_seed(cfg.seed, frame).
    axis_name/n_devices: set when called inside shard_map over row tiles.
    """
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    local_h = state.res_prev.w_sum.shape[0]

    if axis_name is not None:
        row0 = jax.lax.axis_index(axis_name) * local_h
        halo = halo_mod.halo_width(r.spatial_reuse_radius)
        # reuse taps bounded by the halo fit in neighbor shards; tiny
        # shards fall back to an all-gather of the row axis (exact)
        use_gather = halo > local_h
        ext_row0 = 0 if use_gather else row0 - halo
    else:
        row0 = 0
        halo = 0
        use_gather = False
        ext_row0 = 0
    ys = jnp.arange(local_h)[:, None] + row0
    ys = jnp.broadcast_to(ys, (local_h, w))
    xs = jnp.broadcast_to(jnp.arange(w)[None, :], (local_h, w))

    def extend(tree):
        if axis_name is None:
            return tree

        def ext_fields(sub):
            if use_gather:
                return halo_mod.gather_rows(sub, axis_name)
            return halo_mod.extend_rows(sub, halo, axis_name, n_devices)

        if isinstance(tree, gb_mod.GBuffer):
            # extend pixel fields only; the camera snapshot is replicated
            ext = ext_fields(
                dict(pos=tree.pos, normal=tree.normal, diffuse=tree.diffuse,
                     specular=tree.specular, emission=tree.emission,
                     shininess=tree.shininess, depth=tree.depth,
                     mat_type=tree.mat_type, inv_i_m=tree.inv_i_m))
            return gb_mod.GBuffer(**ext, cam_pos=tree.cam_pos,
                                  view_mat=tree.view_mat, focal=tree.focal)
        return ext_fields(tree)

    def early(res_now, gb_now):
        """profile_stop_after cut: keep output/state structure so the
        prefix-timed variants (Renderer profiling mode) jit-compile with
        the same signature as the full step."""
        frame0 = jnp.zeros(gb_now.depth.shape + (3,))
        return frame0, RestirState(res_prev=res_now, gb_prev=gb_now)

    stop = cfg.profile_stop_after
    gb = gb_mod.gbuffer_fill(scene, cam, cfg, frame_seed, ys, xs)
    if stop == "gbuffer":
        return early(rsv.empty_reservoir(gb.depth.shape), gb)
    res = initial_pass(frame_seed, scene, gb, cfg, ys, xs)
    if stop == "initial":
        return early(res, gb)

    if r.do_visibility_pass:
        res = visibility_pass(scene, gb, res, cfg)
    if stop == "visibility":
        return early(res, gb)

    gb_ext = extend(gb) if (r.do_temporal_reuse or r.do_spatial_reuse) \
        else gb

    reasons = None
    if r.do_temporal_reuse:
        res_t = temporal_pass(frame_seed, scene, gb, state.gb_prev, res,
                              state.res_prev, cfg, ys, xs,
                              gb_ext=gb_ext, gb_prev_ext=extend(state.gb_prev),
                              ext_row0=ext_row0,
                              return_reasons=r.debug_reprojection)
        if r.debug_reprojection:
            res_t, reasons = res_t
        # no temporal reuse on the very first frame (frameCtr > 0 gate,
        # pg/simpleguidx11.cpp:408)
        res = rsv.select(jnp.broadcast_to(frame_ctr > 0, res.w_sum.shape),
                         res_t, res)
    if stop == "temporal":
        return early(res, gb)

    if r.do_spatial_reuse:
        for i in range(r.spatial_pass_count):
            res = spatial_pass(frame_seed, i, scene, gb, res, cfg, ys, xs,
                               gb_ext=gb_ext, res_ext=extend(res),
                               ext_row0=ext_row0)
    if stop == "spatial":
        return early(res, gb)

    frame = shade_pass(scene, gb, res, cfg)
    if reasons is not None:
        # paint temporal-rejection reasons into the frame (the reference
        # writes {100,*,*} into the emission buffer, which the display
        # shows directly: pg/ReSTIRIntegrator.cpp:647-689; reason 4 is
        # painted at the current pixel rather than the reference's
        # scattered reprojected pixel)
        colors = jnp.asarray([[0.0, 0.0, 0.0],       # accepted: untouched
                              [100.0, 100.0, 0.0],   # invalid backward
                              [0.0, 100.0, 0.0],     # depth rejection
                              [100.0, 0.0, 100.0],   # invalid forward
                              [0.0, 0.0, 100.0]])    # forward depth
        painted = (reasons > 0) & jnp.broadcast_to(frame_ctr > 0,
                                                   reasons.shape)
        frame = jnp.where(painted[..., None], colors[reasons], frame)
    return frame, RestirState(res_prev=res, gb_prev=gb)


def render_restir_frames(scene, cam, cfg, seed: int, n_frames: int):
    """Convenience: run n frames from a fresh state, return the
    accumulated HDR image (used by tests/benchmarks)."""
    h, w = cfg.camera.height, cfg.camera.width
    state = init_restir_state(h, w)
    step = jax.jit(restir_step, static_argnames=("cfg",))
    acc = jnp.zeros((h, w, 3))
    for f in range(n_frames):
        frame, state = step(scene, cam, cfg, rng.make_frame_seed(seed, f),
                            state, jnp.asarray(f))
        acc = acc + (frame - acc) / (f + 1.0)
    return acc
