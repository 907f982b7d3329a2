"""Progressive renderer: the host-side frame orchestrator.

Replaces the reference's SimpleGuiDX11 producer loop
(pg/simpleguidx11.cpp:223-334): per frame it renders 1 spp with the
selected integrator, lerps into the HDR accumulator with weight 1/(n+1),
and derives the display image (optional ACES tonemap + sRGB compress) and
image statistics. All per-frame device work is one jitted call; the class
only holds state pytrees (no globals, unlike the reference's statics).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir import mathx, metrics, rng
from tpu_restir.config import RenderConfig
from tpu_restir.io.export import export_image
from tpu_restir.mathx.color import aces, srgb_compress
from tpu_restir.render import camera as cam_mod
from tpu_restir.render.integrators import render_naive, render_nee


def _render_frame(scene, cam, cfg: RenderConfig, key):
    if cfg.integrator == "naive":
        return render_naive(scene, cam, cfg, key)
    if cfg.integrator == "nee":
        return render_nee(scene, cam, cfg, key)
    if cfg.integrator == "restir":
        raise RuntimeError(
            "use Renderer which threads ReSTIR state between frames")
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


@partial(jax.jit, static_argnames=("cfg",))
def _frame_simple(scene, cam, cfg: RenderConfig, key):
    """One 1-spp frame for the stateless integrators (naive / NEE)."""
    return _render_frame(scene, cam, cfg, key)


def display_image(accumulator, params):
    """HDR accumulator -> display colors (pg/simpleguidx11.cpp:262-295):
    optional ACES, then sRGB compress."""
    img = accumulator
    if params.tonemap:
        img = aces(img)
    if params.gamma_correct:
        img = srgb_compress(img)
    return jnp.clip(img, 0.0, 1.0)


class Renderer:
    """Headless progressive renderer with explicit, checkpointable state."""

    def __init__(self, scene, cfg: RenderConfig):
        self.scene = scene
        self.cfg = cfg
        self.cam = cam_mod.make_camera(cfg.camera)
        h, w = cfg.camera.height, cfg.camera.width
        self.accumulator = jnp.zeros((h, w, 3))
        # luminance second moment, same progressive lerp as the
        # accumulator; (m2 - mean^2)/n estimates the per-pixel variance
        # of the accumulated estimate — the SVGF denoiser's guide
        self.moment2 = jnp.zeros((h, w))
        # SVGF temporal history (reprojected color + moments; survives
        # accumulator resets on camera motion) — built lazily on the
        # first denoised restir frame
        self._svgf_hist = None
        self.acc_ctr = 0
        self.frame_ctr = 0
        self.render_time = 0.0
        self._time_base = 0.0
        self._t_reset = time.perf_counter()
        self.timers = metrics.PassTimers()
        self._profile_steps = None
        self._restir_state = None
        self._mesh = None
        if cfg.profile_passes and cfg.integrator != "restir":
            raise ValueError("profile_passes requires the 'restir' "
                             "integrator")
        if cfg.integrator == "restir":
            from tpu_restir.render.integrators.restir.pipeline import (
                init_restir_state, restir_step)
            self._restir_state = init_restir_state(h, w)
            if cfg.n_devices > 1:
                from tpu_restir.dist.mesh import make_mesh
                from tpu_restir.dist.sharded import (
                    device_put_replicated, device_put_row_sharded,
                    make_sharded_restir_step)
                self._mesh = make_mesh(cfg.n_devices, cfg.mesh_axis)
                self.scene = device_put_replicated(self.scene, self._mesh)
                self._restir_state = device_put_row_sharded(
                    self._restir_state, self._mesh, h)
                self._restir_step = make_sharded_restir_step(self._mesh,
                                                             cfg)
            else:
                self._restir_step = jax.jit(restir_step,
                                            static_argnames=("cfg",))

    def update_config(self, cfg: RenderConfig):
        """Swap render knobs mid-run (the reference's live ImGui edits,
        pg/simpleguidx11.cpp:161-217): the next frame compiles (or reuses)
        the new pipeline variant. Resolution/integrator/sharding are
        fixed at construction; accumulation is NOT reset (reset is an
        explicit user action in the reference too)."""
        old = self.cfg
        if (cfg.camera.width != old.camera.width
                or cfg.camera.height != old.camera.height
                or cfg.integrator != old.integrator
                or cfg.n_devices != old.n_devices):
            raise ValueError("update_config cannot change resolution, "
                             "integrator, or device count — build a new "
                             "Renderer")
        self.cfg = cfg
        self._profile_steps = None   # variants re-derive from the new cfg
        if cfg.integrator == "restir" and self._mesh is not None:
            from tpu_restir.dist.sharded import make_sharded_restir_step
            self._restir_step = make_sharded_restir_step(self._mesh, cfg)

    def set_camera(self, view_from=None, view_at=None):
        """Camera move (one-frame-latency orbit analog); accumulation is
        NOT reset automatically, matching the reference."""
        self.cam = cam_mod.make_camera(self.cfg.camera, view_from, view_at)

    def reset_accumulation(self):
        self.accumulator = jnp.zeros_like(self.accumulator)
        self.moment2 = jnp.zeros_like(self.moment2)
        self.acc_ctr = 0
        self.render_time = 0.0
        self._time_base = 0.0
        self._t_reset = time.perf_counter()

    def _sync_time(self):
        """Sync the device and refresh render_time (wall clock since the
        last reset, the reference's sidecar semantics)."""
        jax.block_until_ready(self.accumulator)
        self.render_time = self._time_base + (
            time.perf_counter() - self._t_reset)

    def step(self) -> jnp.ndarray:
        """Render one frame and fold it into the accumulator.

        Dispatch is asynchronous — the host returns while the device
        computes (the producer/consumer overlap of the reference's render
        thread, pg/simpleguidx11.cpp:497-560, without the mutex). Sync
        points are display()/stats()/export().
        """
        if self.cfg.integrator == "restir":
            fseed = rng.make_frame_seed(self.cfg.seed, self.frame_ctr)
            if self.cfg.profile_passes:
                frame, self._restir_state = self._timed_step(fseed)
            elif self.cfg.n_devices > 1:
                frame, self._restir_state = self._restir_step(
                    self.scene, self.cam, fseed, self._restir_state,
                    jnp.asarray(self.frame_ctr))
            else:
                frame, self._restir_state = self._restir_step(
                    self.scene, self.cam, self.cfg, fseed,
                    self._restir_state, jnp.asarray(self.frame_ctr))
        else:
            key = rng.frame_key(self.cfg.seed, self.frame_ctr)
            frame = _frame_simple(self.scene, self.cam, self.cfg, key)
        # progressive lerp 1/(n+1) (pg/simpleguidx11.cpp:246-253)
        self.accumulator = self.accumulator + (
            frame - self.accumulator) / (self.acc_ctr + 1.0)
        lum = mathx.luminance(frame)
        self.moment2 = self.moment2 + (
            lum * lum - self.moment2) / (self.acc_ctr + 1.0)
        if (self.cfg.params.denoise and self.cfg.params.denoiser == "svgf"
                and self._restir_state is not None):
            from tpu_restir.denoise import (empty_svgf_history,
                                            svgf_temporal_update)
            if self._svgf_hist is None:
                h, w = frame.shape[:2]
                self._svgf_hist = empty_svgf_history(h, w)
            self._svgf_hist, _c, _v = svgf_temporal_update(
                self._svgf_hist, frame, self._restir_state.gb_prev)
        self.acc_ctr += 1
        self.frame_ctr += 1
        if not self.cfg.accumulate or self.acc_ctr > self.cfg.max_acc_count:
            self.acc_ctr = 0
        return frame

    def _timed_step(self, fseed):
        """Per-pass timing of the ONE true pipeline (the reference's
        per-pass ms stats, pg/raytracer.cpp:56-75;
        pg/simpleguidx11.cpp:361-486).

        Rather than maintaining a second copy of the pass schedule (which
        drifts — round 3's copy silently lacked debug_reprojection), the
        full restir_step is compiled once per PREFIX via
        cfg.profile_stop_after; pass time = difference between adjacent
        prefix times. Works identically under row sharding."""
        cfg = self.cfg
        r_cfg = cfg.restir
        stages = ["gbuffer", "initial"]
        if r_cfg.do_visibility_pass:
            stages.append("visibility")
        if r_cfg.do_temporal_reuse:
            stages.append("temporal")
        if r_cfg.do_spatial_reuse:
            stages.append("spatial")
        stages.append("shade")  # full pipeline
        if self._profile_steps is None:
            from tpu_restir.render.integrators.restir.pipeline import (
                restir_step)
            self._profile_steps = {}
            for st in stages:
                v = cfg.replace(
                    profile_stop_after=None if st == "shade" else st)
                if self._mesh is not None:
                    from tpu_restir.dist.sharded import (
                        make_sharded_restir_step)
                    self._profile_steps[st] = (
                        v, make_sharded_restir_step(self._mesh, v))
                else:
                    from tpu_restir.render.integrators.restir.pipeline \
                        import restir_step as _rs
                    self._profile_steps[st] = (
                        v, jax.jit(_rs, static_argnames=("cfg",)))
        fc = jnp.asarray(self.frame_ctr)
        prev_t = 0.0
        out = None
        for st in stages:
            v, fn = self._profile_steps[st]
            t0 = time.perf_counter()
            if self._mesh is not None:
                out = fn(self.scene, self.cam, fseed, self._restir_state,
                         fc)
            else:
                out = fn(self.scene, self.cam, v, fseed,
                         self._restir_state, fc)
            jax.block_until_ready(out)
            cum = time.perf_counter() - t0
            self.timers.record(st, max(cum - prev_t, 0.0))
            prev_t = cum
        return out

    def run(self, n_frames: int):
        for _ in range(n_frames):
            self.step()
        self._sync_time()
        return self.accumulator

    def display(self) -> np.ndarray:
        """Accumulator -> display bytes-ready floats, following the
        reference's pipeline order: accumulate -> [denoise] -> [ACES] ->
        sRGB -> debug-pixel overlay (pg/simpleguidx11.cpp:246-295)."""
        img = self.accumulator
        params = self.cfg.params
        if params.denoise:
            if self._restir_state is None:
                # the joint-bilateral guides come from the ReSTIR G-buffer;
                # don't silently drop a requested denoise pass
                raise ValueError(
                    "denoise=True requires the 'restir' integrator (the "
                    "denoiser's guide buffers come from its G-buffer)")
            from tpu_restir.denoise import (denoise_accumulator,
                                            spatial_variance)
            from tpu_restir.mathx import luminance
            if self.acc_ctr >= 2:
                mean_l = luminance(self.accumulator)
                var = jnp.maximum(self.moment2 - mean_l * mean_l, 0.0) \
                    / self.acc_ctr
            else:
                var = None  # spatial fallback (SVGF first-frames rule)
            if self._svgf_hist is not None:
                # per-pixel: prefer the reprojected temporal history
                # where it has integrated MORE frames than the
                # accumulator (camera motion resets the accumulator;
                # the history survives via reprojection). Static-camera
                # pixels keep the plain 1/n accumulator (lower variance
                # than the EMA for long runs).
                hs = self._svgf_hist
                use_h = (hs.length > float(self.acc_ctr))[..., None]
                img = jnp.where(use_h, hs.color, img)
                var_h = jnp.where(
                    hs.length >= 4.0,
                    jnp.maximum(hs.m2 - hs.m1 * hs.m1, 0.0),
                    spatial_variance(hs.color))
                var = var_h if var is None else jnp.where(
                    use_h[..., 0], var_h, var)
            img = denoise_accumulator(img, self._restir_state.gb_prev,
                                      variance=var,
                                      method=params.denoiser)
        out = display_image(img, params)
        if params.debug_pixel is not None:
            x, y = params.debug_pixel
            out = out.at[y, x].set(jnp.asarray([1.0, 0.0, 1.0]))
        return np.asarray(out)

    def stats(self):
        self._sync_time()
        m, v = metrics.image_mean_variance(self.accumulator)
        return float(m), float(v)

    def export(self, path: str):
        mean, var = self.stats()
        export_image(
            path, self.display(), iterations=self.acc_ctr,
            restir=self.cfg.restir, render_time_s=self.render_time,
            image_mean=mean, image_variance=var,
            cam_pos=np.asarray(self.cam.pos),
            cam_view_at=np.asarray(self.cam.view_at),
            fov_deg=self.cfg.camera.fov_y_deg,
            pass_times_ms=self.timers.mean_ms() or None)
