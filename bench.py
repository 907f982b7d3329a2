"""Benchmark: Mrays/s for the full ReSTIR pipeline at 1080p on one GPU.

One process on one card; fails without a GPU. Earlier lines name the
device (platform, device_kind, count; the card's name and power limit
from nvidia-smi); the last line is ONE JSON object
{"metric", "value", "unit", "vs_baseline"}.
Baseline: the reference CPU renderer sustains ~2 Mrays/s
(BASELINE.md "derived throughput": 1280x720 MIS 1spp at 0.946 s/frame,
>=2 rays per pixel sample). Ray counting mirrors the reference's
rtcIntersect1/rtcOccluded1 call sites: every closest-hit or occlusion
query counts as one ray.
"""

import json
import time

import jax
import jax.numpy as jnp

from chip_smoke import card_info, flagship_config, secondary_scenes
from tpu_restir import compile_cache, rng
from tpu_restir.config import RenderConfig
from tpu_restir.diff.params import extract_params
from tpu_restir.diff.render import loss_fn
from tpu_restir.render import camera as cam_mod
from tpu_restir.render import intersect as intersect_mod
from tpu_restir.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)
from tpu_restir.scene import cornell_box

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = 8


def rays_per_pixel(cfg: RenderConfig) -> int:
    """Closest-hit + occlusion queries per pixel per frame for this config
    (matches the reference's per-pass trace counts, SURVEY.md §3.2)."""
    r = cfg.restir
    test_vis = 0 if r.do_visibility_pass else 1
    closest = 1 + r.m_brdf                      # G-buffer + BRDF candidates
    occl = (r.m_area + r.m_brdf + 1) * test_vis  # initial p_hats + finalize
    occl += 1 if r.do_visibility_pass else 0
    if r.do_temporal_reuse:
        occl += 5                                # 4 MIS p_hats + finalize
    if r.do_spatial_reuse:
        k = r.spatial_neighbor_count
        if r.spatial_mis == "balance":
            per_pass = (k + 1) ** 2 + 1
        elif r.spatial_mis == "pairwise":
            per_pass = 3 * k + 2
        else:
            per_pass = (k + 1) + 1
        occl += per_pass * r.spatial_pass_count
    occl += 1                                    # final shading visibility
    return closest + occl


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    compile_cache.enable()
    print(f"device: platform {dev.platform}, kind {dev.device_kind}, "
          f"count {len(jax.devices())}", flush=True)
    print(f"nvidia-smi: {card_info()}", flush=True)

    cfg = flagship_config(WIDTH, HEIGHT)
    scene = cornell_box()
    cam = cam_mod.make_camera(cfg.camera)
    state = init_restir_state(HEIGHT, WIDTH)
    step = jax.jit(restir_step, static_argnames=("cfg",))

    # warmup / compile. The instrumented query log records every traced
    # intersection query's ray count — the measured rays/frame that
    # cross-checks the analytic rays_per_pixel model
    # (tpu_restir.roofline.summarize_query_log).
    intersect_mod.QUERY_LOG = qlog = []
    t0 = time.perf_counter()
    frame, state = step(scene, cam, cfg, rng.make_frame_seed(0, 0), state,
                        jnp.asarray(0))
    jax.block_until_ready(frame)
    intersect_mod.QUERY_LOG = None
    print(f"cornell compile+first frame {time.perf_counter() - t0:.2f} s",
          flush=True)
    traced_rays = sum(e["rays"] for e in qlog)
    traced_rpp = traced_rays / float(WIDTH * HEIGHT)

    t0 = time.perf_counter()
    for f in range(1, N_FRAMES + 1):
        frame, state = step(scene, cam, cfg, rng.make_frame_seed(0, f),
                            state, jnp.asarray(f))
    jax.block_until_ready(frame)
    dt = time.perf_counter() - t0

    # throughput on the TRACED ray count (exact); the analytic
    # rays_per_pixel(cfg) stays as the cross-check in the unit string
    rays_frame = traced_rays
    mrays_fwd = rays_frame * N_FRAMES / dt / 1e6

    # --- fwd+bwd: value_and_grad of a pixel loss w.r.t. material params
    # through one full ReSTIR frame
    params = extract_params(scene)
    target = jnp.zeros((HEIGHT, WIDTH, 3))
    vg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, scene, cam, cfg, (1,), target)))
    jax.block_until_ready(vg(params))
    n_bwd = 3
    t0 = time.perf_counter()
    for _ in range(n_bwd):
        out = vg(params)
    jax.block_until_ready(out)
    dt_bwd = (time.perf_counter() - t0) / n_bwd
    mrays_fwd_bwd = rays_frame / dt_bwd / 1e6

    # --- secondary scenes (BASELINE.json config 3 many-lights; a
    # 100k-triangle terrain)
    extras = []
    for label, make, scfg in secondary_scenes(WIDTH, HEIGHT):
        sc = make()
        cam2 = cam_mod.make_camera(scfg.camera)
        st = init_restir_state(HEIGHT, WIDTH)
        intersect_mod.QUERY_LOG = qlog2 = []
        frame, st = step(sc, cam2, scfg, rng.make_frame_seed(0, 0), st,
                         jnp.asarray(0))
        jax.block_until_ready(frame)
        intersect_mod.QUERY_LOG = None
        rays_frame2 = sum(e["rays"] for e in qlog2)
        n_frames = 4
        t0 = time.perf_counter()
        for f in range(1, n_frames + 1):
            frame, st = step(sc, cam2, scfg, rng.make_frame_seed(0, f), st,
                             jnp.asarray(f))
        jax.block_until_ready(frame)
        dt2 = time.perf_counter() - t0
        extras.append(
            f"{label} {rays_frame2 * n_frames / dt2 / 1e6:.1f}"
            f" (rpp {rays_frame2 / float(WIDTH * HEIGHT):.1f})")

    baseline_mrays = 2.0  # reference CPU fwd (BASELINE.md derived throughput)
    print(json.dumps({
        "metric": "restir_1080p_mrays_per_s_fwd_bwd",
        "value": round(mrays_fwd_bwd, 2),
        "unit": ("Mrays/s (fwd " + str(round(mrays_fwd, 1))
                 + "; " + "; ".join(extras)
                 + f"; rpp {traced_rpp:.1f} traced/"
                 + f"{rays_per_pixel(cfg)} analytic)"),
        "vs_baseline": round(mrays_fwd_bwd / baseline_mrays, 2),
    }))


if __name__ == "__main__":
    main()
