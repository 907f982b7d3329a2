"""Per-pass wall-clock profile of the ReSTIR pipeline at 1080p on one GPU.

Mirrors the reference's per-pass timers (pg/simpleguidx11.cpp:361-486)
with each pass jit-compiled on its own, device data passed as jit
arguments, and every timing ended by jax.block_until_ready. Also times
the whole step, the whole forward+backward frame, the backward pass of
each pass, and raw 2M-ray intersection queries.

    python tools/profile_passes.py [--scene cornell|terrain:N|...]
                                   [--backend auto] [--no-bwd]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_restir import compile_cache, rng  # noqa: E402
from tpu_restir.config import (CameraConfig, IntersectorConfig,  # noqa: E402
                               RenderConfig, RenderParams, RestirParams)
from tpu_restir.render import camera as cam_mod  # noqa: E402
from tpu_restir.render import intersect  # noqa: E402
from tpu_restir.render.integrators.restir import gbuffer as gb_mod  # noqa: E402
from tpu_restir.render.integrators.restir.initial import initial_pass  # noqa: E402
from tpu_restir.render.integrators.restir.pipeline import (  # noqa: E402
    init_restir_state, restir_step)
from tpu_restir.render.integrators.restir.shade import shade_pass  # noqa: E402
from tpu_restir.render.integrators.restir.spatial import spatial_pass  # noqa: E402
from tpu_restir.render.integrators.restir.temporal import temporal_pass  # noqa: E402

W, H = 1920, 1080
REPS = 3


def timeit(name, fn, *args):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{name:24s} {dt * 1e3:9.1f} ms", flush=True)
    return out, dt


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell",
                    help="cornell | terrain:N | soup:N | many-lights:N")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--no-bwd", action="store_true")
    a = ap.parse_args()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    compile_cache.enable()

    view_from, view_at = (0.0, -3.9, 1.0), (0.0, 0.0, 1.0)
    if a.scene.startswith("terrain"):
        view_from, view_at = (0.0, -7.0, 4.0), (0.0, 0.0, 0.5)
    cfg = RenderConfig(
        camera=CameraConfig(width=W, height=H, fov_y_deg=45.0,
                            view_from=view_from,
                            view_at=view_at,
                            pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_mis="pairwise"),
        intersector=IntersectorConfig(ray_chunk=1 << 18, tri_block=2048,
                                      backend=a.backend),
        integrator="restir")
    from tpu_restir.cli import load_scene
    scene = load_scene(a.scene)
    print(f"scene {a.scene}: {scene.num_tris} tris, backend "
          f"{intersect._backend(scene, cfg.intersector)}", flush=True)
    cam = cam_mod.make_camera(cfg.camera)
    seed = rng.make_frame_seed(0, 1)
    ys = jnp.broadcast_to(jnp.arange(H)[:, None], (H, W))
    xs = jnp.broadcast_to(jnp.arange(W)[None, :], (H, W))

    gb, dt_gb = timeit("gbuffer_fill", jax.jit(
        lambda s, c: gb_mod.gbuffer_fill(s, c, cfg, seed, ys, xs)),
        scene, cam)
    res, dt_in = timeit("initial_pass", jax.jit(
        lambda s, g: initial_pass(seed, s, g, cfg, ys, xs)), scene, gb)
    res_t, dt_tm = timeit("temporal_pass", jax.jit(
        lambda s, g, r: temporal_pass(seed, s, g, g, r, r, cfg, ys, xs,
                                      gb_ext=g, gb_prev_ext=g, ext_row0=0)),
        scene, gb, res)
    res_s, dt_sp = timeit("spatial_pass", jax.jit(
        lambda s, g, r: spatial_pass(seed, 0, s, g, r, cfg, ys, xs,
                                     gb_ext=g, res_ext=r, ext_row0=0)),
        scene, gb, res_t)
    _, dt_sh = timeit("shade_pass", jax.jit(
        lambda s, g, r: shade_pass(s, g, r, cfg)), scene, gb, res_s)
    print(f"{'SUM OF PASSES':24s} {(dt_gb + dt_in + dt_tm + dt_sp + dt_sh) * 1e3:9.1f} ms")

    # whole fused frame step
    state = init_restir_state(H, W)
    step = jax.jit(restir_step, static_argnames=("cfg",))
    frame, state = step(scene, cam, cfg, rng.make_frame_seed(0, 0), state,
                        jnp.asarray(0))
    jax.block_until_ready(frame)
    t0 = time.perf_counter()
    for f in range(1, REPS + 1):
        frame, state = step(scene, cam, cfg, rng.make_frame_seed(0, f),
                            state, jnp.asarray(f))
    jax.block_until_ready(frame)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{'FULL FRAME STEP':24s} {dt * 1e3:9.1f} ms")

    # ---- backward breakdown: grad of sum(pass output) w.r.t. material
    # params, per pass -------------------------------------------------
    if not a.no_bwd:
        from tpu_restir.diff.params import apply_params, extract_params

        params = extract_params(scene)

        def bwd_of(fn_of_scene):
            def loss(p, *args):
                out = fn_of_scene(apply_params(scene, p), *args)
                return jnp.sum(jax.tree.leaves(out)[0])
            return jax.jit(jax.grad(loss))

        timeit("bwd gbuffer_fill", bwd_of(
            lambda s, c: gb_mod.gbuffer_fill(s, c, cfg, seed, ys, xs)),
            params, cam)
        timeit("bwd initial_pass", bwd_of(
            lambda s, g: initial_pass(seed, s, g, cfg, ys, xs)),
            params, gb)
        timeit("bwd temporal_pass", bwd_of(
            lambda s, g, r: temporal_pass(seed, s, g, g, r, r, cfg, ys, xs,
                                          gb_ext=g, gb_prev_ext=g,
                                          ext_row0=0).w_sum),
            params, gb, res)
        timeit("bwd spatial_pass", bwd_of(
            lambda s, g, r: spatial_pass(seed, 0, s, g, r, cfg, ys, xs,
                                         gb_ext=g, res_ext=r,
                                         ext_row0=0).w_sum),
            params, gb, res_t)
        timeit("bwd shade_pass", bwd_of(
            lambda s, g, r: shade_pass(s, g, r, cfg)), params, gb, res_s)

        # whole-frame fwd+bwd
        from tpu_restir.diff.render import loss_fn

        target = jnp.zeros((H, W, 3))
        vg = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, scene, cam, cfg, (1,), target)))
        out = jax.block_until_ready(vg(params))
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = vg(params)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / REPS
        print(f"{'FULL FRAME FWD+BWD':24s} {dt * 1e3:9.1f} ms")

    # raw intersection micro-benchmarks
    n = H * W
    o = jax.random.uniform(jax.random.PRNGKey(0), (n, 3), minval=-1.0,
                           maxval=1.0)
    d = jax.random.normal(jax.random.PRNGKey(1), (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tn = jnp.zeros((n,))
    tf = jnp.full((n,), 100.0)
    _, dt = timeit("intersect_any 2.07Mray", jax.jit(
        lambda s, o, d: intersect.intersect_any(s, o, d, tn, tf,
                                                cfg.intersector)),
        scene, o, d)
    print(f"  -> {n / dt / 1e6:8.1f} Mrays/s")
    _, dt = timeit("intersect_closest", jax.jit(
        lambda s, o, d: intersect.intersect_closest(s, o, d, tn, tf,
                                                    cfg.intersector)),
        scene, o, d)
    print(f"  -> {n / dt / 1e6:8.1f} Mrays/s")


if __name__ == "__main__":
    main()
