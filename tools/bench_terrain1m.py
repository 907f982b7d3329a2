"""1M-triangle scale run: full 1080p spatiotemporal ReSTIR frames on the
procedural terrain at ~1e6 triangles through the auto backend (reference
Embree commits full room-scale OBJ scenes, pg/Scene.cpp:15).

    python tools/bench_terrain1m.py

Prints the device, compile seconds, then ONE line
"TERRAIN1M <mrays> rpp <rpp>".
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_restir import compile_cache, rng  # noqa: E402
from tpu_restir.config import (CameraConfig, RenderConfig,  # noqa: E402
                               RenderParams, RestirParams)
from tpu_restir.render import camera as cam_mod  # noqa: E402
from tpu_restir.render import intersect as intersect_mod  # noqa: E402
from tpu_restir.render.integrators.restir.pipeline import (  # noqa: E402
    init_restir_state, restir_step)
from tpu_restir.scene.procedural import terrain_scene  # noqa: E402

WIDTH, HEIGHT = 1920, 1080


def main(n_frames: int = 2):
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    compile_cache.enable()
    scene = terrain_scene(1_000_000)
    cfg = RenderConfig(
        camera=CameraConfig(width=WIDTH, height=HEIGHT, fov_y_deg=45.0,
                            view_from=(0.0, -7.0, 4.0),
                            view_at=(0.0, 0.0, 0.5),
                            pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_mis="pairwise"),
        integrator="restir")
    cam = cam_mod.make_camera(cfg.camera)
    state = init_restir_state(HEIGHT, WIDTH)
    step = jax.jit(restir_step, static_argnames=("cfg",))

    intersect_mod.QUERY_LOG = qlog = []
    t0 = time.perf_counter()
    frame, state = step(scene, cam, cfg, rng.make_frame_seed(0, 0), state,
                        jnp.asarray(0))
    jax.block_until_ready(frame)
    intersect_mod.QUERY_LOG = None
    print(f"backend {intersect_mod._backend(scene, cfg.intersector)}, "
          f"compile+first frame {time.perf_counter() - t0:.2f} s", flush=True)
    rays_frame = sum(e["rays"] for e in qlog)

    t0 = time.perf_counter()
    for f in range(1, n_frames + 1):
        frame, state = step(scene, cam, cfg, rng.make_frame_seed(0, f),
                            state, jnp.asarray(f))
    jax.block_until_ready(frame)
    dt = time.perf_counter() - t0
    mrays = rays_frame * n_frames / dt / 1e6
    print(f"TERRAIN1M {mrays:.1f} rpp "
          f"{rays_frame / float(WIDTH * HEIGHT):.1f}", flush=True)


if __name__ == "__main__":
    main()
