"""Scaling-efficiency measurement: 1-device vs N-virtual-device walltime
for the row-sharded ReSTIR step (BASELINE.json metric "scaling eff 1->N
hosts").

Runs on a virtual CPU mesh (no multi-chip hardware in this environment),
so it measures the *overhead* the sharded program adds — halo exchange,
collective scheduling, shard_map partitioning — not real multi-GPU speedup:
all N virtual devices share the same host cores, so total compute is
constant and the ideal sharded walltime equals the single-device
walltime. Efficiency := t_1 / t_N (1.0 = sharding adds nothing).

Prints one JSON line:
  {"n_devices", "res", "frames", "t1_ms", "tN_ms", "overhead_pct",
   "scaling_eff", "halo_rows", "halo_bytes_per_frame_per_device"}

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           python tools/scaling_bench.py [--res 256] [--frames 8]
(the script sets both itself when run directly).
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def measure(res: int = 256, frames: int = 8, n_devices: int = 8,
            radius: float = 4.0):
    import jax
    import jax.numpy as jnp

    from tpu_restir import rng
    from tpu_restir.config import (CameraConfig, RenderConfig, RenderParams,
                                   RestirParams)
    from tpu_restir.dist.halo import halo_width
    from tpu_restir.dist.mesh import make_mesh
    from tpu_restir.dist.sharded import (device_put_replicated,
                                         device_put_row_sharded,
                                         make_sharded_restir_step)
    from tpu_restir.render import camera as cam_mod
    from tpu_restir.render.integrators.restir.pipeline import (
        init_restir_state, restir_step)
    from tpu_restir.scene import cornell_box

    scene = cornell_box()
    ccfg = CameraConfig(width=res, height=res, fov_y_deg=45.0,
                        view_from=(0, -3.9, 1.0), view_at=(0, 0, 1.0),
                        pixel_sampler="random")
    cfg = RenderConfig(camera=ccfg, params=RenderParams(use_skybox=False),
                       restir=RestirParams(
                           m_area=1, m_brdf=1, do_temporal_reuse=True,
                           do_spatial_reuse=True, spatial_neighbor_count=5,
                           spatial_reuse_radius=radius,
                           spatial_mis="pairwise"),
                       integrator="restir")
    cam = cam_mod.make_camera(ccfg)

    def run(step, state, scene_, cam_, n):
        # warmup/compile
        fr, st = step(scene_, cam_, rng.make_frame_seed(0, 0), state,
                      jnp.asarray(0))
        jax.block_until_ready(fr)
        t0 = time.perf_counter()
        for f in range(1, n + 1):
            fr, st = step(scene_, cam_, rng.make_frame_seed(0, f), st,
                          jnp.asarray(f))
        jax.block_until_ready(fr)
        return (time.perf_counter() - t0) / n

    # single device
    step1 = jax.jit(lambda sc, cm, seed, st, fc: restir_step(
        sc, cm, cfg, seed, st, fc))
    t1 = run(step1, init_restir_state(res, res), scene, cam, frames)

    # N virtual devices, row-sharded
    mesh = make_mesh(n_devices)
    stepn = make_sharded_restir_step(mesh, cfg)
    stn = device_put_row_sharded(init_restir_state(res, res), mesh, res)
    tn = run(stepn, stn, device_put_replicated(scene, mesh),
             device_put_replicated(cam, mesh), frames)

    halo = halo_width(radius)
    return {
        "n_devices": n_devices,
        "res": res,
        "frames": frames,
        "t1_ms": round(t1 * 1e3, 2),
        "tN_ms": round(tn * 1e3, 2),
        "overhead_pct": round((tn / t1 - 1.0) * 100.0, 1),
        "scaling_eff": round(t1 / tn, 3),
        "halo_rows": halo,
        # reuse payload = 32 packed f32 channels (restir/packed.py);
        # `halo` rows exchanged with each of 2 neighbors, both directions
        "halo_bytes_per_frame_per_device": 2 * 2 * halo * res * 32 * 4,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()
    from tpu_restir import compile_cache

    compile_cache.enable()
    print(json.dumps(measure(args.res, args.frames, args.devices)))
