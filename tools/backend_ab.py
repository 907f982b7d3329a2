"""A/B of intersection backends, end to end at 1080p, on one GPU.

    python tools/backend_ab.py cornell [--fwd-bwd]
        One process: the flagship Cornell ReSTIR step compiled once per
        backend (fused Triton kernel, woop_mxu, brute), then timed in
        turns (A B C A B C ...), so every backend sees the same card
        state. --fwd-bwd also times value_and_grad of the pixel loss for
        the fused and woop_mxu backends, and the spatial/temporal gather
        plus its scatter-add transpose alone at the frame's shapes.
    python tools/backend_ab.py scenes [--frames N]
        lights1k and terrain100k with each large-scene backend (bvh,
        cluster, fcluster, and the fused kernel on lights1k), in one
        process. All programs compile concurrently; each is logged as
        it finishes and then runs 1 + N frames here, one line per frame,
        so a run cut by a time limit still shows how far each got.

Every result line names the device; the card's name and power limit come
from nvidia-smi. Needs a GPU: exits non-zero without one.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

W, H = cs.WIDTH, cs.HEIGHT


def _device() -> str:
    import jax

    from tpu_restir import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (platform {dev.platform!r})")
    compile_cache.enable()
    return f"{dev.device_kind} x{len(jax.devices())}"


def _step_runner(scene, cfg, label):
    """Compiled restir_step for cfg -> (run(n) -> ms per frame, compile s)."""
    import jax
    import jax.numpy as jnp

    from tpu_restir import rng
    from tpu_restir.render import camera as cam_mod
    from tpu_restir.render.integrators.restir.pipeline import (
        init_restir_state, restir_step)

    cam = cam_mod.make_camera(cfg.camera)
    st = [init_restir_state(cfg.camera.height, cfg.camera.width)]
    step = jax.jit(restir_step, static_argnames=("cfg",))
    compiled, secs = cs.compile_logged(label, step, scene, cam, cfg,
                                       rng.make_frame_seed(0, 0), st[0],
                                       jnp.asarray(0))
    ctr = [0]

    def run(n):
        jax.block_until_ready(st[0])
        t0 = time.perf_counter()
        for _ in range(n):
            frame, st[0] = compiled(scene, cam,
                                    rng.make_frame_seed(0, ctr[0]), st[0],
                                    jnp.asarray(ctr[0]))
            ctr[0] += 1
        jax.block_until_ready(frame)
        return (time.perf_counter() - t0) * 1e3 / n

    run(1)
    return run, secs


def cornell(fwd_bwd: bool) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_restir.scene import cornell_box

    dev = _device()
    scene = cornell_box()
    backends = ("fused", "woop_mxu", "brute")
    runs = {b: _step_runner(scene, cs.flagship_config(W, H, b), f"fwd/{b}")
            for b in backends}
    times = {b: [] for b in backends}
    for _ in range(4):
        for b in backends:
            times[b].append(runs[b][0](4))
    for b in backends:
        print(f"AB cornell fwd {b}: compile {runs[b][1]:.2f} s, frame ms "
              f"{times[b]} ({dev})", flush=True)
    if not fwd_bwd:
        return

    from tpu_restir.diff.params import extract_params
    from tpu_restir.diff.render import make_value_and_grad
    from tpu_restir.render import camera as cam_mod

    params = extract_params(scene)
    target = jnp.zeros((H, W, 3))
    vgs = {}
    for b in ("fused", "woop_mxu"):
        cfg = cs.flagship_config(W, H, b)
        vg = make_value_and_grad(scene, cam_mod.make_camera(cfg.camera), cfg,
                                 (1,), target)
        vgs[b] = cs.compile_logged(f"fwd+bwd/{b}", vg, params)
    ms = {b: [] for b in vgs}
    for _ in range(3):
        for b, (c, _s) in vgs.items():
            ms[b].append(cs.time_ms(c, params, reps=2))
    for b in vgs:
        print(f"AB cornell fwd+bwd {b}: compile {vgs[b][1]:.2f} s, ms "
              f"{ms[b]} ({dev})", flush=True)
    gather_alone(dev)


def gather_alone(dev: str) -> None:
    """The reuse gathers of one flagship frame and their scatter-add
    transposes, alone at the frame's shapes: the spatial pass's 5 taps of
    the 24-channel payload and the temporal pass's two reprojection taps
    (12-channel G-buffer payload, 3-channel position)."""
    import jax
    import jax.numpy as jnp

    from tpu_restir.render.integrators.restir import packed as pk

    key = jax.random.PRNGKey(0)
    shapes = [(5, 24), (1, 12), (1, 3)]

    def loss(payloads, ys, xs):
        return sum(jnp.sum(pk.gather_packed(p, ys[:k], xs[:k]))
                   for p, (k, _c) in zip(payloads, shapes))

    payloads = [jax.random.uniform(key, (H, W, c)) for _k, c in shapes]
    ys = jax.random.randint(key, (5, H, W), 0, H)
    xs = jax.random.randint(key, (5, H, W), 0, W)
    fwd = jax.jit(loss)
    both = jax.jit(jax.grad(loss))
    print(f"AB gather fwd {cs.time_ms(fwd, payloads, ys, xs):.3f} ms, "
          f"fwd+scatter-add {cs.time_ms(both, payloads, ys, xs):.3f} ms "
          f"({dev})", flush=True)


SCENE_BACKENDS = {"lights1k": ("bvh", "fused", "cluster", "fcluster"),
                  "terrain100k": ("bvh", "fcluster", "cluster")}


def scenes(n_frames: int) -> None:
    from concurrent.futures import ThreadPoolExecutor, as_completed

    import jax
    import jax.numpy as jnp

    from tpu_restir import rng
    from tpu_restir.config import replace
    from tpu_restir.render import camera as cam_mod
    from tpu_restir.render.integrators.restir.pipeline import (
        init_restir_state, restir_step)

    dev = _device()
    step = jax.jit(restir_step, static_argnames=("cfg",))
    jobs = []
    for label, make, cfg in cs.secondary_scenes(W, H):
        scene = make()
        cam = cam_mod.make_camera(cfg.camera)
        for b in SCENE_BACKENDS[label]:
            c = cfg.replace(intersector=replace(
                cfg.intersector, backend=b, fused_max_tris=1 << 30))
            st = init_restir_state(H, W)
            jobs.append((f"{label}/{b}", scene, cam, c, st, step.lower(
                scene, cam, c, rng.make_frame_seed(0, 0), st,
                jnp.asarray(0))))
    cs.log(f"{len(jobs)} programs lowered; compiling concurrently")

    def compile_one(job):
        t0 = time.perf_counter()
        return job, job[-1].compile(), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        for fut in as_completed([ex.submit(compile_one, j) for j in jobs]):
            (label, scene, cam, c, st, _low), compiled, secs = fut.result()
            cs.log(f"AB {label}: compile {secs:.2f} s ({dev})")
            ms = []
            for f in range(1 + n_frames):
                t0 = time.perf_counter()
                frame, st = compiled(scene, cam, rng.make_frame_seed(0, f),
                                     st, jnp.asarray(f))
                jax.block_until_ready(frame)
                ms.append((time.perf_counter() - t0) * 1e3)
                cs.log(f"AB {label}: frame {f} {ms[-1]:.3f} ms")
            cs.log(f"AB {label}: compile {secs:.2f} s, frame ms "
                   f"{ms[1:]} after a first frame of {ms[0]:.3f} ms "
                   f"({dev})")


def main(argv) -> int:
    print("nvidia-smi:", cs.card_info(), flush=True)
    if argv[0] == "cornell":
        cornell("--fwd-bwd" in argv)
    elif argv[0] == "scenes":
        scenes(int(argv[argv.index("--frames") + 1])
               if "--frames" in argv else 3)
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
