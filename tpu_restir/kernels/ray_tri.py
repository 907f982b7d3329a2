"""Pallas-Triton kernels: fused ray x triangle intersection (small scenes).

The XLA formulations of the Embree-replacement queries (the brute
Moller-Trumbore scan, kernels/woop.py matmuls + masked reductions) put
(rays, tris) intermediates in device memory. For the per-p_hat occlusion
queries that make ReSTIR's shading math (pg/ReSTIRIntegrator.cpp:180-211)
that traffic is most of the work. These kernels keep the whole test in
registers:

  * one ray per thread: a program owns BLOCK rays, read as eight
    channels-first rows (ox, oy, oz, dx, dy, dz, tnear, tfar) with
    coalesced masked loads, so any ray count works without padding;
  * the program loops over the triangles; each triangle's 12 Woop
    coefficients are scalar loads that every thread of the program
    shares (an L1 broadcast), ~30 flops per (ray, triangle) pair;
  * any-hit ORs into an occlusion mask and leaves the loop once every
    ray of the program is occluded; closest-hit keeps a running
    (t, u, v, tri) min in registers (reference rtcOccluded1 /
    rtcIntersect1 semantics, pg/Intersection.h:8-113).

Nothing intermediate touches device memory: the kernel reads 32 B per ray
plus the triangle table and writes 16 B (closest) or 4 B (any) per ray.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_INF = np.float32(np.inf)
_BARY_EPS = 1e-5   # watertight slack, matches kernels/woop.py
BLOCK = 128        # rays per program: one ray per thread at NUM_WARPS=4
NUM_WARPS = 4
_UNROLL = 4        # triangles per loop iteration (table padded to match)

# Test hook: run the kernels in the Pallas interpreter (CPU) so the suite
# can check them against the XLA backends without a GPU.
INTERPRET = False


def _load_rays(rays_ref, n_rays):
    pid = pl.program_id(0)
    idx = pid * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    mask = idx < n_rays
    sl = pl.ds(pid * BLOCK, BLOCK)
    ch = [plt.load(rays_ref.at[c, sl], mask=mask, other=0.0)
          for c in range(8)]
    return ch, sl, mask


def _woop_tuvok(ch, w_ref, i):
    """Triangle i's (t, u, v, ok) for the program's rays."""
    ox, oy, oz, dx, dy, dz, tn, tf = ch

    def aff(c):   # transformed origin component (row c) with translation
        return (ox * w_ref[i, 4 * c] + oy * w_ref[i, 4 * c + 1]
                + oz * w_ref[i, 4 * c + 2] + w_ref[i, 4 * c + 3])

    def lin(c):   # transformed direction component (row c)
        return (dx * w_ref[i, 4 * c] + dy * w_ref[i, 4 * c + 1]
                + dz * w_ref[i, 4 * c + 2])

    ow, dw = aff(2), lin(2)
    t = jnp.where(jnp.abs(dw) > 1e-18, -ow / dw, _INF)
    u = aff(0) + t * lin(0)
    v = aff(1) + t * lin(1)
    ok = ((u >= -_BARY_EPS) & (v >= -_BARY_EPS)
          & (u + v <= 1.0 + _BARY_EPS) & (jnp.abs(t) < _INF)
          & (t >= tn) & (t <= tf))
    return t, u, v, ok


def _any_kernel(rays_ref, w_ref, out_ref, *, n_rays, n_tris):
    ch, sl, mask = _load_rays(rays_ref, n_rays)
    # dead lanes (past the end, or tnear > tfar) count as occluded so
    # they do not hold the early exit back; their result is not stored
    # or is 0 because no triangle can pass the t test for them
    dead = (~mask) | (ch[6] > ch[7])

    def cond(carry):
        i, occ = carry
        return (i < n_tris) & (jnp.min(occ) == 0)

    def body(carry):
        i, occ = carry
        for j in range(_UNROLL):
            ok = _woop_tuvok(ch, w_ref, i + j)[3]
            occ = jnp.maximum(occ, ok.astype(jnp.int32))
        return i + _UNROLL, occ

    _, occ = jax.lax.while_loop(cond, body,
                                (jnp.int32(0), dead.astype(jnp.int32)))
    plt.store(out_ref.at[sl], jnp.where(dead, 0, occ), mask=mask)


def _closest_kernel(rays_ref, w_ref, tuv_ref, tri_ref, *, n_rays, n_tris):
    ch, sl, mask = _load_rays(rays_ref, n_rays)

    def body(k, carry):
        for j in range(_UNROLL):
            bt, bu, bv, btri = carry
            i = k * _UNROLL + j
            t, u, v, ok = _woop_tuvok(ch, w_ref, i)
            better = ok & (t < bt)
            carry = (jnp.where(better, t, bt), jnp.where(better, u, bu),
                     jnp.where(better, v, bv), jnp.where(better, i, btri))
        return carry

    init = (jnp.full((BLOCK,), _INF, jnp.float32),
            jnp.zeros((BLOCK,), jnp.float32),
            jnp.zeros((BLOCK,), jnp.float32),
            jnp.full((BLOCK,), -1, jnp.int32))
    bt, bu, bv, btri = jax.lax.fori_loop(0, n_tris // _UNROLL, body, init)
    plt.store(tuv_ref.at[0, sl], bt, mask=mask)
    plt.store(tuv_ref.at[1, sl], bu, mask=mask)
    plt.store(tuv_ref.at[2, sl], bv, mask=mask)
    plt.store(tri_ref.at[sl], btri, mask=mask)


def _pack_rays(o, d, tnear, tfar):
    """(N, 3) SoA -> (8, N) channels-first rows."""
    return jnp.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                      tnear, tfar], axis=0)


def _woop_rows(scene):
    """(T, 12) Woop rows, padded to a multiple of _UNROLL with never-hit
    rows (u/v translation inf -> the barycentric test always fails)."""
    w = scene.woop.reshape(scene.num_tris, 12)
    pad = -w.shape[0] % _UNROLL
    if pad:
        filler = jnp.zeros((pad, 12), w.dtype)
        filler = filler.at[:, 3].set(jnp.inf).at[:, 7].set(jnp.inf)
        w = jnp.concatenate([w, filler], axis=0)
    return w


def _call(kernel, name, w, o, d, tnear, tfar, out_shape):
    n = o.shape[0]
    return pl.pallas_call(
        functools.partial(kernel, n_rays=n, n_tris=w.shape[0]),
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=INTERPRET,
        name=name,
    )(_pack_rays(o, d, tnear, tfar), w)


def _any_core_impl(w, o, d, tnear, tfar):
    out = _call(_any_kernel, "ray_tri_any", w, o, d, tnear, tfar,
                jax.ShapeDtypeStruct((o.shape[0],), jnp.int32))
    return out > 0


@jax.custom_vjp
def _any_core(w, o, d, tnear, tfar):
    return _any_core_impl(w, o, d, tnear, tfar)


def _any_fwd(w, o, d, tnear, tfar):
    return _any_core_impl(w, o, d, tnear, tfar), (
        w.shape, o.shape, d.shape, tnear.shape, tfar.shape)


def _any_bwd(res, _g):
    # boolean visibility is detached (the reference estimator treats V
    # as data); cotangents are zero
    ws, os_, ds, tns, tfs = res
    return (jnp.zeros(ws), jnp.zeros(os_), jnp.zeros(ds),
            jnp.zeros(tns), jnp.zeros(tfs))


_any_core.defvjp(_any_fwd, _any_bwd)


def any_hit(scene, o, d, tnear, tfar) -> jnp.ndarray:
    """Occlusion query: True where any triangle blocks [tnear, tfar].
    Detached for autodiff."""
    return _any_core(_woop_rows(scene), o, d, tnear, tfar)


def _closest_core_impl(w, o, d, tnear, tfar):
    n = o.shape[0]
    tuv, tri = _call(_closest_kernel, "ray_tri_closest", w, o, d, tnear,
                     tfar, (jax.ShapeDtypeStruct((3, n), jnp.float32),
                            jax.ShapeDtypeStruct((n,), jnp.int32)))
    return tuv[0], tuv[1], tuv[2], tri


@jax.custom_vjp
def _closest_core(w, o, d, tnear, tfar):
    return _closest_core_impl(w, o, d, tnear, tfar)


def _closest_fwd(w, o, d, tnear, tfar):
    out = _closest_core_impl(w, o, d, tnear, tfar)
    t, _u, _v, tri = out
    return out, (w, d, t, tri, tnear.shape, tfar.shape)


def _closest_bwd(res, g):
    """Analytic d(t,u,v)/d(o,d) for the (detached) winning triangle.

    With W the winner's Woop rows (w_u, w_v, w_w | translations):
      t = -(w_w.o + c_w) / (w_w.d)
      u = (w_u.o + c_u) + t (w_u.d),   v likewise with w_v,
    so with L_x = w_x.d and a = (gt + gu L_u + gv L_v)/L_w:
      dL/do = gu w_u + gv w_v - a w_w,   dL/dd = t * dL/do.
    Geometry (w) is treated as data.
    """
    from tpu_restir import mathx

    w, d, t, tri, tns, tfs = res
    gt, gu, gv, _gtri = g
    rows = mathx.take_rows(w, jnp.maximum(tri, 0))   # (N, 12)
    wu = rows[:, 0:3]
    wv = rows[:, 4:7]
    ww = rows[:, 8:11]
    lw = jnp.sum(ww * d, axis=-1)
    lu = jnp.sum(wu * d, axis=-1)
    lv = jnp.sum(wv * d, axis=-1)
    inv_lw = jnp.where(jnp.abs(lw) > 1e-18, 1.0 / lw, 0.0)
    live = ((tri >= 0) & jnp.isfinite(t)).astype(jnp.float32)
    tt = jnp.where(jnp.isfinite(t), t, 0.0)
    a = (gu * lu + gv * lv + gt) * inv_lw * live
    go = (gu * live)[:, None] * wu + (gv * live)[:, None] * wv \
        - a[:, None] * ww
    gd = tt[:, None] * go
    return (jnp.zeros_like(w), go, gd, jnp.zeros(tns), jnp.zeros(tfs))


_closest_core.defvjp(_closest_fwd, _closest_bwd)


def closest_hit(scene, o, d, tnear, tfar):
    """Closest-hit query -> (t, u, v, tri) flat arrays (tri = -1 and
    t = inf on a miss).

    Differentiable in (o, d) via the analytic derivative of the winning
    triangle's Woop transform (the discrete winner is detached, standard
    for hit-point derivatives); scene geometry is treated as data."""
    return _closest_core(_woop_rows(scene), o, d, tnear, tfar)


def supports(scene, max_tris: int = 2048) -> bool:
    """Kernel applicability: on a GPU, Woop matrices present, small
    scene."""
    return (jax.default_backend() == "gpu" and scene.woop is not None
            and scene.num_tris <= max_tris)
