"""Denoiser: edge-preserving joint-bilateral filter on G-buffer features.

Replacement for the reference's OIDN integration
(pg/simpleguidx11.cpp:52-75, 255-260), which feeds color + albedo +
normal into a learned filter. Here the same feature buffers (the ReSTIR
G-buffer's diffuse and worldNormal, plus depth) guide a vectorized
cross-bilateral kernel — pure stencil math that XLA fuses into a single
dense op, no host roundtrip. Applied to the HDR accumulator before
tonemapping, exactly where OIDN sits in the display pipeline.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from tpu_restir import struct


@partial(jax.jit, static_argnames=("radius",))
def joint_bilateral(color, albedo, normal, depth, *, radius: int = 3,
                    sigma_space: float = 2.0, sigma_albedo: float = 0.15,
                    sigma_normal: float = 0.25, sigma_depth: float = 0.5):
    """color (H,W,3) guided by albedo (H,W,3), normal (H,W,3), depth (H,W)."""
    h, w = depth.shape
    acc = jnp.zeros_like(color)
    wacc = jnp.zeros(depth.shape)

    def shifted(x, dy, dx):
        return jnp.roll(x, (-dy, -dx), axis=(0, 1))

    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w_s = jnp.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2))
            a = shifted(albedo, dy, dx)
            n = shifted(normal, dy, dx)
            z = shifted(depth, dy, dx)
            c = shifted(color, dy, dx)
            w_a = jnp.exp(-jnp.sum((a - albedo) ** 2, -1)
                          / (2 * sigma_albedo ** 2))
            w_n = jnp.exp(-jnp.sum((n - normal) ** 2, -1)
                          / (2 * sigma_normal ** 2))
            w_z = jnp.exp(-(z - depth) ** 2 / (2 * sigma_depth ** 2))
            wgt = w_s * w_a * w_n * w_z
            acc += c * wgt[..., None]
            wacc += wgt
    return acc / jnp.maximum(wacc, 1e-8)[..., None]


def _luminance(c):
    return (0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2])


@partial(jax.jit, static_argnames=("iterations",))
def svgf_denoise(color, albedo, normal, depth, variance, exclude=None, *,
                 iterations: int = 5, sigma_l: float = 4.0,
                 sigma_z: float = 1.0, sigma_n: float = 128.0,
                 sigma_a: float = 0.2):
    """SVGF-style edge-avoiding à-trous wavelet filter with variance
    guidance (Schied et al. 2017), the capability-parity replacement for
    OIDN's learned HDR filter (pg/simpleguidx11.cpp:52-75): `iterations`
    passes of a 5x5 B3-spline stencil at dilation 2^i, with per-tap
    weights from depth, normal, albedo, and a LUMINANCE weight scaled by
    the per-pixel noise standard deviation — strong smoothing where the
    estimator is noisy, edge-stopping where it is converged. The variance
    image is filtered alongside the color with squared weights, so later
    iterations see the reduced residual variance.

    color (H,W,3) HDR; albedo/normal (H,W,3); depth (H,W);
    variance (H,W) = luminance variance of the color ESTIMATE (the
    renderer's accumulated second moment / sample count).
    """
    k1 = jnp.asarray([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16])
    h, w = depth.shape

    def shifted(x, dy, dx):
        return jnp.roll(x, (-dy, -dx), axis=(0, 1))

    yi = jnp.arange(h)[:, None]
    xi = jnp.arange(w)[None, :]

    def inside(dy, dx):
        # roll wraps; off-image taps must get zero weight
        return ((yi + dy >= 0) & (yi + dy < h)
                & (xi + dx >= 0) & (xi + dx < w)).astype(jnp.float32)

    keepf = (jnp.zeros((h, w)) if exclude is None
             else exclude.astype(jnp.float32))

    # filter in a Reinhard-compressed domain: y = c/(1+L), s = 1/(1+L),
    # output Sum(w y)/Sum(w s) — a luminance-damped weighted mean that
    # bounds how far HDR outliers (fireflies, near-light splash) can
    # bleed; variance is scaled into the same domain
    lum0 = _luminance(color)
    sc = 1.0 / (1.0 + lum0)

    # cap the dilation so the widest stencil still fits the image
    # (5 levels is the 1080p setting; tiny test images use fewer)
    iters = min(iterations,
                max(1, int(np.log2(max(min(h, w) // 10, 2))) + 1))

    c = color * sc[..., None]
    sw = sc
    # Var(sc * L) = sc^2 Var(L): luminance variance transforms with the
    # square of the compression scale (an extra sc^2 over-shrank sigma_l
    # at bright pixels — exactly where fireflies need smoothing)
    var = jnp.maximum(variance, 0.0) * sc ** 2
    for it in range(iters):
        s = 1 << it
        # 3x3 prefilter of the variance -> stable sigma for w_l
        vg = jnp.zeros_like(var)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                vg = vg + shifted(var, dy, dx)
        sig_l = sigma_l * jnp.sqrt(vg / 9.0) + 1e-6
        lum = _luminance(c)
        acc = jnp.zeros_like(c)
        sacc = jnp.zeros_like(sw)
        vacc = jnp.zeros_like(var)
        wacc = jnp.zeros_like(var)
        for ty in range(-2, 3):
            for tx in range(-2, 3):
                dy, dx = ty * s, tx * s
                hk = k1[ty + 2] * k1[tx + 2]
                cq = shifted(c, dy, dx)
                vq = shifted(var, dy, dx)
                w_z = jnp.exp(-jnp.abs(shifted(depth, dy, dx) - depth)
                              / (sigma_z * s + 1e-6))
                w_n = jnp.maximum(
                    jnp.sum(shifted(normal, dy, dx) * normal, -1),
                    0.0) ** sigma_n
                w_a = jnp.exp(-jnp.sum(
                    (shifted(albedo, dy, dx) - albedo) ** 2, -1)
                    / (2 * sigma_a ** 2))
                w_l = jnp.exp(-jnp.abs(_luminance(cq) - lum) / sig_l)
                wt = hk * w_z * w_n * w_a * w_l * inside(dy, dx) \
                    * (1.0 - shifted(keepf, dy, dx))
                acc = acc + cq * wt[..., None]
                sacc = sacc + shifted(sw, dy, dx) * wt
                vacc = vacc + vq * wt * wt
                wacc = wacc + wt
        cf = acc / jnp.maximum(wacc, 1e-8)[..., None]
        sf = sacc / jnp.maximum(wacc, 1e-8)
        # excluded pixels (and pixels whose whole stencil is excluded)
        # pass through untouched
        keep = (keepf > 0.5) | (wacc <= 1e-8)
        c = jnp.where(keep[..., None], c, cf)
        sw = jnp.where(keep, sw, sf)
        var = jnp.where(keep, var, vacc / jnp.maximum(wacc, 1e-8) ** 2)
    return c / jnp.maximum(sw, 1e-6)[..., None]


class SvgfHistory(struct.PyTreeNode):
    """Per-pixel temporal history for SVGF (Schied et al. 2017 §4.1):
    exponentially-integrated color and luminance moments, plus the
    geometry + camera snapshot needed to reproject and validate them
    next frame. The reference reaches the same effect by running OIDN
    on the progressive accumulator every frame
    (pg/simpleguidx11.cpp:255-260); this history survives camera motion
    (where the accumulator resets) via reprojection."""

    color: jnp.ndarray    # (H, W, 3) integrated radiance
    m1: jnp.ndarray       # (H, W) integrated luminance
    m2: jnp.ndarray       # (H, W) integrated luminance^2
    length: jnp.ndarray   # (H, W) history length (frames, clamped)
    depth: jnp.ndarray    # (H, W) depth at integration time
    normal: jnp.ndarray   # (H, W, 3)
    view_mat: jnp.ndarray  # (4, 4) camera snapshot
    focal: jnp.ndarray     # ()


def empty_svgf_history(h: int, w: int) -> SvgfHistory:
    return SvgfHistory(
        color=jnp.zeros((h, w, 3)), m1=jnp.zeros((h, w)),
        m2=jnp.zeros((h, w)), length=jnp.zeros((h, w)),
        depth=jnp.zeros((h, w)), normal=jnp.zeros((h, w, 3)),
        view_mat=jnp.eye(4), focal=jnp.zeros(()))


@jax.jit
def svgf_temporal_update(hist: SvgfHistory, frame, gb,
                         alpha: float = 0.2, max_len: float = 32.0):
    """One frame of SVGF temporal accumulation.

    Reprojects the history into the current camera (backward: current
    surface position through the PREVIOUS view matrix), validates taps
    by depth ratio + normal similarity, neighborhood-clamps the
    reprojected color against the current frame's 3x3 min/max
    (anti-ghosting), then blends with alpha = max(1/(len+1), alpha) —
    plain progressive averaging until the EMA weight takes over. Returns
    (new_hist, integrated_color, temporal_variance) where the variance
    is the moment estimate when >= 4 frames of history exist and the
    3x3 spatial estimate otherwise (the SVGF first-frames rule).
    """
    from tpu_restir.render import camera as cam_mod

    h, w = frame.shape[:2]
    lum = _luminance(frame)

    sx, sy, valid = cam_mod.project_to_screen(hist.view_mat, hist.focal,
                                              w, h, gb.pos)
    sx = jnp.clip(sx, 0, w - 1)
    sy = jnp.clip(sy, 0, h - 1)
    tap_color = hist.color[sy, sx]
    tap_m1 = hist.m1[sy, sx]
    tap_m2 = hist.m2[sy, sx]
    tap_len = hist.length[sy, sx]
    tap_depth = hist.depth[sy, sx]
    tap_normal = hist.normal[sy, sx]

    depth = gb.depth
    ratio = jnp.minimum(depth, tap_depth) / jnp.maximum(
        jnp.maximum(depth, tap_depth), 1e-20)
    n_sim = jnp.sum(gb.normal * tap_normal, axis=-1)
    accept = (valid & (tap_len > 0.0) & (depth > 0.0)
              & (ratio >= 0.9) & (n_sim >= 0.9))

    # neighborhood clamp: reprojected color may not leave the current
    # frame's local 3x3 range (kills ghosting + stale fireflies)
    cmin = frame
    cmax = frame
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = jnp.roll(frame, (-dy, -dx), axis=(0, 1))
            cmin = jnp.minimum(cmin, q)
            cmax = jnp.maximum(cmax, q)
    tap_color = jnp.clip(tap_color, cmin, cmax)
    tap_lum = _luminance(tap_color)
    # clamp moments consistently with the clamped mean
    tap_m1 = jnp.clip(tap_m1, _luminance(cmin), _luminance(cmax))
    tap_m2 = jnp.maximum(tap_m2, tap_m1 * tap_m1)
    del tap_lum

    new_len = jnp.where(accept, jnp.minimum(tap_len + 1.0, max_len), 1.0)
    a = jnp.maximum(1.0 / new_len, alpha)
    a = jnp.where(accept, a, 1.0)
    color = tap_color + (frame - tap_color) * a[..., None]
    m1 = tap_m1 + (lum - tap_m1) * a
    m2 = tap_m2 + (lum * lum - tap_m2) * a

    var_t = jnp.maximum(m2 - m1 * m1, 0.0)
    var = jnp.where(new_len >= 4.0, var_t, spatial_variance(color))

    new_hist = SvgfHistory(
        color=color, m1=m1, m2=m2, length=new_len,
        depth=depth, normal=gb.normal,
        view_mat=gb.view_mat, focal=gb.focal)
    return new_hist, color, var


def spatial_variance(color):
    """3x3 local luminance variance — the SVGF first-frames fallback
    when too few accumulated samples exist for a temporal moment
    estimate."""
    lum = _luminance(color)

    def blur(x):
        acc = jnp.zeros_like(x)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc + jnp.roll(x, (-dy, -dx), axis=(0, 1))
        return acc / 9.0

    return jnp.maximum(blur(lum * lum) - blur(lum) ** 2, 0.0)


def denoise_accumulator(accumulator, gbuffer, radius: int = 3,
                        variance=None, method: str = "svgf"):
    """OIDN-style call: color=accumulator, albedo=gBuffer.diffuse,
    normal=gBuffer.worldNormal (pg/simpleguidx11.cpp:55-66).

    method='svgf' (default) runs the variance-guided à-trous filter;
    'bilateral' keeps the round-1 joint-bilateral. Without a variance
    image (naive callers), svgf assumes a uniform moderate noise level.
    """
    if method == "bilateral":
        return joint_bilateral(accumulator, gbuffer.diffuse, gbuffer.normal,
                               gbuffer.depth, radius=radius)
    if variance is None:
        variance = spatial_variance(accumulator)
    return svgf_denoise(accumulator, gbuffer.diffuse, gbuffer.normal,
                        gbuffer.depth, variance,
                        exclude=gbuffer.is_emissive())
