"""Vector-math core (the glm layer of the reference, as jnp array ops).

All functions operate on arrays whose last axis is the 3-vector axis and
broadcast over leading (pixel/ray) axes — the SoA equivalent of the
reference's per-pixel glm code (reference pg/utils.cpp, pg/Distribution.h).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_restir.mathx.color import aces, srgb_compress, srgb_expand  # noqa: F401
from tpu_restir.mathx.special import calc_i_m, ibeta_nonnorm  # noqa: F401

_EPS = 1e-30


@jax.custom_vjp
def _rows_core(table, idx):
    return table[idx]


def _rows_fwd(table, idx):
    return table[idx], (idx, table.shape)


_MASKSUM_MAX_ROWS = 128


def _rows_bwd(res, g):
    idx, (t, c) = res
    gf = g.reshape(-1, c)
    ix = idx.reshape(-1)
    if t <= _MASKSUM_MAX_ROWS:
        rows = [jnp.sum(jnp.where((ix == r)[:, None], gf, 0.0), axis=0)
                for r in range(t)]
        gt = jnp.stack(rows)
    else:
        gt = jnp.zeros((t, c), gf.dtype).at[ix].add(gf)
    return gt, None


_rows_core.defvjp(_rows_fwd, _rows_bwd)


def take_rows(table: jnp.ndarray, idx: jnp.ndarray,
              mxu_max_rows: int = 0,
              onehot_budget_bytes: int = 256 * 1024 * 1024) -> jnp.ndarray:
    """Row select `table[idx]` (vertex attributes, material columns,
    light tables; millions of indices into a small table).

    The default is the plain gather. A one-hot matmul form (the one-hot
    operand makes a round trip through device memory) stays behind
    mxu_max_rows > 0 for A/B; its speed on the GPU is not measured.

    table: (T, C) float32; idx: any integer shape -> idx.shape + (C,).

    Differentiable in `table`: the gather's transpose is a scatter-add
    in which millions of indices collide into a few rows (material
    tables) — the custom VJP computes the table cotangent as T masked
    row-sums for small tables instead. Which form is faster on the GPU
    is not measured.
    """
    t, _c = table.shape
    if t > mxu_max_rows:
        return _rows_core(table, idx)
    flat = idx.reshape(-1)
    n = flat.shape[0]

    def onehot_rows(ix):
        onehot = (ix[:, None] == jnp.arange(t, dtype=ix.dtype)[None, :])
        return jnp.dot(onehot.astype(jnp.float32), table,
                       precision=jax.lax.Precision.HIGHEST)

    if n * t * 4 <= onehot_budget_bytes:
        out = onehot_rows(flat)
    else:
        chunk = max(onehot_budget_bytes // (t * 4), 1024)
        chunk = min(chunk - chunk % 1024, n)  # keep chunks lane-aligned
        nc = -(-n // chunk)
        padded = jnp.pad(flat, (0, nc * chunk - n))
        out = jax.lax.map(onehot_rows, padded.reshape(nc, chunk))
        out = out.reshape(nc * chunk, -1)[:n]
    return out.reshape(idx.shape + table.shape[-1:])


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def dot1(a, b):
    """Batched dot product keeping the last axis -> (..., 1)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def length(v):
    """AD-safe |v|: sqrt'(0) = inf would turn a masked-off cotangent into
    0 * inf = NaN (p_hat = |f| is exactly 0 for occluded/invalid samples,
    and every downstream use masks on p_hat > 0)."""
    s = jnp.maximum(dot(v, v), 0.0)
    pos = s > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, s, 1.0)), 0.0)


def safe_sqrt(x):
    """AD-safe sqrt(max(x, 0)): sqrt'(0) = inf turns masked cotangents
    into NaN (e.g. lobe samples where z rounds to exactly 1.0f)."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_pow(base, exp):
    """AD-safe base**exp for base >= 0 with a differentiable exponent:
    d/d(exp) = base**exp * ln(base) is NaN at base == 0 (0 * -inf through
    the where), which poisons shininess gradients for every pixel whose
    lobe dot is clamped to 0. Forward matches std::pow incl. pow(0,0)=1."""
    pos = base > 0.0
    p = jnp.power(jnp.where(pos, base, 1.0), exp)
    return jnp.where(pos, p, jnp.where(exp == 0.0, 1.0, 0.0))


def normalize(v):
    """Safe normalize: zero vectors map to zero (not NaN)."""
    n2 = dot1(v, v)
    return v * jax.lax.rsqrt(jnp.maximum(n2, _EPS))


def cross(a, b):
    return jnp.cross(a, b)


def reflect(i, n):
    """glm::reflect — i points toward the surface."""
    return i - 2.0 * dot1(n, i) * n


def refract(i, n, eta):
    """glm::refract. Returns 0 on total internal reflection.

    eta broadcast: (...,) or scalar.
    """
    eta = jnp.asarray(eta)[..., None]
    ndi = dot1(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = eta * i - (eta * ndi + jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k < 0.0, 0.0, refr)


def orthogonal(v):
    """A vector orthogonal to v (reference Utils::orthogonal, pg/utils.cpp:204-207)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    use_x = jnp.abs(x) > jnp.abs(z)
    ox = jnp.where(use_x, y, jnp.zeros_like(x))
    oy = jnp.where(use_x, -x, z)
    oz = jnp.where(use_x, jnp.zeros_like(x), -y)
    return jnp.stack([ox, oy, oz], axis=-1)


def onb(n):
    """Orthonormal basis (o1, o2) around unit n.

    Matches the Gram-Schmidt frame used by both distributions in the
    reference (pg/Distribution.h:20-25): o2 = normalize(orthogonal(n)),
    o1 = normalize(cross(n, o2)), o2 = normalize(cross(o1, n)).
    """
    o2 = normalize(orthogonal(n))
    o1 = normalize(cross(n, o2))
    o2 = normalize(cross(o1, n))
    return o1, o2


def to_world(o1, o2, n, local):
    """Transform local (x, y, z) [z along n] into world space."""
    return (local[..., 0:1] * o1 + local[..., 1:2] * o2 + local[..., 2:3] * n)


def luminance(c):
    """Rec.709 luminance of an (..., 3) color."""
    return (0.2126 * c[..., 0] + 0.7152 * c[..., 1]
            + 0.0722 * c[..., 2])


def max_component(v):
    return jnp.max(v, axis=-1)


def power_heuristic(pdf, pdf_other):
    """Power heuristic beta=2 (reference pg/DirectMISIntegrator.cpp:10-15)."""
    p2 = pdf * pdf
    q2 = pdf_other * pdf_other
    return jnp.where(p2 + q2 > 0.0, p2 / (p2 + q2), 0.0)


def cartesian_to_spherical(p):
    """(theta, phi, r) per reference Utils (pg/utils.cpp:272-278)."""
    theta = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.arctan2(jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2), p[..., 2])
    r = length(p)
    return jnp.stack([theta, phi, r], axis=-1)


def spherical_to_cartesian(s):
    theta, phi, r = s[..., 0], s[..., 1], s[..., 2]
    return jnp.stack(
        [r * jnp.cos(theta) * jnp.sin(phi),
         r * jnp.sin(theta) * jnp.sin(phi),
         r * jnp.cos(phi)], axis=-1)


def schlick(incident, normal, ior1, ior2):
    """Scalar Schlick approximation (reference Utils::schlickApprox)."""
    f0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    cos_t = jnp.maximum(dot(-incident, normal), 0.0)
    return f0 + (1.0 - f0) * (1.0 - cos_t) ** 5


def schlick_f0(incident, normal, f0):
    """Vector Schlick with explicit F0 (reference Utils::schlickApprox3)."""
    cos_t = jnp.maximum(dot1(-incident, normal), 0.0)
    return f0 + (1.0 - f0) * (1.0 - cos_t) ** 5


def sanitize(radiance, *, count=False):
    """NaN / negative radiance scrubber (reference pg/Integrator.cpp:6-23).

    The reference logs and zeroes NaN or negative components per sample.
    Returns scrubbed radiance (and the number of bad pixels if count).
    """
    bad = jnp.isnan(radiance) | (radiance < 0.0)
    out = jnp.where(bad, 0.0, radiance)
    if count:
        return out, jnp.sum(bad)
    return out
