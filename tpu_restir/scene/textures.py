"""Texture sampling over a native-resolution device texture stack.

The reference decodes textures with FreeImage and samples them per-pixel
with nearest/bilinear filtering, CLAMP_TO_EDGE/REPEAT addressing, and an
HDR float path (pg/Texture.cpp:9-194) — all at each texture's native
resolution. Array-program equivalent: every texture is zero-padded into one
(T, Hmax, Wmax, 3) float32 stack (uniform shape => a whole image of
lookups is a single gather) with per-texture (h, w) and address-mode
side tables, so filtering math uses NATIVE dimensions. HDR images load
as linear float (no 8-bit quantization, no sRGB expand) exactly like the
reference's pixel_size > 4 path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from tpu_restir import struct

CLAMP = 0   # TextureClamp::CLAMP_TO_EDGE (reference default, Texture.h:27)
REPEAT = 1  # TextureClamp::REPEAT


class TextureStack(struct.PyTreeNode):
    """Padded texture array + native sizes/address modes."""

    data: jnp.ndarray      # (T, Hmax, Wmax, 3) f32, zero-padded
    sizes: jnp.ndarray     # (T, 2) int32: native (h, w)
    modes: jnp.ndarray     # (T,) int32: CLAMP | REPEAT

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


def _area_downsample(img: np.ndarray, max_size: int) -> np.ndarray:
    """Integer-factor box downsample so max(h, w) <= max_size."""
    h, w = img.shape[:2]
    f = -(-max(h, w) // max_size)
    if f <= 1:
        return img
    hh, ww = (h // f) * f, (w // f) * f
    return img[:hh, :ww].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def build_texture_stack(images: List[np.ndarray],
                        modes: Optional[Sequence[int]] = None,
                        max_size: int = 2048) -> TextureStack:
    """Pack images at native resolution into one padded stack."""
    imgs = []
    for img in images:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        imgs.append(_area_downsample(img[..., :3], max_size))
    hmax = max(i.shape[0] for i in imgs)
    wmax = max(i.shape[1] for i in imgs)
    data = np.zeros((len(imgs), hmax, wmax, 3), np.float32)
    sizes = np.zeros((len(imgs), 2), np.int32)
    for t, img in enumerate(imgs):
        h, w = img.shape[:2]
        data[t, :h, :w] = img
        sizes[t] = (h, w)
    m = np.zeros((len(imgs),), np.int32) if modes is None \
        else np.asarray(modes, np.int32)
    return TextureStack(data=jnp.asarray(data), sizes=jnp.asarray(sizes),
                        modes=jnp.asarray(m))


def sample_bilinear(image: jnp.ndarray, uv: jnp.ndarray,
                    address: int = CLAMP) -> jnp.ndarray:
    """Bilinear lookup into one (H, W, 3) image at uv in [0,1]^2; uv.y=0 is
    the bottom row (the reference flips y in get_texel, pg/Texture.cpp)."""
    h, w = image.shape[0], image.shape[1]
    x = uv[..., 0] * (w - 1)
    y = (1.0 - uv[..., 1]) * (h - 1)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def addr(i, n):
        if address == REPEAT:
            return jnp.abs(jnp.mod(i.astype(jnp.int32), n))
        return jnp.clip(i.astype(jnp.int32), 0, n - 1)

    x0i, x1i = addr(x0, w), addr(x0 + 1, w)
    y0i, y1i = addr(y0, h), addr(y0 + 1, h)
    c00 = image[y0i, x0i]
    c01 = image[y0i, x1i]
    c10 = image[y1i, x0i]
    c11 = image[y1i, x1i]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_stack(stack: TextureStack, tex_id: jnp.ndarray, uv: jnp.ndarray,
                 fallback: jnp.ndarray) -> jnp.ndarray:
    """Bilinear texel per element at NATIVE texture resolution, honoring
    each texture's address mode; tex_id < 0 -> fallback color.

    Matches the reference lookup chain getTexelBilinear -> get_texel(x, y)
    (pg/Texture.cpp:72-140): continuous coords from uv * (native - 1),
    y flipped, and the address mode applied to the integer corners."""
    t = jnp.clip(tex_id, 0, stack.num_textures - 1)
    h = stack.sizes[t, 0]
    w = stack.sizes[t, 1]
    mode = stack.modes[t]
    x = uv[..., 0] * (w - 1).astype(jnp.float32)
    y = (1.0 - uv[..., 1]) * (h - 1).astype(jnp.float32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def addr(i, n):
        rep = jnp.abs(jnp.mod(i, n))
        cl = jnp.clip(i, 0, n - 1)
        return jnp.where(mode == REPEAT, rep, cl)

    x0i, x1i = addr(x0, w), addr(x0 + 1, w)
    y0i, y1i = addr(y0, h), addr(y0 + 1, h)
    c00 = stack.data[t, y0i, x0i]
    c01 = stack.data[t, y0i, x1i]
    c10 = stack.data[t, y1i, x0i]
    c11 = stack.data[t, y1i, x1i]
    texel = (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy
    return jnp.where((tex_id >= 0)[..., None], texel, fallback)
