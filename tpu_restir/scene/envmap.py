"""Environment (sky) lookup.

Equirectangular spherical map per the reference's SphericalMap
(pg/SphericalMap.cpp:10-14): x = 0.5 + 0.5*atan2(dy, dx)/pi,
y = 1 - acos(dz)/pi. Misses fall back to the flat background color
(pg/RenderParams.h bgColor) when no map is loaded or use_skybox is off.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_restir.scene.textures import sample_bilinear


def spherical_uv(d: jnp.ndarray) -> jnp.ndarray:
    x = 0.5 + 0.5 * jnp.arctan2(d[..., 1], d[..., 0]) / jnp.pi
    y = 1.0 - jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0)) / jnp.pi
    return jnp.stack([x, y], axis=-1)


def sky_radiance(scene, params, d: jnp.ndarray) -> jnp.ndarray:
    """Radiance for rays that leave the scene."""
    bg = jnp.asarray(params.bg_color, jnp.float32)
    if params.use_skybox and scene.envmap is not None:
        return sample_bilinear(scene.envmap, spherical_uv(d))
    return jnp.broadcast_to(bg, d.shape)


def load_hdr(path: str):
    """Load an HDR/EXR/PFM/PNG environment image as float32 (host-side).
    PFM (the bundled demo asset format) is parsed natively — imageio's
    plugin round-trips rows flipped."""
    import numpy as np

    if path.lower().endswith(".pfm"):
        return read_pfm(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"loading the environment image {path!r} needs the 'imageio' "
            "package, which is not installed (PFM files need nothing)") from e

    img = np.asarray(imageio.imread(path), np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img[..., :3]


def read_pfm(path: str):
    """Portable FloatMap reader (color 'PF', little-endian, bottom-up —
    the format FreeImage's HDR path also understands)."""
    import numpy as np

    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"PF":
            raise ValueError(f"{path}: not a color PFM")
        w, h = (int(v) for v in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 3 * 4),
                             "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3)
    return np.ascontiguousarray(img[::-1]).astype(np.float32)


def write_pfm(path: str, img) -> None:
    """Portable FloatMap writer (color, little-endian)."""
    import numpy as np

    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())
