"""Texture atlas sampling.

The reference samples textures nearest-neighbor from per-object `Color[,]`
arrays (`Core/Texture.fs:11-28`, vertical flip at load `Texture.fs:43`).
Array form: all scene textures live in ONE fixed-size atlas array
`(K, R, R, 3)` so the material table stays a flat SoA (no per-material
ragged shapes, one gather path); sampling is bilinear with wrap, and the
vertical flip happens at *sample* time (OBJ `vt` has v pointing up, image
row 0 is the top).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

ATLAS_RES = 256


def build_atlas(textures: list, res: int = ATLAS_RES) -> np.ndarray:
    """Resize (H, W, 3) float images to a common (K, res, res, 3) atlas.
    Box-filter downsample / bilinear upsample via PIL when available, else
    nearest."""
    if not textures:
        return np.ones((1, res, res, 3), np.float32)
    out = np.zeros((len(textures), res, res, 3), np.float32)
    for k, img in enumerate(textures):
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        try:
            from PIL import Image

            im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
            im = im.resize((res, res), Image.BILINEAR)
            out[k] = np.asarray(im, np.float32) / 255.0
        except Exception:
            ys = (np.arange(res) * img.shape[0] // res).clip(0, img.shape[0] - 1)
            xs = (np.arange(res) * img.shape[1] // res).clip(0, img.shape[1] - 1)
            out[k] = img[np.ix_(ys, xs)]
    return out


def checker_texture(
    c1=(1.0, 1.0, 1.0), c2=(0.2, 0.3, 0.1), tiles: int = 8, res: int = ATLAS_RES
) -> np.ndarray:
    """Checkerboard (reference `CheckerTexture`,
    `RenderTest/Sample/RayTracing.fs:52-62`), baked to an atlas page."""
    y, x = np.mgrid[0:res, 0:res]
    mask = ((x * tiles // res) + (y * tiles // res)) % 2
    img = np.where(mask[..., None] == 0, np.asarray(c1, np.float32), np.asarray(c2, np.float32))
    return img.astype(np.float32)


def perlin_texture(seed: int = 0, scale: float = 4.0, res: int = ATLAS_RES) -> np.ndarray:
    """Value-noise turbulence texture (capability parity with the
    reference's `Perlin`/`NoiseTexture`,
    `RenderTest/Sample/RayTracing.fs:64-99`), baked to an atlas page."""
    rng = np.random.default_rng(seed)
    img = np.zeros((res, res), np.float32)
    amp, freq = 1.0, scale
    for _ in range(5):
        g = int(max(2, freq))
        grid = rng.random((g + 1, g + 1)).astype(np.float32)
        ys = np.linspace(0, g, res, endpoint=False)
        xs = np.linspace(0, g, res, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        c00 = grid[np.ix_(y0, x0)]
        c01 = grid[np.ix_(y0, x0 + 1)]
        c10 = grid[np.ix_(y0 + 1, x0)]
        c11 = grid[np.ix_(y0 + 1, x0 + 1)]
        img += amp * ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
                      + (c10 * (1 - fx) + c11 * fx) * fy)
        amp *= 0.5
        freq *= 2.0
    img = img / img.max()
    return np.stack([img] * 3, axis=-1)


def sample_atlas(atlas: Array, tex_id: Array, uv: Array,
                 mode: str = "bilinear") -> Array:
    """Sample the atlas. atlas: (K, R, R, 3); tex_id: (...,) i32 (values < 0
    return white); uv: (..., 2) with OBJ convention (v up). Returns (..., 3).

    mode="nearest" matches the reference's `Texture2D` sampler
    (`Core/Texture.fs:11-28`) and costs ONE gather; "bilinear" costs four
    (the hot render path uses nearest)."""
    K, R = atlas.shape[0], atlas.shape[1]
    tid = jnp.clip(tex_id, 0, K - 1)
    u = jnp.mod(uv[..., 0], 1.0) * (R - 1)
    v = jnp.mod(1.0 - uv[..., 1], 1.0) * (R - 1)  # flip: OBJ v-up -> row-down
    if mode == "nearest":
        x = jnp.round(u).astype(jnp.int32)
        y = jnp.round(v).astype(jnp.int32)
        rgb = atlas[tid, y, x]
        return jnp.where((tex_id >= 0)[..., None], rgb, 1.0)
    x0 = jnp.floor(u).astype(jnp.int32)
    y0 = jnp.floor(v).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, R - 1)
    y1 = jnp.minimum(y0 + 1, R - 1)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    c00 = atlas[tid, y0, x0]
    c01 = atlas[tid, y0, x1]
    c10 = atlas[tid, y1, x0]
    c11 = atlas[tid, y1, x1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    rgb = top * (1 - fy) + bot * fy
    return jnp.where((tex_id >= 0)[..., None], rgb, 1.0)
