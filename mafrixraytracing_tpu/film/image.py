"""Array image output (PNG).

Replaces the reference's Silk.NET/ImGui live window (`Core/Film.fs:38-92`)
per the north star: observability is periodic array/PNG dumps instead of an
interactive GL texture. Uses PIL when present; otherwise falls back to a
dependency-free zlib PNG encoder.
"""
from __future__ import annotations

import struct as _struct
import zlib

import numpy as np


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG."""
    arr = np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8))
    assert arr.ndim == 3 and arr.shape[2] == 3, arr.shape
    try:
        from PIL import Image

        Image.fromarray(arr, "RGB").save(path)
        return
    except Exception:
        pass
    with open(path, "wb") as f:
        f.write(_encode_png_zlib(arr))


def pil_image():
    """`PIL.Image`, or a clear error when Pillow is not installed (only
    texture *loading* needs it; PNG writing has a zlib fallback)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading image files needs Pillow (the PIL package), which is "
            "not installed") from e
    return Image


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG bytes (in-memory sink for the
    live preview, `film.preview`)."""
    arr = np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8))
    assert arr.ndim == 3 and arr.shape[2] == 3, arr.shape
    try:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, format="PNG")
        return buf.getvalue()
    except Exception:
        return _encode_png_zlib(arr)


def _encode_png_zlib(arr: np.ndarray) -> bytes:
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = _struct.pack(">I", len(data)) + tag + data
        return c + _struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = _struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def read_image(path: str) -> np.ndarray:
    """Decode an image file to float32 (H, W, 3) in [0, 1] — texture loading
    (reference `TextureFromFile`, `Core/Texture.fs:30-44`; note the reference
    flips vertically there — we keep row 0 at the top and flip at *sampling*
    time instead, since OBJ vt has v up). Needs Pillow."""
    Image = pil_image()
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0
