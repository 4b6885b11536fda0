"""A minimal PNG writer (8-bit RGB, no filtering) on the standard library,
for the images the managers save; PIL is not needed."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write `image`, uint8 (H, W, 3), as an RGB PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 (H, W, 3), got "
                         f"{image.dtype} {image.shape}")
    h, w, _ = image.shape
    # each scanline starts with its filter type, 0 (none)
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = image.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
