"""PNG on the standard library: a writer (8-bit RGB) for the images the
managers save, and a decoder for the training data sources, so neither
needs PIL.

``read_png`` decodes 8-bit, non-interlaced PNGs of every colour type
(gray, gray + alpha, RGB, RGBA, palette) to the (H, W, 3) uint8 pixels
``PIL.Image.open(...).convert("RGB")`` gives: gray replicated, alpha
dropped, palette indices looked up.  The scanline filters run in C++
(``spgan_tpu_torch/native/png_unfilter.cc``, built with g++ at first use
by ``utils/native.py``); ``unfilter_plain`` is the same in numpy.
``decode_image`` takes any image file's bytes: such a PNG in-tree, and
anything else (JPEG, 16-bit or interlaced PNG) through PIL when PIL
imports, otherwise it raises and names PIL.
"""
from __future__ import annotations

import ctypes
import functools
import io
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# bytes per pixel of each 8-bit colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, filter_type: int = 0) -> bytes:
    """`image`, uint8 (H, W, 3), as the bytes of an RGB PNG whose
    scanlines all carry `filter_type` (0 none, 1 Sub, 2 Up, 3 Avg, 4
    Paeth; the filters predict from the known pixels, so they vectorise)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 (H, W, 3), got "
                         f"{image.dtype} {image.shape}")
    h, w, _ = image.shape
    x = image.reshape(h, 3 * w).astype(np.int32)
    a = np.pad(x, ((0, 0), (3, 0)))[:, :-3]        # the byte to the left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]           # the byte above
    c = np.pad(b, ((0, 0), (3, 0)))[:, :-3]
    if filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = [0, a, b, (a + b) >> 1][filter_type]
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = (x - pred) % 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write `image`, uint8 (H, W, 3), as an RGB PNG (no filtering)."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


class UnsupportedPNG(ValueError):
    """A valid PNG outside what read_png decodes (bit depth, interlace)."""


def unfilter_plain(raw: np.ndarray, h: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Reconstruct the (h, stride) scanlines from the inflated bytes
    (h rows of 1 + stride), in numpy: Sub is a cumulative sum in uint8,
    Up a vector add, Avg and Paeth go pixel by pixel."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    zero = np.zeros(stride, np.uint8)
    for r in range(h):
        t, src = rows[r, 0], rows[r, 1:]
        up = out[r - 1] if r else zero
        if t == 0:
            out[r] = src
        elif t == 1:
            out[r] = np.cumsum(src.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif t == 2:
            out[r] = src + up
        elif t in (3, 4):
            cur = out[r]
            upi = up.astype(np.int32)
            for i in range(0, stride, bpp):
                a = (cur[i - bpp:i].astype(np.int32) if i
                     else np.zeros(bpp, np.int32))
                b = upi[i:i + bpp]
                if t == 3:
                    pred = (a + b) >> 1
                else:
                    c = upi[i - bpp:i] if i else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[i:i + bpp] = (src[i:i + bpp] + pred).astype(np.uint8)
        else:
            raise ValueError(f"PNG row {r}: filter type {t} is not 0-4")
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from spgan_tpu_torch.utils import native

    lib = ctypes.CDLL(str(native.build_cxx(
        native.PKG_DIR / "native" / "png_unfilter.cc", "the PNG unfilter",
        native.HOST_FLAGS)))
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """unfilter_plain's result, computed in C++."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, want "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    rc = _lib().png_unfilter(raw.ctypes.data, h, stride, bpp,
                             out.ctypes.data)
    if rc:
        raise ValueError(f"PNG row {rc - 1}: filter type "
                         f"{raw[(rc - 1) * (stride + 1)]} is not 0-4")
    return out


def read_png(data: bytes, unfilter_fn=unfilter) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of the PNG `data` (see the module
    note); raises UnsupportedPNG for a bit depth other than 8 or an
    interlaced image, ValueError for a damaged file."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(">I", crc)[0] \
                != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} at byte {pos} is damaged")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise UnsupportedPNG(f"PNG of bit depth {depth}, colour type "
                             f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = unfilter_fn(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        return plte[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of an image file's bytes: an 8-bit
    PNG in-tree; any other image through PIL, which must then import."""
    if data[:8] == _SIGNATURE:
        try:
            return read_png(data)
        except UnsupportedPNG:
            pass
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "this image is not an 8-bit non-interlaced PNG (JPEG, WebP, "
            "16-bit or interlaced PNG); decoding it needs PIL (Pillow), "
            "which does not import here") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
