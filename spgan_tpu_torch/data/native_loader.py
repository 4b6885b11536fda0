"""The SPR1 record file and the native C++ batch loader (counterpart of
spgan_tpu/data/native_loader.py).

An SPR1 file is a 24-byte header (magic u32 "SPR1", n u64, h u32, w u32,
c u32 = 3) followed by n raw (h, w, 3) uint8 images.  ``read_records``
maps it, ``write_records`` writes one with numpy, and
``NativeRecordLoader`` assembles training batches in C++
(``spgan_tpu_torch/native/spgan_loader.cc``, the port's copy of the JAX
package's loader).

The library is built with g++ (the JAX package's flags, so both packages
make the same batches on one machine) by ``utils/native.py`` into the
port's build cache at first use.  A build that fails raises: nothing
falls back to a Python reader, whose resize differs.
"""
from __future__ import annotations

import ctypes
import functools
import os
import numpy as np

from spgan_tpu_torch.utils import native

SRC = native.PKG_DIR / "native" / "spgan_loader.cc"
MAGIC = 0x31525053  # "SPR1"
HEADER_BYTES = 24


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native.build_cxx(SRC, "the native loader",
                                           native.HOST_FLAGS)))
    lib.spr_open.restype = ctypes.c_void_p
    lib.spr_open.argtypes = [ctypes.c_char_p]
    lib.spr_close.restype = None
    lib.spr_close.argtypes = [ctypes.c_void_p]
    lib.spr_size.restype = ctypes.c_uint64
    lib.spr_size.argtypes = [ctypes.c_void_p]
    lib.spr_make_batch.restype = ctypes.c_int
    lib.spr_make_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def read_records(path: str) -> np.memmap:
    """A read-only (n, h, w, 3) uint8 map of an SPR1 file."""
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if len(head) != HEADER_BYTES or \
            np.frombuffer(head, np.uint32, count=1)[0] != MAGIC:
        raise ValueError(f"not an SPR1 file: {path}")
    n = int(np.frombuffer(head, np.uint64, count=1, offset=4)[0])
    h, w, c = (int(v) for v in np.frombuffer(head, np.uint32, count=3,
                                             offset=12))
    if c != 3:
        raise ValueError(f"{path}: {c} channels, want 3")
    return np.memmap(path, np.uint8, mode="r", offset=HEADER_BYTES,
                     shape=(n, h, w, c))


def write_records(path: str, images: np.ndarray) -> None:
    """Write (n, h, w, 3) uint8 images as an SPR1 file."""
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"want (n, h, w, 3) images, got {images.shape}")
    n, h, w, c = images.shape
    with open(path, "wb") as f:
        f.write(np.uint32(MAGIC).tobytes())
        f.write(np.uint64(n).tobytes())
        f.write(np.array([h, w, c], np.uint32).tobytes())
        images.tofile(f)


class NativeRecordLoader:
    """Batches of an SPR1 file made in C++, one call per batch: center
    square crop, one bilinear resize to full_size, random flip, random
    patch crop, [-1, 1].  Batch k (from 1) draws from seed + k.
    include_full adds "full", the flipped full_size images the patches
    were cropped from (the EXT2-FID's real images)."""

    def __init__(self, path: str, full_size: int, patch_size: int,
                 batch: int, seed: int = 0, include_full: bool = False):
        if not 0 < patch_size <= full_size or batch <= 0:
            raise ValueError(f"patch_size {patch_size}, full_size "
                             f"{full_size}, batch {batch}")
        self.lib = get_lib()
        self.handle = self.lib.spr_open(os.fsencode(path))
        if not self.handle:
            raise ValueError(f"cannot open record file {path} (missing, "
                             "not SPR1, or truncated)")
        self.full_size, self.patch_size = full_size, patch_size
        self.batch = batch
        self.seed = seed
        self._patch = np.empty((batch, patch_size, patch_size, 3), np.float32)
        self._ac = np.empty((batch, 3), np.float32)
        self._full = (np.empty((batch, full_size, full_size, 3), np.float32)
                      if include_full else None)

    def __len__(self) -> int:
        return int(self.lib.spr_size(self.handle))

    def next_batch(self) -> dict:
        self.seed = (self.seed + 1) % 2 ** 64
        rc = self.lib.spr_make_batch(
            self.handle, self.batch, self.full_size, self.patch_size,
            self.seed, self._patch.ctypes.data, self._ac.ctypes.data,
            None if self._full is None else self._full.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"spr_make_batch failed (rc {rc})")
        out = {"patch": self._patch.copy(), "ac_coords": self._ac.copy()}
        if self._full is not None:
            out["full"] = self._full.copy()
        return out

    def close(self) -> None:
        if self.handle:
            self.lib.spr_close(self.handle)
            self.handle = None
