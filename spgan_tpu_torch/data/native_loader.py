"""The SPR1 record file and the native C++ batch loader (counterpart of
spgan_tpu/data/native_loader.py).

An SPR1 file is a 24-byte header (magic u32 "SPR1", n u64, h u32, w u32,
c u32 = 3) followed by n raw (h, w, 3) uint8 images.  ``read_records``
maps it, ``write_records`` writes one with numpy, and
``NativeRecordLoader`` assembles training batches in C++
(``spgan_tpu_torch/native/spgan_loader.cc``, the port's copy of the JAX
package's loader).

The library is built with g++ (the JAX package's flags, so both packages
make the same batches on one machine) into ``spgan_tpu_torch/_build/``,
keyed by a hash of the source and the flags, at first use; ``build``
serves the port's other C++ sources (the PNG unfilter, utils/png.py; the
uint8 quantiser, infer/managers.py, with flags of its own) the same way.
A library built with ``-march=native`` is keyed by the host's CPU too, so
a ``_build/`` copied to another machine is rebuilt there.  A build that
fails raises: nothing falls back to a Python reader, whose resize differs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "native" / "spgan_loader.cc"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
MAGIC = 0x31525053  # "SPR1"
HEADER_BYTES = 24


@functools.lru_cache(maxsize=None)
def host_cpu() -> str:
    """The host's architecture and, where /proc/cpuinfo has them, its
    first CPU's model and feature lines: what ``-march=native`` builds
    for."""
    keep = ("model name", "flags", "CPU implementer", "CPU part",
            "Features")
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first CPU's block ends
                if line.split(":")[0].strip() in keep:
                    lines.append(line.strip())
    except OSError:
        pass
    return "\n".join(lines)


def library_path(src: Path = SRC, flags=CXX_FLAGS) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((CXX,) + tuple(flags)).encode())
    if "-march=native" in flags:
        h.update(host_cpu().encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(src: Path = SRC, what: str = "the native loader",
          flags=CXX_FLAGS) -> Path:
    """The library of the C++ source `src` (default the loader's),
    compiled with g++ and `flags` unless one exists for the current
    source, flags (and host CPU, under -march=native); raises
    RuntimeError, naming `what`, when the compiler fails or is missing."""
    out = library_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *flags, str(src), "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {CXX!r} to build {what}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} failed to build {src} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders agree
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
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
