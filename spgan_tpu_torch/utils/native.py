"""Build, cache and load the port's native libraries.

Two compilers feed one cache, ``spgan_tpu_torch/_build/`` (listed in
.gitignore):

- nvcc: each ``spgan_tpu_torch/csrc/<name>.cu`` (a plain C interface)
  is compiled for Hopper (sm_90a).  Its key hashes the source, every
  ``csrc/*.cuh`` header (a source may include any of them) and the flags.
  The first ``load_cuda`` of a process builds every stale source at once,
  one nvcc each, all started together.
- g++: a host C++ source with its own flags (the SPR loader, the PNG
  unfilter, the uint8 quantiser).  Its key hashes the source and the
  command; a ``-march=native`` build also hashes the host's CPU, so a
  ``_build/`` copied to another machine is rebuilt there.

A library is ``lib<stem>_<first 16 hex digits of the key>.so``, compiled
to a temporary file and moved into place with ``os.replace``, so
concurrent builds agree.  Libraries are loaded with ctypes.  A build
that fails raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX = "g++"
# g++ flags of a library built for this host's CPU: the SPR loader (the
# JAX package's flags, so both packages make the same batches on one
# machine) and the PNG unfilter
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _keyed(stem: str, *parts: bytes) -> Path:
    """The cache's file for `stem` whose key hashes `parts` in order."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def _start(command: Callable[[str], List[str]], what: str):
    """Start the compiler command that `command` gives for a temporary
    output in the cache's directory; returns (process, temporary path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = command(tmp)
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {cmd[0]!r} to build {what}: "
                           f"{e}") from e
    return proc, tmp


def _finish(jobs: Dict[str, tuple]) -> Dict[str, str]:
    """Wait for every job {what: (process, temporary path, final path)};
    each that succeeded is moved into place.  Returns the compilers'
    output by `what`; raises naming every job that failed."""
    logs, failed = {}, []
    for what, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[what] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{proc.args[0]} failed to build {what} (exit "
                          f"{proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


# ---------------------------------------------------------------- nvcc


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, the default toolkit location, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built")
    return found


def cuda_library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives."""
    headers = [h.name.encode() + b"\0" + h.read_bytes()
               for h in sorted(CSRC_DIR.glob("*.cuh"))]
    return _keyed(name, (CSRC_DIR / f"{name}.cu").read_bytes(), *headers,
                  " ".join(NVCC_FLAGS).encode())


def cuda_sources() -> list:
    """The names of every ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_cuda(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that has no library for its current key,
    one nvcc process per source, all started together.  Returns nvcc's
    output (its register and shared-memory report) per built source."""
    nvcc, jobs = None, {}
    for name in names:
        out = cuda_library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        src = str(CSRC_DIR / f"{name}.cu")
        jobs[name] = (*_start(lambda tmp: [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                              f"{name}.cu"), out)
    return _finish(jobs)


@functools.lru_cache(maxsize=None)
def load_cuda(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``.  Its first call builds
    every source whose library is stale, all together, so a program's
    first kernel call (or a set-up step that makes one) pays for every
    build at once."""
    build_cuda(cuda_sources())
    return ctypes.CDLL(str(cuda_library_path(name)))


# ---------------------------------------------------------------- g++


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


def cxx_library_path(src: Path, flags: Sequence[str]) -> Path:
    """Where the library of the C++ source `src` built with `flags` lives."""
    host = [host_cpu().encode()] if "-march=native" in flags else []
    return _keyed(src.stem, src.read_bytes(),
                  " ".join((CXX, *flags)).encode(), *host)


def build_cxx(src: Path, what: str, flags: Sequence[str]) -> Path:
    """The library of the C++ source `src`, compiled with g++ and `flags`
    unless one exists for its current key; raises RuntimeError, naming
    `what`, when the compiler fails or is missing."""
    out = cxx_library_path(src, flags)
    if not out.exists():
        _finish({what: (*_start(
            lambda tmp: [CXX, *flags, str(src), "-o", tmp], what), out)})
    return out
