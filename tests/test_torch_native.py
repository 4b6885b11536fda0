"""`spgan_tpu_torch/utils/native.py`, the one build cache of the port's
native libraries: the keys of its nvcc and g++ entries, the file names
they give (pinned, so a change to what is hashed cannot force every
library to rebuild unnoticed), a warm cache that builds nothing, and a
missing nvcc.  Imports no JAX and compiles nothing."""
from __future__ import annotations

import shutil

import pytest
import torch

from spgan_tpu_torch.data import native_loader
from spgan_tpu_torch.infer import managers
from spgan_tpu_torch.utils import native


def test_library_key_covers_headers(tmp_path, monkeypatch):
    """The built library's name changes with the source, with any csrc/*.cuh
    header (a source may include it) and with the flags, so a stale .so is
    never loaded after an edit."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    first = native.cuda_library_path("k")
    assert native.cuda_library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = native.cuda_library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = native.cuda_library_path("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    fourth = native.cuda_library_path("k")
    assert fourth not in (first, second, third)
    monkeypatch.setattr(native, "NVCC_FLAGS",
                        native.NVCC_FLAGS + ("-lineinfo",))
    assert native.cuda_library_path("k") not in (first, second, third,
                                                 fourth)


def test_the_library_key_follows_source_flags_and_host(tmp_path,
                                                       monkeypatch):
    src = tmp_path / "to_uint8.cc"
    shutil.copy(native.PKG_DIR / "native" / "to_uint8.cc", src)
    flags = managers.TO_UINT8_FLAGS
    first = native.cxx_library_path(src, flags)
    assert first.name.startswith("libto_uint8_")
    assert native.cxx_library_path(src, flags) == first
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.cxx_library_path(src, flags)
    assert second != first
    third = native.cxx_library_path(src, flags + ("-g",))
    assert third not in (first, second)
    # only a -march=native build depends on the host's CPU
    native_flags = flags + ("-march=native",)
    a = native.cxx_library_path(src, native_flags)
    monkeypatch.setattr(native, "host_cpu", lambda: "another CPU")
    assert native.cxx_library_path(src, native_flags) != a
    assert native.cxx_library_path(src, flags) == second
    assert native.cxx_library_path(
        native_loader.SRC, native.HOST_FLAGS) != native.cxx_library_path(
            native_loader.SRC, native.HOST_FLAGS[:-1])


# The file names these inputs got before the two build modules became
# one (ops/kernels/build.py and data/native_loader.py):
# equal names mean a warm cache stays warm.
PINNED = {
    "cuda": "libk_7d8a8a4b45bd1258.so",
    "cxx": "libs_022ef751baea58f7.so",
    "cxx_quantiser": "libs_5940fd97de16e64e.so",
    "cxx_native": "libs_d50bb0ce57efe981.so",
}


def test_file_names_equal_the_earlier_build_modules(tmp_path, monkeypatch):
    assert native.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    assert native.CXX == "g++"
    loader = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
    assert native.HOST_FLAGS == loader
    assert managers.TO_UINT8_FLAGS == ("-O3", "-ffp-contract=off", "-shared",
                                       "-fPIC", "-std=c++17", "-pthread")
    (tmp_path / "k.cu").write_bytes(
        b'#include "h.cuh"\n__global__ void k() {}\n')
    (tmp_path / "h.cuh").write_bytes(b"// header\n")
    (tmp_path / "a.cuh").write_bytes(b"// another\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(native, "host_cpu",
                        lambda: "x86_64\nmodel name\t: a CPU")
    src = tmp_path / "s.cc"
    src.write_bytes(b'extern "C" int f() { return 1; }\n')
    got = {
        "cuda": native.cuda_library_path("k"),
        "cxx": native.cxx_library_path(src, loader[:1] + loader[2:]),
        "cxx_quantiser": native.cxx_library_path(src,
                                                 managers.TO_UINT8_FLAGS),
        "cxx_native": native.cxx_library_path(src, loader),
    }
    assert {k: p.name for k, p in got.items()} == PINNED
    assert {p.parent for p in got.values()} == {native.BUILD_DIR}


def test_a_warm_cache_builds_nothing(tmp_path, monkeypatch):
    """With a library in place for every key, neither entry starts a
    compiler."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def refuse(*a, **k):
        raise AssertionError(f"a compiler started: {a}")

    monkeypatch.setattr(native.subprocess, "Popen", refuse)
    for name in native.cuda_sources():
        native.cuda_library_path(name).touch()
    assert native.build_cuda(native.cuda_sources()) == {}
    src = native.PKG_DIR / "native" / "to_uint8.cc"
    out = native.cxx_library_path(src, managers.TO_UINT8_FLAGS)
    out.touch()
    assert native.build_cxx(src, "the uint8 quantiser",
                            managers.TO_UINT8_FLAGS) == out


def test_a_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    if shutil.which(native.CXX) is None:
        pytest.skip("no g++")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the "
                       "bad source"):
        native.build_cxx(src, "the bad source", ("-shared", "-fPIC"))
    assert list(tmp_path.glob("*.so")) == []
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-g++"))
    with pytest.raises(RuntimeError, match="cannot run .* the bad source"):
        native.build_cxx(src, "the bad source", ("-shared", "-fPIC"))
    assert list(tmp_path.glob("*.so")) == []


def test_a_missing_nvcc_raises():
    """Without nvcc the CUDA entry reports it by name (it runs nothing
    where nvcc is installed, as on the card's machine)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests build there")
    try:
        native.find_nvcc()
    except RuntimeError as e:
        assert "nvcc not found" in str(e)
        with pytest.raises(RuntimeError, match="nvcc"):
            native.build_cuda(["sphere_conv"])


def test_the_module_is_the_only_one_that_compiles():
    """`subprocess` appears in one module of the package: this one."""
    users = sorted(str(p.relative_to(native.PKG_DIR))
                   for p in native.PKG_DIR.rglob("*.py")
                   if "subprocess" in p.read_text())
    assert users == ["utils/native.py"]
