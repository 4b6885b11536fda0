"""`infer/managers.py::to_uint8`: the native pass (native/to_uint8.cc)
against the numpy formula it replaces, bit for bit; the numpy path for
other dtypes and layouts; the thread rule and the counters; the g++ build
(its cache key: tests/test_torch_native.py).  Imports no JAX, so it also
runs on the card's host
(`python -m pytest --noconftest -q tests/test_torch_to_uint8.py`)."""
from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from spgan_tpu_torch.infer import managers
from spgan_tpu_torch.infer.managers import to_uint8, to_uint8_threads
from spgan_tpu_torch.utils import native as native_cache
from spgan_tpu_torch.utils import trace

NATIVE = "spgan.engine.to_uint8.native"
THREADS = "spgan.engine.to_uint8.threads"
MIB = 1 << 20


def numpy_to_uint8(images: np.ndarray) -> np.ndarray:
    """The formula `to_uint8` ran before the native pass, kept here as the
    reference."""
    with np.errstate(invalid="ignore"):  # NaN's cast warns
        arr = np.clip((images + 1.0) / 2.0, 0.0, 1.0)
        return (arr * 255.0 + 0.5).astype(np.uint8)


def counts():
    c = trace.counters()
    return c.get(NATIVE, 0), c.get(THREADS, 0)


def native(x: np.ndarray) -> np.ndarray:
    """to_uint8(x) for a contiguous float32 x, checked to have taken the
    native pass once."""
    assert x.dtype == np.float32 and x.flags.c_contiguous
    before = counts()
    out = to_uint8(x)
    after = counts()
    assert after[0] == before[0] + 1
    assert after[1] > before[1]
    assert out.dtype == np.uint8 and out.shape == x.shape
    assert out.flags.c_contiguous
    return out


def with_tails(values: np.ndarray) -> list:
    """`values` at offsets and lengths that put each one in the vector body
    and in the scalar tail (16 elements a vector step)."""
    values = np.asarray(values, np.float32).ravel()
    pad = np.linspace(-1.5, 1.5, 37, dtype=np.float32)
    return [values, values[:-5] if values.size > 5 else values,
            np.concatenate([pad[:3], values]),
            np.concatenate([values, pad[:13]])]


@pytest.mark.parametrize("shape", [
    (0,), (0, 3), (2, 0, 5, 3), (1,), (3,), (15,), (16,), (17,), (63,),
    (64,), (65,), (127, 3), (2, 5, 7, 3), (4, 33, 65, 3)])
def test_native_matches_numpy_on_random_data(shape):
    rng = np.random.default_rng(sum(shape) + len(shape))
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    np.testing.assert_array_equal(native(x), numpy_to_uint8(x))


def neighbours(x: np.ndarray, k: int = 3) -> list:
    """x moved 1..k float32 steps up and down."""
    out = []
    for direction in (np.float32(np.inf), np.float32(-np.inf)):
        v = np.asarray(x, np.float32)
        for _ in range(k):
            v = np.nextafter(v, direction)
            out.append(v)
    return out


def test_native_matches_numpy_on_rounding_boundaries():
    # a * 255 + 0.5 lands on an integer j at a = (j - 0.5) / 255, i.e.
    # x = 2a - 1; take each, and its float32 neighbours in x and in a
    j = np.arange(0, 257, dtype=np.float64)
    a = ((j - 0.5) / 255).astype(np.float32)
    xs = [(2 * j / 255 - 1).astype(np.float32),
          np.float32(2) * a - np.float32(1)]
    xs += [np.float32(2) * v - np.float32(1) for v in neighbours(a)]
    xs += [v for x in xs[:2] for v in neighbours(x)]
    # -1, 1 and 0 and just outside and inside them
    edges = np.array([-1, 1, 0, -0.0], np.float32)
    values = np.concatenate(xs + [edges] + neighbours(edges))
    y = np.clip((values + np.float32(1)) / np.float32(2), 0, 1) \
        * np.float32(255) + np.float32(0.5)
    assert (y == np.round(y)).sum() > 200  # the reference's ties are there
    for v in with_tails(values):
        np.testing.assert_array_equal(native(v), numpy_to_uint8(v))


def test_native_matches_numpy_on_nonfinite_and_huge_values():
    tiny = np.finfo(np.float32).tiny
    values = np.array([np.inf, -np.inf, np.nan, -np.nan, 1e30, -1e30,
                       np.finfo(np.float32).max, -np.finfo(np.float32).max,
                       tiny, -tiny, tiny / 4, -tiny / 4, 3.0, -3.0],
                      np.float32)
    for v in with_tails(np.tile(values, 3)):
        np.testing.assert_array_equal(native(v), numpy_to_uint8(v))


def test_native_matches_numpy_on_a_sweep_of_bit_patterns():
    # every 4099th float32 bit pattern: every exponent, both signs, NaNs
    bits = np.arange(0, 2 ** 32, 4099, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    np.testing.assert_array_equal(native(x), numpy_to_uint8(x))


@pytest.mark.parametrize("case", ["strided", "float64", "fortran",
                                  "big_endian"])
def test_other_dtypes_and_layouts_take_numpy(case):
    rng = np.random.default_rng(3)
    base = (rng.standard_normal((3, 8, 10, 3)) * 1.5).astype(np.float32)
    x = {"strided": base[:, ::2, 1:],
         "float64": base.astype(np.float64),
         "fortran": np.asfortranarray(base),
         "big_endian": base.astype(">f4")}[case]
    before = counts()
    out = to_uint8(x)
    assert counts() == before
    np.testing.assert_array_equal(out, numpy_to_uint8(x))
    if case != "float64":  # the same values as float32 give the same bytes
        np.testing.assert_array_equal(out, to_uint8(
            np.ascontiguousarray(x, np.float32)))


@pytest.mark.parametrize("nbytes,cpus,want", [
    (0, 8, 1), (8 * MIB - 1, 8, 1), (8 * MIB, 8, 1), (16 * MIB, 8, 2),
    (56 * MIB, 8, 7), (226 * MIB, 8, 8), (226 * MIB, 3, 3),
    (226 * MIB, 1, 1), (14 * MIB, 32, 1)])
def test_threads_follow_the_size(nbytes, cpus, want):
    assert to_uint8_threads(nbytes, cpus) == want


def test_threads_counter_below_and_above_the_threshold():
    cpus = len(os.sched_getaffinity(0))
    small = np.linspace(-1.2, 1.2, MIB // 4, dtype=np.float32)
    before = counts()
    native(small)
    assert counts()[1] - before[1] == 1
    # 24 MiB and a tail that no thread count splits evenly
    big = np.concatenate([np.tile(small, 24), np.full(100, 0.5, np.float32)])
    before = counts()
    np.testing.assert_array_equal(native(big), numpy_to_uint8(big))
    ran = counts()[1] - before[1]
    assert ran == min(3, cpus)
    if cpus > 1:
        assert ran > 1


def test_concurrent_calls_on_slices_give_one_calls_bytes():
    rng = np.random.default_rng(5)
    batch = (rng.standard_normal((8, 40, 72, 3)) * 1.5).astype(np.float32)
    whole = to_uint8(batch)
    slices = [slice(k, k + 2) for k in range(0, 8, 2)]
    before = counts()
    with ThreadPoolExecutor(4) as pool:
        parts = [pool.submit(to_uint8, batch[sl]) for sl in slices]
        got = np.concatenate([f.result(timeout=60) for f in parts])
    assert counts() == (before[0] + 4, before[1] + 4)
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(whole, numpy_to_uint8(batch))


def test_counters_lose_no_update_under_thread_switches():
    x = np.linspace(-1.5, 1.5, 333, dtype=np.float32)
    workers, calls = 3 * (os.cpu_count() or 1) + 4, 250
    before = counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [to_uint8(x)
                                                    for _ in range(calls)])
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = workers * calls
    assert counts() == (before[0] + n, before[1] + n)


def test_the_quantiser_builds_with_gpp_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(native_cache, "BUILD_DIR", tmp_path)
    managers._to_uint8_lib.cache_clear()
    ran = []
    real_popen = subprocess.Popen

    def popen(cmd, *a, **k):
        ran.append(list(cmd))
        return real_popen(cmd, *a, **k)

    monkeypatch.setattr(native_cache.subprocess, "Popen", popen)
    try:
        x = np.linspace(-1.5, 1.5, 1000, dtype=np.float32)
        np.testing.assert_array_equal(native(x), numpy_to_uint8(x))
        lib = native_cache.cxx_library_path(
            native_cache.PKG_DIR / "native" / "to_uint8.cc",
            managers.TO_UINT8_FLAGS)
    finally:
        managers._to_uint8_lib.cache_clear()
    assert [c[0] for c in ran] == ["g++"]
    assert not any("nvcc" in part for part in ran[0])
    assert "-ffp-contract=off" in ran[0]
    assert "-march=native" not in ran[0]
    assert lib.parent == tmp_path and lib.exists()
    if platform.machine() in ("x86_64", "AMD64") and shutil.which("objdump"):
        # the pass is packed SSE2: conversions and saturating packs
        asm = subprocess.run(["objdump", "-d", str(lib)], capture_output=True,
                             text=True, check=True).stdout
        for op in ("cvttps2dq", "packssdw", "packuswb", "maxps", "minps"):
            assert op in asm, op
