"""The port's data layer against the JAX package (and cv2, its resize) on
the CPU: cv2's Lanczos4 and linear resizes bit for bit, the square resize,
the npy and synthetic pipelines, the SPR1 record file and the native C++
loader, and the loader's refusal to fall back when it cannot be built.

Tolerances: every resize, crop and batch is held bit for bit (the
synthetic source too, though one LSB, 1/127.5, would be allowed)."""
import cv2
import numpy as np
import pytest

import spgan_tpu.data.native_loader as jax_native
from spgan_tpu.config import Config as JConfig
from spgan_tpu.data.pipeline import TrainPipeline as JTrainPipeline
from spgan_tpu.data.pipeline import center_square_resize as jax_square
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.data import native_loader
from spgan_tpu_torch.utils import native
from spgan_tpu_torch.data.pipeline import (TrainPipeline, center_square_resize,
                                           make_data_source,
                                           make_train_pipeline)
from spgan_tpu_torch.data.resize import resize_lanczos4_u8, resize_linear_u8


def _img(rng, h, w, c=3):
    shape = (h, w, c) if c else (h, w)
    return rng.randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("src, dst", [
    ((256, 256), (197, 197)),    # the shipped full_size resize
    ((256, 768), (197, 197)),
    ((256, 768), (256, 768)),    # identity size
    ((197, 197), (256, 256)),
    ((32, 96), (256, 768)),
    ((100, 73), (41, 150)),
    ((1, 5), (3, 9)),
])
@pytest.mark.parametrize("c", [3, 0])
def test_lanczos4_matches_cv2_bit_for_bit(src, dst, c):
    img = _img(np.random.RandomState(sum(src + dst)), *src, c)
    np.testing.assert_array_equal(
        resize_lanczos4_u8(img, *dst),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LANCZOS4))


@pytest.mark.parametrize("name, fn, flag", [
    ("lanczos4", resize_lanczos4_u8, cv2.INTER_LANCZOS4),
    ("linear", resize_linear_u8, cv2.INTER_LINEAR)])
def test_resize_sweep_of_random_sizes(name, fn, flag):
    """40 seeded random sizes, up and down: within 1 LSB of cv2, and
    exact at every size (measured 60 of 60 on cv2 5.0.0)."""
    rng = np.random.RandomState(11)
    exact = 0
    for _ in range(40):
        sh, sw, h, w = (int(v) for v in rng.randint(1, 300, 4))
        img = _img(rng, sh, sw)
        ref = cv2.resize(img, (w, h), interpolation=flag)
        diff = np.abs(fn(img, h, w).astype(int) - ref)
        assert diff.max() <= 1, (name, sh, sw, h, w)
        exact += diff.max() == 0
    assert exact == 40


def test_linear_matches_cv2_at_the_synthetic_upsample():
    """The JAX synthetic source's x8 upsample of (h/8, w/8) noise."""
    base = np.random.RandomState(0).randint(0, 255, (4, 32, 96, 3), np.uint8)
    for img in base:
        np.testing.assert_array_equal(
            resize_linear_u8(img, 256, 768),
            cv2.resize(img, (768, 256), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("shape, size", [
    ((256, 768, 3), 197), ((256, 768, 3), 256), ((300, 200, 3), 197),
    ((197, 197, 3), 197), ((128, 384, 3), 256)])
def test_center_square_resize_matches_jax(shape, size):
    """ROADMAP C1: the port's square resize is the JAX package's (cv2
    Lanczos4) bit for bit."""
    img = _img(np.random.RandomState(size), *shape)
    np.testing.assert_array_equal(center_square_resize(img, size),
                                  jax_square(img, size))


def _configs(**data):
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.train_params.batch_size = 4
        for k, v in data.items():
            setattr(c.data_params, k, v)
    return jcfg, cfg


def _batches(pipe, n):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for b, jb in zip(got, want):
        np.testing.assert_array_equal(b["ac_coords"], jb["ac_coords"])
        assert b["patch"].dtype == jb["patch"].dtype == np.float32
        np.testing.assert_array_equal(b["patch"], jb["patch"])


def test_npy_pipeline_matches_jax(tmp_path):
    """Same file, seed and batch: the same crops (ac_coords equal) and the
    same pixels (bit-equal), through both Lanczos stages (128 -> 256 ->
    197)."""
    path = str(tmp_path / "panos.npy")
    np.save(path, _img(np.random.RandomState(3), 5 * 128, 384).reshape(
        5, 128, 384, 3))
    jcfg, cfg = _configs(source="npy", folder=path)
    _assert_batches_equal(_batches(make_train_pipeline(cfg, seed=7), 3),
                          _batches(JTrainPipeline(jcfg, seed=7), 3))


def test_synthetic_pipeline_matches_jax():
    jcfg, cfg = _configs()
    _assert_batches_equal(_batches(TrainPipeline(cfg, seed=2), 3),
                          _batches(JTrainPipeline(jcfg, seed=2), 3))


def test_pipeline_worker_failure_raises_in_the_consumer(tmp_path):
    """A batch the background thread cannot make (float images, which the
    uint8 resize refuses) raises in next(), not a hang."""
    path = str(tmp_path / "float.npy")
    np.save(path, np.zeros((2, 64, 192, 3), np.float32))
    _, cfg = _configs(source="npy", folder=path)
    pipe = TrainPipeline(cfg)
    try:
        with pytest.raises(RuntimeError, match="worker failed") as e:
            next(pipe)
        assert isinstance(e.value.__cause__, ValueError)
    finally:
        pipe.close()


@pytest.mark.parametrize("source", ["folder", "lmdb"])
def test_unported_sources_raise(source, tmp_path):
    """The folder and lmdb sources are ported (tests/test_torch_data_
    sources.py holds their pixels against JAX's): pointed at an empty
    directory they raise as they find nothing to read."""
    _, cfg = _configs(source=source, folder=str(tmp_path))
    err = ValueError if source == "folder" else FileNotFoundError
    with pytest.raises(err):
        make_data_source(cfg)


@pytest.fixture
def jax_loader_lib(tmp_path, monkeypatch):
    """The JAX package's loader built into tmp_path (its own flags and
    source), so no other test process shares the library file."""
    monkeypatch.setattr(jax_native, "_SO", str(tmp_path / "libjax.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.get_lib() is not None


@pytest.fixture
def records(tmp_path):
    imgs = _img(np.random.RandomState(4), 6 * 96, 288).reshape(6, 96, 288, 3)
    path = str(tmp_path / "panos.spr")
    native_loader.write_records(path, imgs)
    return path, imgs


def test_records_match_jax(records, tmp_path, jax_loader_lib):
    path, imgs = records
    np.testing.assert_array_equal(jax_native.read_records(path), imgs)
    np.testing.assert_array_equal(native_loader.read_records(path), imgs)
    jpath = str(tmp_path / "jax.spr")
    jax_native.write_records(jpath, imgs)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    bad = tmp_path / "bad.spr"
    bad.write_bytes(b"NOPE" + bytes(20))
    with pytest.raises(ValueError, match="SPR1"):
        native_loader.read_records(str(bad))


def test_native_loader_matches_jax(records, jax_loader_lib):
    """The same .spr, geometry and seed: bit-equal batches, and the
    shipped .spr config takes the native loader."""
    path, _ = records
    _, cfg = _configs(source="spr", folder=path)
    jld = jax_native.NativeRecordLoader(path, full_size=197, patch_size=101,
                                        batch=4, seed=5)
    pipe = make_train_pipeline(cfg, seed=5)
    try:
        got = [next(pipe) for _ in range(3)]
        want = [jld.next_batch() for _ in range(3)]
        assert len(pipe._ld) == len(jld) == 6
    finally:
        pipe.close()
        jld.close()
    _assert_batches_equal(got, want)
    assert not np.array_equal(got[0]["patch"], got[1]["patch"])


def test_loader_that_cannot_build_raises(records, tmp_path, monkeypatch):
    """No compiler: the .spr pipeline raises; it does not fall back to a
    Python reader (whose resize differs)."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native_loader.get_lib.cache_clear()
    try:
        _, cfg = _configs(source="spr", folder=records[0])
        with pytest.raises(RuntimeError, match="native loader"):
            make_train_pipeline(cfg)
        _, cfg = _configs(source="npy", folder=records[0])
        with pytest.raises(RuntimeError, match="native loader"):
            make_train_pipeline(cfg)   # a folder ending in .spr
    finally:
        native_loader.get_lib.cache_clear()
