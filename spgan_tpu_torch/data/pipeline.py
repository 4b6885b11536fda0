"""Host data pipeline: pano -> square resize -> flip -> random patch crop
(counterpart of spgan_tpu/data/pipeline.py).

Sources (``data_params.source``): "synthetic" (smooth noise panoramas, for
smoke runs), "folder" (a directory of image files), "npy" (a packed (N,
H, W, 3) uint8 array, memory-mapped), "lmdb" (a reference-prepared LMDB,
read by the stdlib parser data/lmdb_read.py) and "spr" (an SPR1 record
file, data/native_loader.py).  The folder and lmdb sources decode PNGs
in-tree (utils/png.py) and other formats through PIL, when it imports.

``make_train_pipeline`` gives an .spr file to the native C++ loader, as
the JAX package does, and every other source to ``TrainPipeline``: a
background thread that makes batches from the source in the JAX package's
draw order, square-resizing with cv2's Lanczos4 arithmetic
(data/resize.py).  The native loader resizes once, bilinearly, and skips
extra_pre_resize (the JAX package's loader does the same).

Batches are numpy: {"patch": (B,P,P,3) float32 in [-1,1], "ac_coords":
(B,3) float32}.  The training loop moves them to the device.
"""
from __future__ import annotations

import os
import queue
import re
import threading
from dataclasses import dataclass
from glob import glob
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.data.native_loader import NativeRecordLoader, read_records
from spgan_tpu_torch.data.resize import resize_lanczos4_u8, resize_linear_u8
from spgan_tpu_torch.utils.png import decode_image

# batches the background thread of TrainPipeline makes ahead
PREFETCH = 4


def center_square_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Center-crop to a square, then resize to size x size (cv2's
    Lanczos4)."""
    h, w = img.shape[:2]
    if h > w:
        t = (h - w) // 2
        img = img[t:t + w]
    elif w > h:
        t = (w - h) // 2
        img = img[:, t:t + h]
    if img.shape[0] != size:
        img = resize_lanczos4_u8(img, size, size)
    return img


@dataclass
class PatchCropper:
    input_size: int   # full_size, e.g. 197
    patch_size: int   # e.g. 101
    coord_num_dir: int = 3

    def __call__(self, img: np.ndarray, rng: np.random.RandomState):
        """img: (S, S, 3). Returns (patch, ac_coords)."""
        span = self.input_size - self.patch_size
        xst = rng.randint(0, span) if span > 0 else 0
        yst = rng.randint(0, span) if span > 0 else 0
        patch = img[xst:xst + self.patch_size, yst:yst + self.patch_size]

        def ratio(v):
            # the reference's denominators: input - patch - 1
            return v / (self.input_size - self.patch_size - 1) * 2.0 - 1.0

        if self.coord_num_dir != 3:
            raise NotImplementedError(self.coord_num_dir)
        ac = np.array([ratio(xst),
                       np.sin(ratio(yst) * np.pi),
                       np.cos(ratio(yst) * np.pi)], np.float32)
        return patch, ac


class SyntheticPanoramas:
    """Deterministic random panoramas (smooth noise) for smoke runs: n
    uint8 noise images of (h/8, w/8) upsampled to data_size (w, h) with
    cv2's linear arithmetic, as the JAX package's synthetic source."""

    def __init__(self, data_size=(768, 256), n: int = 512, seed: int = 0):
        w, h = data_size
        self.w, self.h, self.n = w, h, n
        self.base = np.random.RandomState(seed).randint(
            0, 255, (n, h // 8, w // 8, 3), np.uint8)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        return resize_linear_u8(self.base[idx % self.n], self.h, self.w)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _folder_source(folder: str):
    """Every .png/.jpg/.jpeg/.webp file of `folder`, in sorted order."""
    paths = sorted(
        p for p in glob(os.path.join(folder, "*"))
        if p.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    if not paths:
        raise ValueError(f"no images found in {folder}")
    return len(paths), lambda idx: decode_image(_read(paths[idx % len(paths)]))


def _lmdb_source(folder: str, key_prefix: Optional[str] = None):
    """A reference-prepared LMDB (keys f"{size}-{idx}"), read in-process
    by data/lmdb_read.py.  An LMDB that stores several resolutions keeps
    each image once per size under its own prefix: training on all of them
    would repeat and rescale the dataset, so with more than one prefix
    `key_prefix` must pick one."""
    from spgan_tpu_torch.data import lmdb_read

    env = lmdb_read.open(folder, readonly=True, lock=False, readahead=False,
                         meminit=False)
    key_re = re.compile(rb"^(.*)-(\d{5,8})$")
    by_prefix: Dict[bytes, list] = {}
    with env.begin(write=False) as txn:
        # keys only: the stored images are not read here
        for k in txn.cursor().iternext(values=False):
            m = key_re.match(k)
            if m:
                by_prefix.setdefault(m.group(1), []).append(k)
    if not by_prefix:
        raise ValueError(f"no image keys found in LMDB {folder}")
    if key_prefix is not None:
        enc = key_prefix.encode()
        if enc not in by_prefix:
            raise ValueError(
                f"lmdb_key_prefix {key_prefix!r} not in LMDB {folder}; "
                f"present: {sorted(p.decode() for p in by_prefix)}")
        keys = by_prefix[enc]
    elif len(by_prefix) > 1:
        raise ValueError(
            f"LMDB {folder} stores multiple resolutions/prefixes "
            f"{sorted(p.decode() for p in by_prefix)}; training on all "
            "would repeat each image once per stored size; set "
            "data_params.lmdb_key_prefix to pick one")
    else:
        (keys,) = by_prefix.values()

    def load(idx):
        with env.begin(write=False) as txn:
            return decode_image(txn.get(keys[idx % len(keys)]))

    return len(keys), load


def make_data_source(cfg: Config) -> Tuple[int, Callable[[int], np.ndarray]]:
    """(number of images, load(idx) -> (H, W, 3) uint8) of
    cfg.data_params.source."""
    dp = cfg.data_params
    if dp.source == "synthetic":
        src = SyntheticPanoramas(cfg.train_params.data_size,
                                 n=max(64, min(dp.num_train, 512)))
        return len(src), src.__getitem__
    if dp.source == "folder":
        return _folder_source(dp.folder)
    if dp.source == "lmdb":
        return _lmdb_source(dp.folder or dp.lmdb_root, dp.lmdb_key_prefix)
    if dp.source in ("npy", "spr"):
        arr = (np.load(dp.folder, mmap_mode="r") if dp.source == "npy"
               else read_records(dp.folder))
        return arr.shape[0], lambda idx: np.asarray(arr[idx % arr.shape[0]])
    raise ValueError(f"unknown data source {dp.source!r}; the port reads "
                     "synthetic | folder | npy | lmdb | spr")


class TrainPipeline:
    """Training batches made by one background thread from
    make_data_source (PREFETCH batches ahead): per sample, the
    image index, the square resize to extra_pre_resize then to full_size
    (two Lanczos stages, as the reference), a random flip and the patch
    crop, all drawn from one np.random.RandomState(seed) in the JAX
    package's order.  close() stops the thread."""

    def __init__(self, cfg: Config, seed: int = 0):
        tp = cfg.train_params
        self.tp = tp
        self.n, self.load = make_data_source(cfg)
        self.cropper = PatchCropper(tp.full_size, tp.patch_size,
                                    tp.coord_num_dir)
        self.rng = np.random.RandomState(seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _sample_one(self, rng: np.random.RandomState):
        img = self.load(rng.randint(0, self.n))
        if self.tp.extra_pre_resize is not None:
            img = center_square_resize(img, self.tp.extra_pre_resize)
        img = center_square_resize(img, self.tp.full_size)
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        return self.cropper(img, rng)

    def make_batch(self, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        patches, acs = zip(*(self._sample_one(rng)
                             for _ in range(self.tp.batch_size)))
        return {"patch": np.stack(patches).astype(np.float32) / 127.5 - 1.0,
                "ac_coords": np.stack(acs).astype(np.float32)}

    def _worker(self):
        while not self._stop.is_set():
            try:
                b = self.make_batch(self.rng)
            except Exception as e:  # handed to the consumer, raised there
                b = e
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(b, Exception):
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._q.get()
        if isinstance(b, Exception):
            raise RuntimeError("the data pipeline's worker failed") from b
        return b

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


class NativeTrainPipeline:
    """Training batches straight from the C++ record loader (an .spr
    file), made on the calling thread."""

    def __init__(self, cfg: Config, seed: int = 0):
        tp = cfg.train_params
        self._ld = NativeRecordLoader(
            cfg.data_params.folder, full_size=tp.full_size,
            patch_size=tp.patch_size, batch=tp.batch_size, seed=seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._ld.next_batch()

    def close(self) -> None:
        self._ld.close()


def make_train_pipeline(cfg: Config, seed: int = 0):
    """The native loader for an .spr source (source "spr", or a folder
    that ends in .spr), TrainPipeline otherwise.  A loader that cannot be
    built raises."""
    dp = cfg.data_params
    if dp.source == "spr" or (dp.folder or "").endswith(".spr"):
        return NativeTrainPipeline(cfg, seed=seed)
    return TrainPipeline(cfg, seed=seed)
