"""Host data pipeline: pano -> square resize -> flip -> random patch crop
(counterpart of spgan_tpu/data/pipeline.py: PatchCropper and the synthetic
source).

Batches are numpy: {"patch": (B,P,P,3) float32 in [-1,1], "ac_coords":
(B,3) float32}.  The training loop moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from spgan_tpu_torch.config import Config


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 (H,W,3) -> uint8 (h,w,3): bilinear, antialiased when
    shrinking (torch on the CPU)."""
    t = torch.as_tensor(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(t.float(), size=(h, w), mode="bilinear",
                      align_corners=False,
                      antialias=h < img.shape[0] or w < img.shape[1])
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def center_square_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Center-crop to a square, then resize to size x size."""
    h, w = img.shape[:2]
    if h > w:
        t = (h - w) // 2
        img = img[t:t + w]
    elif w > h:
        t = (w - h) // 2
        img = img[:, t:t + h]
    if img.shape[0] != size:
        img = _resize(img, size, size)
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
    uint8 noise images of (h/8, w/8) upsampled to data_size (w, h).

    The JAX package's synthetic source resizes with cv2 (and its pipeline
    with Lanczos); this one uses torch's bilinear resize, because cv2 and
    PIL are not dependencies of the port.  Its pixels therefore differ from
    the JAX source's; the statistics (smooth noise in [0, 255]) are the
    same."""

    def __init__(self, data_size=(768, 256), n: int = 512, seed: int = 0):
        w, h = data_size
        self.w, self.h, self.n = w, h, n
        self.base = np.random.RandomState(seed).randint(
            0, 255, (n, h // 8, w // 8, 3), np.uint8)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        return _resize(self.base[idx % self.n], self.h, self.w)


class TrainPipeline:
    """Training batches from the synthetic source, made on the calling
    thread: pre-resize, resize to full_size, random flip, patch crop,
    [-1,1]."""

    def __init__(self, cfg: Config, seed: int = 0):
        tp = cfg.train_params
        self.tp = tp
        self.source = SyntheticPanoramas(tp.data_size)
        self.cropper = PatchCropper(tp.full_size, tp.patch_size,
                                    tp.coord_num_dir)
        self.rng = np.random.RandomState(seed)

    def _sample_one(self, rng):
        img = self.source[rng.randint(0, len(self.source))]
        if self.tp.extra_pre_resize is not None:
            img = center_square_resize(img, self.tp.extra_pre_resize)
        img = center_square_resize(img, self.tp.full_size)
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        return self.cropper(img, rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        patches, acs = zip(*(self._sample_one(self.rng)
                             for _ in range(self.tp.batch_size)))
        return {"patch": np.stack(patches).astype(np.float32) / 127.5 - 1.0,
                "ac_coords": np.stack(acs).astype(np.float32)}
