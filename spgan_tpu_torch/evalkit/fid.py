"""FID: feature statistics and the Frechet distance (counterpart of
spgan_tpu/evalkit/fid.py).

The features come from InceptionV3FID on the device, in float32 with TF32
off; the statistics sum in float64 on the host; the matrix square root of
the Frechet distance is scipy's, on the host (the reference's
libs/fid.py:125-156).  Real-set statistics are cached as a pickle of {mu,
sigma, n} under .fid-cache/<dataset key>.pkl, the JAX package's format,
so either package reads the other's cache.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import warnings
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from spgan_tpu_torch.device import resolve


@dataclass
class FIDStats:
    mu: np.ndarray
    sigma: np.ndarray
    n: int

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"mu": self.mu, "sigma": self.sigma, "n": self.n}, f)

    @classmethod
    def load(cls, path: str) -> "FIDStats":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(mu=d["mu"], sigma=d["sigma"], n=d["n"])


def compute_stats(feature_batches: Iterable[np.ndarray]) -> FIDStats:
    """Mean and covariance of (B, D) feature batches, streamed in
    float64."""
    n, s, ss = 0, None, None
    for f in feature_batches:
        f = np.asarray(f, np.float64)
        if s is None:
            s, ss = f.sum(0), f.T @ f
        else:
            s += f.sum(0)
            ss += f.T @ f
        n += f.shape[0]
    mu = s / n
    sigma = (ss - n * np.outer(mu, mu)) / (n - 1)
    return FIDStats(mu=mu, sigma=sigma, n=n)


def _sqrtm_quiet(m: np.ndarray) -> np.ndarray:
    """scipy's sqrtm with its singular-matrix LinAlgWarning silenced (the
    reference passes disp=False; n <= 2048 features in 2048 dimensions make
    sigma rank-deficient by construction)."""
    from scipy import linalg

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        return linalg.sqrtm(m)


def frechet_distance(a: FIDStats, b: FIDStats, eps: float = 1e-6) -> float:
    """||mu_a - mu_b||^2 + tr(sigma_a + sigma_b - 2 sqrt(sigma_a sigma_b)).
    The eps-offset retry runs only when the square root is not finite; an
    imaginary diagonal above 1e-3 raises instead of being dropped."""
    diff = a.mu - b.mu
    covmean = _sqrtm_quiet(a.sigma @ b.sigma)
    if not np.isfinite(covmean).all():
        offset = np.eye(a.sigma.shape[0]) * eps
        covmean = _sqrtm_quiet((a.sigma + offset) @ (b.sigma + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("cov sqrt has imaginary component "
                             f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(a.sigma) + np.trace(b.sigma)
                 - 2 * np.trace(covmean))


@contextlib.contextmanager
def tf32_off():
    """cuDNN convolutions and cuBLAS matmuls in float32 inside the block;
    the flags the caller had are restored after it."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


class FIDEvaluator:
    """Inception features on `device` (default cuda) and cached real-set
    statistics under cache_dir."""

    def __init__(self, inception: torch.nn.Module,
                 cache_dir: str = ".fid-cache", device=None):
        self.dev = resolve(device)
        self.model = inception.to(self.dev).eval()
        self.cache_dir = cache_dir

    @torch.no_grad()
    def features(self, images) -> np.ndarray:
        """images: (B, H, W, 3) in [-1, 1] (numpy or a tensor) -> (B, 2048)
        float32 features on the host."""
        x = torch.as_tensor(images).to(self.dev, torch.float32)
        with tf32_off():
            return self.model(x).cpu().numpy()

    def stats_from_batches(self, batches: Iterable) -> FIDStats:
        return compute_stats(self.features(b) for b in batches)

    def real_stats(self, dataset_key: str,
                   batches_fn: Optional[Callable[[], Iterable]] = None
                   ) -> FIDStats:
        path = os.path.join(self.cache_dir, f"{dataset_key}.pkl")
        if os.path.exists(path):
            return FIDStats.load(path)
        if batches_fn is None:
            raise FileNotFoundError(f"no cached stats at {path} and no data "
                                    "provided")
        stats = self.stats_from_batches(batches_fn())
        stats.save(path)
        return stats


def eval_fid(generation_fn: Callable[[int], Iterable],
             real_batches_fn: Callable[[], Iterable],
             inception: torch.nn.Module, n_sample: int, batch_size: int,
             dataset_key: str = "dataset", cache_dir: str = ".fid-cache",
             device=None) -> float:
    """FID of generation_fn(n_batches)'s image batches (in [-1, 1])
    against the real set (cached under dataset_key)."""
    ev = FIDEvaluator(inception, cache_dir, device=device)
    real = ev.real_stats(dataset_key, real_batches_fn)
    fake = ev.stats_from_batches(generation_fn(max(1, n_sample //
                                                   batch_size)))
    return frechet_distance(real, fake)
