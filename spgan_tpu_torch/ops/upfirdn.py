"""upfirdn2d resampling family (counterpart of spgan_tpu/ops/upfirdn.py).

The JAX package writes upfirdn2d as one depthwise XLA convolution with
``lhs_dilation``.  Here every function goes through one autograd Function
(ops/kernels/upfirdn.py): the hand-written NHWC kernel on a CUDA tensor,
zero insertion, padding and a depthwise ``F.conv2d`` on a CPU tensor, and
for either a gradient that is the same op with the adjoint parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from spgan_tpu_torch.ops.kernels import upfirdn as _k


def make_kernel(k: Union[Sequence[float], np.ndarray]) -> np.ndarray:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def gaussian_kernel(kernel_size: int, std: float = 1.0) -> np.ndarray:
    """A normalised (kernel_size, kernel_size) Gaussian stencil (float64),
    the reference's scipy.signal.gaussian outer product."""
    n = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    g = np.exp(-(n ** 2) / (2 * std * std))
    k2 = np.outer(g, g)
    return k2 / k2.sum()


def _taps(kernel: np.ndarray) -> Tuple[Tuple[float, ...], int]:
    """A 2-D stencil as the Function takes it: (row-major float32 taps,
    rows)."""
    k = np.asarray(kernel, np.float32)
    return tuple(k.ravel().tolist()), k.shape[0]


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Zero-insert upsample by `up`, pad (pad0, pad1) on both spatial dims,
    FIR filter, stride-`down` (the reference CUDA upfirdn2d's output
    length: the high side gets the (up-1) trailing zeros)."""
    taps, kh = _taps(kernel)
    return _k.upfirdn2d(x, taps, kh, up, down, (pad[0], pad[1]) * 2)


def blur(x: torch.Tensor, kernel: np.ndarray, pad: Tuple[int, int]
         ) -> torch.Tensor:
    """FIR filter with padding (pad0, pad1) on both spatial dims."""
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)


@dataclass(frozen=True)
class Blur:
    """Parameter-free FIR blur; kernel is a 1-D/2-D stencil (pre-
    `make_kernel`).  padding_mode "replicate" pads with the edge values
    before a valid FIR: pad (p0, p1) on both spatial dims, or (left,
    right, top, bottom)."""

    kernel: Tuple[float, ...] = (1.0, 2.0, 1.0)
    pad: Tuple[int, ...] = (0, 0)
    upsample_factor: int = 1
    padding_mode: str = "zero"  # "zero" | "replicate"

    def k2d(self) -> np.ndarray:
        k = make_kernel(np.asarray(self.kernel, np.float32))
        if self.upsample_factor > 1:
            k = k * (self.upsample_factor ** 2)
        return k

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding_mode == "replicate":
            p = self.pad
            lrtb = (p[0], p[1], p[0], p[1]) if len(p) == 2 else tuple(p)
            x = F.pad(x.permute(0, 3, 1, 2), lrtb,
                      mode="replicate").permute(0, 2, 3, 1)
            return upfirdn2d(x, self.k2d())
        return upfirdn2d(x, self.k2d(), pad=self.pad)


@dataclass(frozen=True)
class Upsample:
    """x2 FIR upsampling.

    no_zero_pad=True (the shipped TS config): zero-stuff by 2, full-pad,
    FIR with kernel*4, then crop one dirty pixel per side => output 2H-1.
    """

    kernel: Tuple[float, ...] = (1.0, 2.0, 1.0)
    factor: int = 2
    no_zero_pad: bool = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        k = make_kernel(np.asarray(self.kernel, np.float32)) * (self.factor ** 2)
        kh = k.shape[0]
        if self.no_zero_pad:
            # full padding (kh - 1 a side of the zero-inserted input) less
            # the one dirty pixel a side that is cropped; upfirdn2d's high
            # side already holds factor - 1 trailing zeros
            return upfirdn2d(x, k, up=self.factor,
                             pad=(kh - 2, kh - 1 - self.factor))
        p = kh - self.factor
        pad0 = (p + 1) // 2 + self.factor - 1
        pad1 = p // 2
        return upfirdn2d(x, k, up=self.factor, down=1, pad=(pad0, pad1))


@dataclass(frozen=True)
class Downsample:
    """x`factor` FIR downsampling (FIR, then stride `factor`)."""

    kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0)
    factor: int = 2

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        k = make_kernel(np.asarray(self.kernel, np.float32))
        p = k.shape[0] - self.factor
        return upfirdn2d(x, k, down=self.factor, pad=((p + 1) // 2, p // 2))
