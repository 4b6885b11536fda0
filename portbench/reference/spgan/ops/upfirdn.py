"""upfirdn2d resampling family (counterpart of spgan_tpu/ops/upfirdn.py).

The JAX package writes upfirdn2d as one depthwise XLA convolution with
``lhs_dilation``; here it is the same three steps in NHWC: zero-insertion,
(possibly negative) padding, and a depthwise ``F.conv2d`` with the flipped
FIR kernel and stride ``down``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def make_kernel(k: Union[Sequence[float], np.ndarray]) -> np.ndarray:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


@functools.lru_cache(maxsize=None)
def _fir_weight(flat: Tuple[float, ...], kh: int, channels: int,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Depthwise conv weight (C,1,kh,kw) of the flipped FIR kernel, made
    once per (kernel, width, dtype, device) instead of copied to the
    device at every call.  Made outside inference mode even when the first
    call is inside it, so the cached tensor also serves autograd."""
    with torch.inference_mode(False):
        k = torch.tensor(flat, dtype=torch.float32).reshape(kh, -1).flip(0, 1)
        return k[None, None].expand(channels, 1, *k.shape).contiguous().to(
            device=device, dtype=dtype)


def _depthwise(x: torch.Tensor, k2d: np.ndarray, *, lhs_dilation: int = 1,
               padding=((0, 0), (0, 0)), stride: int = 1) -> torch.Tensor:
    """NHWC depthwise correlation with the *flipped* FIR kernel over the
    input dilated by ``lhs_dilation`` (zeros between samples: size
    up*H-(up-1)) and padded by ``padding`` ((lo,hi) per spatial dim,
    negative = crop)."""
    b, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
    up = lhs_dilation
    if up > 1:
        z = xc.new_zeros((b, c, up * h - (up - 1), up * w - (up - 1)))
        z[:, :, ::up, ::up] = xc
        xc = z
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 or ph1 or pw0 or pw1:
        xc = F.pad(xc, (pw0, pw1, ph0, ph1))
    wt = _fir_weight(tuple(np.asarray(k2d, np.float32).ravel().tolist()),
                     k2d.shape[0], c, x.dtype, x.device)
    y = F.conv2d(xc, wt, stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Zero-insert upsample by `up`, pad (pad0, pad1) on both spatial dims,
    FIR filter, stride-`down` (the reference CUDA upfirdn2d's output
    length: the high side gets the (up-1) trailing zeros)."""
    extra = up - 1
    return _depthwise(x, kernel, lhs_dilation=up,
                      padding=((pad[0], pad[1] + extra),
                               (pad[0], pad[1] + extra)),
                      stride=down)


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
            y = _depthwise(x, k, lhs_dilation=self.factor,
                           padding=((kh - 1, kh - 1), (kh - 1, kh - 1)))
            return y[:, 1:-1, 1:-1, :]
        p = kh - self.factor
        pad0 = (p + 1) // 2 + self.factor - 1
        pad1 = p // 2
        return upfirdn2d(x, k, up=self.factor, down=1, pad=(pad0, pad1))

