"""Global-grid spherical convolutions over whole equirectangular feature
maps (counterpart of spgan_tpu/geometry/global_conv.py).

* GlobalSphereConv2d: the input is sampled by the global gnomonic pattern
  (one k x k tap block per stride-th pixel), then convolved with stride
  k.
* IncreIntervalSphereConv2d: the border-shrinking variant, whose output
  centres are re-spread over the sphere, so a strided (or, with
  upsample, growing) conv keeps full coverage.

Both sample nearest-neighbour with zeros outside, as the reference's
plain GridSampler does.  No shipped configuration runs them: the patch
model runs the coords-driven patch grids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from spgan_tpu_torch.geometry.sphere_grid import (global_sphere_pattern,
                                                  incre_interval_pattern)
from spgan_tpu_torch.ops.grid_sample import nearest_grid_sample_shared
from spgan_tpu_torch.ops.linear import conv2d_nhwc


def _to_grid(pat: np.ndarray, h: int, w: int) -> np.ndarray:
    """(1, Ho, Wo, 2) (lat, lon) pixel pattern -> (Ho, Wo, 2) (gx, gy) in
    [-1, 1], float32."""
    gy = pat[0, :, :, 0] / h * 2 - 1
    gx = pat[0, :, :, 1] / w * 2 - 1
    return np.stack([gx, gy], axis=-1).astype(np.float32)


@lru_cache(maxsize=32)
def _global_grid(h: int, w: int, k: int, stride: int) -> np.ndarray:
    return _to_grid(global_sphere_pattern(h, w, k, stride), h, w)


@lru_cache(maxsize=32)
def _incre_grid(h: int, w: int, k: int, stride: int,
                upsample: bool) -> np.ndarray:
    return _to_grid(incre_interval_pattern(h, w, k, stride, upsample), h, w)


@dataclass(frozen=True)
class _SphereConvBase:
    in_ch: int
    out_ch: int
    kernel_size: int = 3
    stride: int = 1
    bias: bool = True

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.in_ch * self.kernel_size ** 2)

    def init(self, gen: torch.Generator) -> dict:
        k = self.kernel_size
        params = {"weight": torch.randn((self.out_ch, self.in_ch, k, k),
                                        generator=gen)}
        if self.bias:
            bound = 1.0 / math.sqrt(self.in_ch * k * k)
            params["bias"] = (torch.rand((self.out_ch,), generator=gen)
                              * (2 * bound) - bound)
        return params

    def _grid(self, h: int, w: int) -> np.ndarray:
        raise NotImplementedError

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (B,H,W,C) whole equirectangular map -> (B,Ho,Wo,out_ch)."""
        _, h, w, _ = x.shape
        grid = torch.as_tensor(self._grid(h, w), device=x.device)
        sampled = nearest_grid_sample_shared(x, grid)
        y = conv2d_nhwc(sampled, params["weight"].to(x.dtype) * self.scale,
                        stride=self.kernel_size)
        if "bias" in params:
            y = y + params["bias"].to(x.dtype)
        return y


@dataclass(frozen=True)
class GlobalSphereConv2d(_SphereConvBase):
    """The output keeps the input lattice (one sample per stride-th
    input pixel)."""

    def _grid(self, h: int, w: int) -> np.ndarray:
        return _global_grid(h, w, self.kernel_size, self.stride)


@dataclass(frozen=True)
class IncreIntervalSphereConv2d(_SphereConvBase):
    """Border taps dropped and the centres re-spread with linspace: a
    stride-s conv shrinks (upsample=True: grows) the map and still covers
    the whole sphere."""
    upsample: bool = False

    def _grid(self, h: int, w: int) -> np.ndarray:
        return _incre_grid(h, w, self.kernel_size, self.stride,
                           self.upsample)
