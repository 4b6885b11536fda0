"""Equalized-LR linear and conv layers and activations (counterpart of
spgan_tpu/ops/linear.py).

Specs are frozen dataclasses holding static hyperparameters; ``init``
returns a parameter dict of float32 tensors and ``apply`` is a plain
function of (params, inputs).  Weights are stored torch-style: linear
(out, in), conv OIHW.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """NHWC activations, OIHW weight -> NHWC output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def pixel_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8
               ) -> torch.Tensor:
    """x * rsqrt(mean(x^2, channel) + eps). Channel-last by default."""
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True)
                           + eps)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = SQRT2
                     ) -> torch.Tensor:
    """bias-add + LeakyReLU + sqrt(2) gain (channel-last bias broadcast).

    The bias is cast to x's dtype: adding a float32 bias to bf16
    activations would promote every downstream feature map to float32."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2
                      ) -> torch.Tensor:
    """LeakyReLU * sqrt(2), without a bias."""
    return F.leaky_relu(x, negative_slope) * SQRT2


@dataclass(frozen=True)
class EqualLinear:
    in_dim: int
    out_dim: int
    bias: bool = True
    bias_init: float = 0.0
    lr_mul: float = 1.0
    activation: Optional[str] = None  # None | "fused_lrelu"

    @property
    def scale(self) -> float:
        return (1.0 / math.sqrt(self.in_dim)) * self.lr_mul

    def init(self, gen: torch.Generator) -> dict:
        w = torch.randn((self.out_dim, self.in_dim), generator=gen)
        params = {"weight": w / self.lr_mul}
        if self.bias:
            params["bias"] = torch.full((self.out_dim,), self.bias_init)
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        w = params["weight"].to(x.dtype) * self.scale
        y = x @ w.t()
        b = params.get("bias")
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(
                y, None if b is None else b.to(x.dtype) * self.lr_mul)
        if b is not None:
            y = y + b.to(x.dtype) * self.lr_mul
        return y


@dataclass(frozen=True)
class EqualConv2d:
    """Equalized conv: NHWC activations, OIHW weight, symmetric zero
    padding."""

    in_ch: int
    out_ch: int
    kernel_size: int
    stride: int = 1
    padding: int = 0
    bias: bool = True

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.in_ch * self.kernel_size ** 2)

    def init(self, gen: torch.Generator) -> dict:
        k = self.kernel_size
        params = {"weight": torch.randn((self.out_ch, self.in_ch, k, k),
                                        generator=gen)}
        if self.bias:
            params["bias"] = torch.zeros((self.out_ch,))
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        w = params["weight"].to(x.dtype) * self.scale
        y = conv2d_nhwc(x, w, stride=self.stride, padding=self.padding)
        if "bias" in params:
            y = y + params["bias"].to(x.dtype)
        return y
