"""Spherical convolutions on the row-offset-table path (counterpart of
spgan_tpu/geometry/sphere_conv.py: the fused-tables branches the panorama
engine runs and the sample-tables branch training runs).

* SphereStyledConv, tables_mode "fused" (inference): the 256 latent
  channels go through the fused sphere-conv kernel
  (ops/kernels/sphere_kernel.py); the 3 coordinate channels are
  grid-sampled, re-encoded and convolved with stride 3, exactly as the JAX
  package does.
* SphereStyledConv, tables_mode "sample" (training): latent and coordinate
  channels together go through the straight-through tap sampler
  (ops/kernels/sphere_sample.py), the coordinate taps are re-encoded, and
  one einsum over (tap, channel) applies the weight, through which weight
  and style gradients flow exactly.
* SphereStyledConv, tables_mode "grid": latent and coordinate channels
  through the straight-through bilinear 3x3 sampler on the per-pixel
  patch grid, then a stride-3 conv: the JAX package's path without
  tables, exact where the row-offset tables are not (the extrapolated
  windows of the training image grids).
* SphereSkipConv: the TS skip-path sphere conv (RGB 3->3) through the tap
  conv (ops/grid_sample.st_tap_conv), or on the patch grid when it is
  given no tables, identity init, LeakyReLU(0.01).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from spgan_tpu_torch.geometry.coords import encode_coords
from spgan_tpu_torch.ops.grid_sample import st_grid_sample_3x3, st_tap_conv
from spgan_tpu_torch.ops.kernels.sphere_kernel import (
    fused_sphere_conv, fused_sphere_conv_grouped)
from spgan_tpu_torch.ops.kernels.sphere_sample import st_sample_taps
from spgan_tpu_torch.ops.linear import conv2d_nhwc
from spgan_tpu_torch.ops.modulated import ModulatedConv2d


def _taps(w: torch.Tensor) -> torch.Tensor:
    """OIHW (out, in, k, k) -> (k*k, in, out), tap t = ti*k + tj."""
    o, i, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, i, o)


@dataclass(frozen=True)
class SphereStyledConv:
    """in_ch counts the coord channels (local_dim + coord_dim): the
    identity-init weight and the modulation span the concatenated
    channels."""

    local_dim: int
    coord_dim: int
    out_ch: int
    style_dim: int
    kernel_size: int = 3

    @property
    def in_ch(self) -> int:
        return self.local_dim + self.coord_dim

    def conv_spec(self) -> ModulatedConv2d:
        return ModulatedConv2d(
            in_ch=self.in_ch, out_ch=self.out_ch,
            kernel_size=self.kernel_size, style_dim=self.style_dim,
            demodulate=True, no_zero_pad=True, identity_init=True)

    def init(self, gen: torch.Generator) -> dict:
        return {"conv": self.conv_spec().init(gen)}

    def apply(self, params: dict, x: torch.Tensor, style: torch.Tensor,
              coords: torch.Tensor, grid: Optional[torch.Tensor],
              tables: dict, groups: int = 0,
              tables_mode: str = "fused") -> torch.Tensor:
        """x: (B,H,W,local_dim); coords: (B,H,W,coord_dim) raw indices;
        style: (B,style_dim).  grid (G,3H,3W,2) and tables (dict of
        (G,H,K2)) describe G patches, each shared by B//G consecutive
        samples when groups == G > 0; with groups == 0 there is one per
        sample.  tables_mode "sample" takes per-sample tables and no grid;
        "grid" a grid and no tables.  Output (B,H,W,out_ch), size
        preserving."""
        k = self.kernel_size
        ld = self.local_dim
        spec = self.conv_spec()
        s = spec.style_scale(params["conv"], style)            # (B,in_ch)
        wt = params["conv"]["weight"].to(x.dtype) * spec.scale
        demod = spec.demod_factors(params["conv"], s).to(x.dtype)
        s = s.to(x.dtype)

        w9 = _taps(wt)                                          # (K2,in,out)
        if tables_mode == "sample":
            if groups:
                raise ValueError("tables_mode 'sample' takes per-sample tables")
            both = torch.cat([x, coords.to(x.dtype)], dim=-1)
            taps = st_sample_taps(both, tables)                 # (B,K2,H,W,in)
            t_c = encode_coords(taps[..., ld:], self.coord_dim)
            taps = torch.cat([taps[..., :ld], t_c.to(x.dtype)], dim=-1)
            taps = taps * s[:, None, None, None, :]
            y = torch.einsum("bthwc,tco->bhwo", taps, w9)
            return y * demod[:, None, None, :]
        if tables_mode == "grid":
            both = torch.cat([x, coords.to(x.dtype)], dim=-1)
            sampled = st_grid_sample_3x3(both, grid, groups)  # (B,3H,3W,in)
            s_c = encode_coords(sampled[..., ld:], self.coord_dim)
            sampled = torch.cat([sampled[..., :ld], s_c.to(x.dtype)], dim=-1)
            y = conv2d_nhwc(sampled * s[:, None, None, :], wt, stride=k)
            return y * demod[:, None, None, :]
        if tables_mode != "fused":
            raise ValueError(f"tables_mode must be fused|sample|grid, got "
                             f"{tables_mode!r}")
        xs_main = x * s[:, None, None, :ld]
        w_main = w9[:, :ld].contiguous()
        if groups:
            y_main = fused_sphere_conv_grouped(xs_main, tables, w_main,
                                               groups=groups)
        else:
            y_main = fused_sphere_conv(xs_main, tables, w_main)
        cs = st_grid_sample_3x3(coords.to(x.dtype), grid, groups)
        enc = encode_coords(cs, self.coord_dim).to(x.dtype)
        enc = enc * s[:, None, None, ld:]
        y_coords = conv2d_nhwc(enc, wt[:, ld:], stride=k)
        return (y_main.to(x.dtype) + y_coords) * demod[:, None, None]


@dataclass(frozen=True)
class SphereSkipConv:
    """TS skip-path sphere conv (RGB 3->3), identity init, LeakyReLU(0.01)."""

    in_ch: int = 3
    out_ch: int = 3
    kernel_size: int = 3

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.in_ch * self.kernel_size ** 2)

    def init(self, gen: torch.Generator) -> dict:
        k = self.kernel_size
        w = torch.zeros((self.out_ch, self.in_ch, k, k))
        w[:, :, k // 2, k // 2] = 1.0
        bound = 1.0 / math.sqrt(self.in_ch * k * k)
        b = torch.rand((self.out_ch,), generator=gen) * (2 * bound) - bound
        return {"weight": w, "bias": b}

    def apply(self, params: dict, x: torch.Tensor, tables: Optional[dict],
              groups: int = 0, margin: int = 6,
              grid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tables (with their column margin), or with tables None the
        (B,3H,3W,2) patch grid."""
        wt = params["weight"].to(x.dtype) * self.scale
        if tables is None:
            y = conv2d_nhwc(st_grid_sample_3x3(x, grid, groups), wt,
                            stride=self.kernel_size)
        else:
            y = st_tap_conv(x, tables, _taps(wt), margin=margin,
                            groups=groups)
        y = y + params["bias"].to(x.dtype)
        return F.leaky_relu(y, 0.01)
