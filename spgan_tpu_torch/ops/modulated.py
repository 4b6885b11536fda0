"""Modulated (style) convolutions, StyledConv, ToRGB, noise injection
(counterpart of spgan_tpu/ops/modulated.py).

Same scale-input formulation as the JAX package:

    y[b] = demod[b] * conv(x[b] * s[b], scale * W)

Activations are NHWC at every public function; convolutions run on the
NCHW view of the NHWC tensor (channels-last memory, which cuDNN takes
directly).  Conv weights are stored torch-style, OIHW (out, in, kh, kw).

Outside autograd on a CUDA tensor, StyledConv ends in one hand-written
epilogue (ops/kernels/styled_epilogue.py) instead of five elementwise
passes: demodulation, noise, bias, LeakyReLU and gain in one read and one
write of the conv output (``StyledConv.uses_epilogue``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spgan_tpu_torch.ops.kernels import styled_epilogue as _ep
from spgan_tpu_torch.ops.linear import (EqualLinear, conv2d_nhwc,
                                       fused_leaky_relu)
from spgan_tpu_torch.ops.upfirdn import Blur, Upsample


def conv_transpose2_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """stride-2 transposed conv (torch conv_transpose2d(s=2, p=0)), output
    size 2H+k-2; the JAX package's zero-stuffing + full padding +
    flipped-kernel correlation is the same function."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.transpose(0, 1), stride=2)
    return y.permute(0, 2, 3, 1)


@dataclass(frozen=True)
class ModulatedConv2d:
    in_ch: int
    out_ch: int
    kernel_size: int
    style_dim: int
    demodulate: bool = True
    upsample: bool = False
    blur_kernel: Tuple[float, ...] = (1.0, 2.0, 1.0)
    no_zero_pad: bool = False
    identity_init: bool = False  # center-tap-1 init
    eps: float = 1e-8

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.in_ch * self.kernel_size ** 2)

    @property
    def dirty_rm_size(self) -> Tuple[int, int]:
        """Border rows/columns a no-pad conv leaves dirty."""
        if self.upsample:
            if self.no_zero_pad:
                p = len(self.blur_kernel) // 2
                return (p, p)
            return (0, 0)
        if self.no_zero_pad:
            return (self.kernel_size // 2, self.kernel_size // 2)
        return (0, 0)

    @property
    def padding(self) -> int:
        if self.upsample:
            return 0
        return 0 if self.no_zero_pad else self.kernel_size // 2

    def _blur(self, crop: int = 0) -> Blur:
        """The upsample's blur; with no_zero_pad, `crop` border pixels a
        side of its input are cropped by its pads (negative)."""
        if self.no_zero_pad:
            return Blur(self.blur_kernel, pad=(-crop, -crop),
                        upsample_factor=2)
        if len(self.blur_kernel) % 2 == 1:
            p = len(self.blur_kernel) // 2
            pad0 = pad1 = p
        else:
            p = (len(self.blur_kernel) - 2) - (self.kernel_size - 1)
            pad0 = (p + 1) // 2 + 1
            pad1 = p // 2 + 1
        return Blur(self.blur_kernel, pad=(pad0, pad1), upsample_factor=2)

    def modulation_spec(self) -> EqualLinear:
        return EqualLinear(self.style_dim, self.in_ch, bias_init=1.0)

    def init(self, gen: torch.Generator) -> dict:
        k = self.kernel_size
        if self.identity_init:
            # every (out,in) pair gets a 1 at the kernel center
            w = torch.zeros((self.out_ch, self.in_ch, k, k))
            w[:, :, k // 2, k // 2] = 1.0
        else:
            w = torch.randn((self.out_ch, self.in_ch, k, k), generator=gen)
        params = {"weight": w}
        if self.style_dim > 0:
            params["modulation"] = self.modulation_spec().init(gen)
        return params

    def style_scale(self, params: dict, style: torch.Tensor) -> torch.Tensor:
        """(B, style_dim) -> per-input-channel modulation (B, in_ch)."""
        return self.modulation_spec().apply(params["modulation"], style)

    def demod_factors(self, params: dict, s: torch.Tensor) -> torch.Tensor:
        """(B, in_ch) -> (B, out_ch) demodulation rsqrt factors."""
        w = params["weight"].to(s.dtype) * self.scale   # (out,in,k,k)
        w2 = torch.sum(torch.square(w), dim=(2, 3))       # (out, in)
        denom = torch.square(s) @ w2.t()
        return torch.rsqrt(denom + self.eps)

    def apply_spatial_style(self, params: dict, x: torch.Tensor,
                            style: torch.Tensor) -> torch.Tensor:
        """Spatially shaped styles (style fusion): style (B,Hs,Ws,style_dim)
        is center-cropped to x, the modulation applied per pixel and the
        demodulation estimated per pixel; after an upsample the demod map
        is resized (bilinear, align_corners) to the output."""
        style = align_spatial(style, x)
        sb, sh, sw, _ = style.shape
        s_map = self.modulation_spec().apply(
            params["modulation"], style.reshape(-1, self.style_dim))
        s_map = s_map.reshape(sb, sh, sw, self.in_ch)
        xs = x * s_map.to(x.dtype)
        w = params["weight"].to(x.dtype) * self.scale
        if self.demodulate:
            w2 = torch.sum(torch.square(w), dim=(2, 3))    # (out, in)
            demod = torch.rsqrt(torch.einsum(
                "bhwi,oi->bhwo", torch.square(s_map), w2.to(s_map.dtype))
                + self.eps).to(x.dtype)
        if self.upsample:
            y = conv_transpose2_nhwc(xs, w)[:, 1:-1, 1:-1, :]
            if self.demodulate:
                # imported here: infer.calibrate imports the ops package
                from spgan_tpu_torch.infer.calibrate import (
                    resize_align_corners)

                demod = resize_align_corners(demod, y.shape[1], y.shape[2])
                y = y * demod.to(x.dtype)
            return self._blur()(y)
        y = conv2d_nhwc(xs, w, padding=self.padding)
        if self.demodulate:
            if self.padding == 0:
                d0, d1 = self.dirty_rm_size
                demod = demod[:, d0:sh - d0, d1:sw - d1]
            y = y * demod
        return y

    def _modulated_input(self, params: dict, x: torch.Tensor,
                         style: torch.Tensor):
        """A per-sample style's (s, scaled weight, x * s)."""
        s = (self.style_scale(params, style)
             if style.shape[-1] == self.style_dim else style)
        w = params["weight"].to(x.dtype) * self.scale
        return s, w, x * s[:, None, None, :].to(x.dtype)

    def apply(self, params: dict, x: torch.Tensor, style: torch.Tensor
              ) -> torch.Tensor:
        """x: (B,H,W,in_ch); style: (B,style_dim), or (B,in_ch) already
        modulated, or (B,Hs,Ws,style_dim) spatially shaped
        (apply_spatial_style).  Returns NHWC; upsample: 2H-1-2 after the
        blur for a length-3 blur kernel; plain: H - 2*(k//2) when
        no_zero_pad."""
        if style.ndim == 4:
            return self.apply_spatial_style(params, x, style)
        s, w, xs = self._modulated_input(params, x, style)
        if self.demodulate:
            demod = self.demod_factors(params, s).to(x.dtype)
        if self.upsample:
            y = conv_transpose2_nhwc(xs, w)
            if self.no_zero_pad:
                y = y[:, 1:-1, 1:-1, :]
            if self.demodulate:
                y = y * demod[:, None, None, :]
            return self._blur()(y)
        y = conv2d_nhwc(xs, w, padding=self.padding)
        if self.demodulate:
            y = y * demod[:, None, None, :]
        return y

    def apply_undemodulated(self, params: dict, x: torch.Tensor,
                            style: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``apply`` of a per-sample style (demodulate True) less its last
        multiply: (y, demod) with apply(...) = y * demod[:, None, None, :]
        in real arithmetic; demod (B, out_ch) in float32.  On an upsample
        the demodulation moves past the blur (it is constant over (h, w)
        and the blur is linear and per channel), and the blur takes the
        conv's output whole, the one-pixel crop of no_zero_pad folded
        into its pads."""
        s, w, xs = self._modulated_input(params, x, style)
        demod = self.demod_factors(params, s.float())
        if self.upsample:
            y = conv_transpose2_nhwc(xs, w)
            return self._blur(crop=int(self.no_zero_pad))(y), demod
        # the epilogue writes over y, which it takes contiguous in NHWC
        return conv2d_nhwc(xs, w, padding=self.padding).contiguous(), demod


@dataclass(frozen=True)
class NoiseInjection:
    """x + w * noise, with the noise always passed explicitly (training
    draws every noise map in train/step.py's draw)."""

    def init(self) -> dict:
        return {"weight": torch.zeros(())}

    def apply(self, params: dict, x: torch.Tensor,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            return x
        return x + params["weight"].to(x.dtype) * noise


@dataclass(frozen=True)
class ConstantInput:
    """A learned (1, size, size, channel) input, tiled over the batch."""

    channel: int
    size: int = 4

    def init(self, gen: torch.Generator) -> dict:
        return {"input": torch.randn((1, self.size, self.size, self.channel),
                                     generator=gen)}

    def apply(self, params: dict, batch: int) -> torch.Tensor:
        return params["input"].expand(batch, -1, -1, -1)


@dataclass(frozen=True)
class StyledConv:
    """ModulatedConv2d + noise injection + fused bias LeakyReLU*sqrt(2);
    activation "lrelu_plain": plain LeakyReLU(0.01), no bias, no sqrt(2)
    gain (the reference's gs-variant "LeakyReLU_n")."""

    conv: ModulatedConv2d
    disable_noise: bool = False
    activation: str = "fused_lrelu"  # "fused_lrelu" | "lrelu_plain"

    def init(self, gen: torch.Generator) -> dict:
        params = {"conv": self.conv.init(gen)}
        if not self.disable_noise:
            params["noise"] = NoiseInjection().init()
        if self.activation == "fused_lrelu":
            params["act_bias"] = torch.zeros((self.conv.out_ch,))
        return params

    def uses_epilogue(self, x: torch.Tensor, style: torch.Tensor) -> bool:
        """Whether ``apply`` ends in the hand-written epilogue: x on a CUDA
        device outside autograd (the render engine runs under
        inference_mode), fused_lrelu, a demodulated conv with a
        per-sample style, and a dtype and width the kernel takes.
        Everything else composes the ops (the CPU, the training step,
        lrelu_plain, spatial styles)."""
        return (x.is_cuda and not torch.is_grad_enabled()
                and self.activation == "fused_lrelu"
                and self.conv.demodulate and style.ndim != 4
                and _ep.takes(x.dtype, self.conv.out_ch))

    def apply_epilogue(self, params: dict, x: torch.Tensor,
                       style: torch.Tensor,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``apply`` through ``apply_undemodulated`` and the epilogue (the
        kernel on a CUDA tensor, its plain version on a CPU one): the
        same function, the demodulation after an upsample's blur."""
        y, demod = self.conv.apply_undemodulated(params["conv"], x, style)
        nw = None
        if self.disable_noise or noise is None:
            noise = None
        else:
            b, h, w, _ = y.shape
            noise = noise.to(y.dtype).expand(b, h, w, 1).contiguous()
            nw = params["noise"]["weight"]
        return _ep.styled_epilogue(y, demod, params["act_bias"], noise, nw)

    def apply(self, params: dict, x: torch.Tensor, style: torch.Tensor,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.uses_epilogue(x, style):
            return self.apply_epilogue(params, x, style, noise)
        y = self.conv.apply(params["conv"], x, style)
        if not self.disable_noise:
            y = NoiseInjection().apply(params["noise"], y, noise=noise)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, params["act_bias"])
        return F.leaky_relu(y, 0.01)


def align_spatial(source: Optional[torch.Tensor], target: torch.Tensor):
    """Center-crop `source` (NHWC) to `target`'s spatial size."""
    if source is None:
        return None
    sh, sw = source.shape[1], source.shape[2]
    th, tw = target.shape[1], target.shape[2]
    if (sh, sw) == (th, tw):
        return source
    if (sh - th) % 2 or (sw - tw) % 2:
        raise ValueError(f"cannot center-crop {tuple(source.shape)} to "
                         f"{tuple(target.shape)}")
    h0 = (sh - th) // 2
    w0 = (sw - tw) // 2
    return source[:, h0:h0 + th, w0:w0 + tw, :]


@dataclass(frozen=True)
class ToRGB:
    in_ch: int
    style_dim: int
    blur_kernel: Tuple[float, ...] = (1.0, 2.0, 1.0)
    no_zero_pad: bool = False

    def conv_spec(self) -> ModulatedConv2d:
        return ModulatedConv2d(
            in_ch=self.in_ch, out_ch=3, kernel_size=1,
            style_dim=self.style_dim, demodulate=False,
            no_zero_pad=self.no_zero_pad, blur_kernel=self.blur_kernel)

    def init(self, gen: torch.Generator) -> dict:
        return {"conv": self.conv_spec().init(gen),
                "bias": torch.zeros((1, 1, 1, 3))}

    def apply(self, params: dict, x: torch.Tensor, style: torch.Tensor,
              skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv_spec().apply(params["conv"], x, style)
        out = out + params["bias"].to(out.dtype)
        if skip is not None:
            up = Upsample(self.blur_kernel, no_zero_pad=self.no_zero_pad)
            skip = up(skip)
            if self.no_zero_pad:
                skip = align_spatial(skip, out)
            out = out + skip
        return out
