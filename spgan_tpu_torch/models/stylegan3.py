"""StyleGAN3-T's generator (Karras et al., "Alias-Free Generative
Adversarial Networks", NeurIPS 2021; NVlabs stylegan3
``training/networks_stylegan3.py``), in the port's idiom: frozen specs
with ``init`` / ``apply``, nested parameter dicts, NHWC activations.

    z -> mapping (2 layers) -> w, one per layer (num_layers + 2 of them)
      -> Fourier-feature input (512 features at 36x36, rotated and
         translated by an affine of w)
      -> L0 .. L13: modulated 3x3 conv with padding k - 1, then the
         filtered LeakyReLU (ops/filtered_lrelu.py), each layer at its own
         cutoff, stopband, sampling rate and size
      -> L14, ToRGB: 1x1 conv, not demodulated, bias and clamp
      -> x output_scale

Every number of the layer schedule follows from the ``stylegan3`` section
of the config (config.StyleGAN3Params) by NVlabs' equations
(``schedule``).  Layers whose sampling rate exceeds img_resolution /
2**num_fp16_res compute in float16 on the card (L5-L14 at 1024x1024),
the others in float32; on the CPU every layer computes in float32, as
NVlabs' layers do.  The precision is num_fp16_res's alone: the config's
compute_dtype (an SP-GAN setting) must be float32, which also keeps TF32
off in the CLI.

The parameter tree carries NVlabs' names: ``{"mapping": {"fc0", "fc1",
"w_avg"}, "synthesis": {"input": {...}, "L0_36_512": {...}, ...}}``, so a
state dict of NVlabs' Generator maps onto it key for key
(``Generator.params_from_state_dict``).

Spans (utils/trace.py): ``spgan.sg3.input`` around the Fourier input and
``spgan.sg3.filtered_lrelu`` around each layer's filtered LeakyReLU (not
the ToRGB's bias and clamp); counters ``spgan.sg3.layers_fp16`` and
``spgan.sg3.layers_fp32`` count the layers run in the low precision and
in float32.  Inference only: no training step takes this generator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spgan_tpu_torch.config import Config, StyleGAN3Params
from spgan_tpu_torch.ops.filtered_lrelu import (design_lowpass_filter,
                                               filtered_lrelu)
from spgan_tpu_torch.ops.linear import EqualLinear, conv2d_nhwc, pixel_norm
from spgan_tpu_torch.utils import trace


@dataclass(frozen=True)
class LayerSpec:
    """One synthesis layer's numbers (SynthesisLayer.__init__)."""

    name: str
    is_torgb: bool
    is_critically_sampled: bool
    use_fp16: bool
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    conv_kernel: int
    up_factor: int
    down_factor: int
    up_taps: int
    down_taps: int
    padding: Tuple[int, int, int, int]   # (px0, px1, py0, py1)


@dataclass(frozen=True)
class InputSpec:
    """The Fourier-feature input's numbers (SynthesisInput.__init__)."""

    channels: int
    size: int
    sampling_rate: float
    bandwidth: float


def schedule(sg: StyleGAN3Params) -> Tuple[InputSpec, List[LayerSpec]]:
    """SynthesisNetwork.__init__'s progression of cutoffs, stopbands,
    sampling rates, sizes and widths, and each layer's resampling factors,
    filter lengths and padding."""
    if sg.use_radial_filters:
        raise NotImplementedError("use_radial_filters (StyleGAN3-R) is not "
                                  "ported; StyleGAN3-T sets it false")
    n, res = sg.num_layers, sg.img_resolution
    last_cutoff = res / 2
    last_stopband = last_cutoff * sg.last_stopband_rel
    exponents = np.minimum(np.arange(n + 1) / (n - sg.num_critical), 1)
    cutoffs = sg.first_cutoff * (last_cutoff / sg.first_cutoff) ** exponents
    stopbands = sg.first_stopband * (
        last_stopband / sg.first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + sg.margin_size * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((sg.channel_base / 2) / cutoffs,
                                  sg.channel_max))
    channels[-1] = sg.img_channels
    inp = InputSpec(channels=int(channels[0]), size=int(sizes[0]),
                    sampling_rate=float(rates[0]),
                    bandwidth=float(cutoffs[0]))
    layers = []
    for idx in range(n + 1):
        prev = max(idx - 1, 0)
        torgb = idx == n
        in_sr, out_sr = int(rates[prev]), int(rates[idx])
        tmp_sr = max(in_sr, out_sr) * (1 if torgb else sg.lrelu_upsampling)
        up = int(np.rint(tmp_sr / in_sr))
        down = int(np.rint(tmp_sr / out_sr))
        up_taps = sg.filter_size * up if up > 1 and not torgb else 1
        down_taps = sg.filter_size * down if down > 1 and not torgb else 1
        k = 1 if torgb else sg.conv_kernel
        pad_total = ((int(sizes[idx]) - 1) * down + 1
                     - (int(sizes[prev]) + k - 1) * up
                     + up_taps + down_taps - 2)
        pad_lo = (pad_total + up) // 2
        pad_hi = pad_total - pad_lo
        layers.append(LayerSpec(
            name=f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}",
            is_torgb=torgb,
            is_critically_sampled=idx >= n - sg.num_critical,
            use_fp16=bool(rates[idx] * 2 ** sg.num_fp16_res > res),
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=int(sizes[prev]), out_size=int(sizes[idx]),
            in_sampling_rate=in_sr, out_sampling_rate=out_sr,
            in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
            in_half_width=float(half_widths[prev]),
            out_half_width=float(half_widths[idx]),
            conv_kernel=k, up_factor=up, down_factor=down,
            up_taps=up_taps, down_taps=down_taps,
            padding=(pad_lo, pad_hi, pad_lo, pad_hi)))
    return inp, layers


@dataclass(frozen=True)
class FourierInput:
    """SynthesisInput: `channels` sinusoids of random frequencies in a disc
    of radius `bandwidth`, sampled on a size x size grid at
    `sampling_rate`, rotated and translated by an affine of w, and mixed
    by a learned channels x channels matrix.  NHWC output, float32."""

    spec: InputSpec
    w_dim: int

    def affine_spec(self) -> EqualLinear:
        return EqualLinear(self.w_dim, 4)

    def init(self, gen: torch.Generator) -> dict:
        c, bw = self.spec.channels, self.spec.bandwidth
        freqs = torch.randn((c, 2), generator=gen)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bw
        phases = torch.rand((c,), generator=gen) - 0.5
        return {"weight": torch.randn((c, c), generator=gen),
                # weight_init 0, bias_init [1, 0, 0, 0]: the identity
                "affine": {"weight": torch.zeros((4, self.w_dim)),
                           "bias": torch.tensor([1.0, 0.0, 0.0, 0.0])},
                "transform": torch.eye(3), "freqs": freqs, "phases": phases}

    def apply(self, params: dict, w: torch.Tensor) -> torch.Tensor:
        sp = self.spec
        b, dev = w.shape[0], w.device
        t = self.affine_spec().apply(params["affine"], w)   # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=dev).unsqueeze(0).repeat(b, 1, 1)
        m_r[:, 0, 0] = t[:, 0]
        m_r[:, 0, 1] = -t[:, 1]
        m_r[:, 1, 0] = t[:, 1]
        m_r[:, 1, 1] = t[:, 0]
        m_t = torch.eye(3, device=dev).unsqueeze(0).repeat(b, 1, 1)
        m_t[:, 0, 2] = -t[:, 2]
        m_t[:, 1, 2] = -t[:, 3]
        transforms = m_r @ m_t @ params["transform"].unsqueeze(0)
        freqs = params["freqs"].unsqueeze(0)
        phases = (params["phases"].unsqueeze(0)
                  + (freqs @ transforms[:, :2, 2:]).squeeze(2))
        freqs = freqs @ transforms[:, :2, :2]                 # (B, C, 2)
        amplitudes = (1 - (freqs.norm(dim=2) - sp.bandwidth)
                      / (sp.sampling_rate / 2 - sp.bandwidth)).clamp(0, 1)
        theta = torch.eye(2, 3, device=dev)
        theta[0, 0] = 0.5 * sp.size / sp.sampling_rate
        theta[1, 1] = 0.5 * sp.size / sp.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, sp.size, sp.size],
                              align_corners=False)            # (1, H, W, 2)
        x = grids.reshape(1, sp.size * sp.size, 2) @ freqs.transpose(1, 2)
        x = x.reshape(b, sp.size, sp.size, -1) + phases[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
        weight = params["weight"] / math.sqrt(sp.channels)
        return x @ weight.t()


@dataclass(frozen=True)
class SynthesisLayer:
    """One of L0 .. L14: the modulated conv (``modulated_conv``, with
    StyleGAN3's prenormalization, padding k - 1 and input gain
    magnitude_ema ** -0.5), then the filtered LeakyReLU, or for the ToRGB
    layer (1x1, not demodulated, style gain 1/sqrt(in_channels)) the bias
    and the clamp."""

    spec: LayerSpec
    w_dim: int
    conv_clamp: Optional[float]
    up_filter: Optional[Tuple[float, ...]]
    down_filter: Optional[Tuple[float, ...]]

    @classmethod
    def build(cls, spec: LayerSpec, w_dim: int,
              conv_clamp: Optional[float]) -> "SynthesisLayer":
        def design(taps, cutoff, half_width):
            f = design_lowpass_filter(taps, cutoff, half_width * 2,
                                      spec.up_factor * spec.in_sampling_rate)
            return None if f is None else tuple(f.tolist())

        return cls(spec=spec, w_dim=w_dim, conv_clamp=conv_clamp,
                   up_filter=design(spec.up_taps, spec.in_cutoff,
                                    spec.in_half_width),
                   down_filter=design(spec.down_taps, spec.out_cutoff,
                                      spec.out_half_width))

    def affine_spec(self) -> EqualLinear:
        return EqualLinear(self.w_dim, self.spec.in_channels, bias_init=1.0)

    def init(self, gen: torch.Generator) -> dict:
        sp = self.spec
        k = sp.conv_kernel
        return {"affine": self.affine_spec().init(gen),
                "weight": torch.randn((sp.out_channels, sp.in_channels, k, k),
                                      generator=gen),
                "bias": torch.zeros((sp.out_channels,)),
                "magnitude_ema": torch.ones(())}

    def modulated_conv(self, params: dict, x: torch.Tensor, w: torch.Tensor,
                       dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """NVlabs' modulated_conv2d less its demodulation multiply: (y,
        demod), y the conv of x * s * input_gain in `dtype` with padding
        k - 1, demod (B, out_channels) float32, or None for the ToRGB.
        The weight (per output channel) and the style (over the whole
        (B, in_channels) tensor) are prenormalized to unit RMS in float32;
        the ToRGB's style gain 1/sqrt(in_channels * k * k) rides on its
        weight.  The input gain is magnitude_ema ** -0.5."""
        sp = self.spec
        s = self.affine_spec().apply(params["affine"], w)
        weight = params["weight"]
        demod = None
        if sp.is_torgb:
            weight = weight.to(dtype) * (
                1 / math.sqrt(sp.in_channels * sp.conv_kernel ** 2))
        else:
            weight = weight * torch.rsqrt(torch.mean(
                torch.square(weight), dim=(1, 2, 3), keepdim=True))
            s = s * torch.rsqrt(torch.mean(torch.square(s)))
            w2 = torch.sum(torch.square(weight), dim=(2, 3))   # (out, in)
            demod = torch.rsqrt(torch.square(s) @ w2.t() + 1e-8)
            weight = weight.to(dtype)
        xs = s * torch.rsqrt(params["magnitude_ema"])
        x = x.to(dtype) * xs[:, None, None, :].to(dtype)
        # filtered_lrelu takes y contiguous in NHWC
        return conv2d_nhwc(x, weight,
                           padding=sp.conv_kernel - 1).contiguous(), demod

    def apply(self, params: dict, x: torch.Tensor, w: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """x (B, in_size, in_size, in_channels) -> (B, out_size, out_size,
        out_channels) in `dtype`; w (B, w_dim)."""
        sp = self.spec
        y, demod = self.modulated_conv(params, x, w, dtype)
        if sp.is_torgb:
            y = y + params["bias"].to(dtype)
            return y if self.conv_clamp is None else y.clamp(
                -self.conv_clamp, self.conv_clamp)
        with trace.span("spgan.sg3.filtered_lrelu"):
            return filtered_lrelu(
                y, self.up_filter, self.down_filter, params["bias"], demod,
                up=sp.up_factor,
                down=sp.down_factor, padding=sp.padding, gain=math.sqrt(2),
                slope=0.2, clamp=self.conv_clamp)


@dataclass(frozen=True)
class Generator:
    """NVlabs' Generator (c_dim 0): mapping, then synthesis."""

    z_dim: int
    w_dim: int
    img_resolution: int
    img_channels: int
    mapping_layers: int
    input: FourierInput
    layers: Tuple[SynthesisLayer, ...]
    output_scale: float = 0.25
    lr_multiplier: float = 0.01     # the mapping's (MappingNetwork)

    @classmethod
    def from_config(cls, cfg: Config) -> "Generator":
        if cfg.train_params.compute_dtype != "float32":
            raise ValueError(
                "StyleGAN3's layers compute in float16 or float32 by "
                "stylegan3.num_fp16_res; compute_dtype must be float32, got "
                f"{cfg.train_params.compute_dtype!r}")
        sg = cfg.stylegan3
        inp, specs = schedule(sg)
        return cls(
            z_dim=sg.z_dim, w_dim=sg.w_dim, img_resolution=sg.img_resolution,
            img_channels=sg.img_channels,
            mapping_layers=int(sg.mapping_kwargs.get("num_layers", 2)),
            input=FourierInput(inp, sg.w_dim),
            layers=tuple(SynthesisLayer.build(s, sg.w_dim, sg.conv_clamp)
                         for s in specs),
            output_scale=sg.output_scale)

    @property
    def num_ws(self) -> int:
        return len(self.layers) + 1

    def _fc(self, idx: int) -> EqualLinear:
        return EqualLinear(self.z_dim if idx == 0 else self.w_dim, self.w_dim,
                           lr_mul=self.lr_multiplier, activation="fused_lrelu")

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from `gen` (a CPU generator) by NVlabs' init,
        placed on `device`; every magnitude_ema 1, w_avg 0."""
        from spgan_tpu_torch.device import resolve

        mapping = {f"fc{i}": self._fc(i).init(gen)
                   for i in range(self.mapping_layers)}
        mapping["w_avg"] = torch.zeros((self.w_dim,))
        synthesis = {"input": self.input.init(gen)}
        for layer in self.layers:
            synthesis[layer.spec.name] = layer.init(gen)
        params = {"mapping": mapping, "synthesis": synthesis}
        dev = resolve(device)
        return _tree_to(params, dev)

    @staticmethod
    def params_from_state_dict(state: Dict[str, torch.Tensor], device=None
                               ) -> dict:
        """The parameter tree of a state dict of NVlabs' Generator (keys
        ``mapping.fc0.weight``, ``synthesis.L3_52_512.magnitude_ema``, ...);
        the filter buffers (``up_filter``, ``down_filter``), which the
        schedule designs anew, are left out."""
        from spgan_tpu_torch.device import resolve

        tree: dict = {}
        for key, value in state.items():
            *path, leaf = key.split(".")
            if leaf in ("up_filter", "down_filter"):
                continue
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.as_tensor(value, dtype=torch.float32)
        return _tree_to(tree, resolve(device))

    @staticmethod
    def layer_dtype(layer: SynthesisLayer, device: torch.device
                    ) -> torch.dtype:
        """float16 for the layers above the float32 head on the card;
        float32 for the others and everywhere on the CPU."""
        if layer.spec.use_fp16 and device.type == "cuda":
            return torch.float16
        return torch.float32

    def mapping(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """z (B, z_dim) -> w (B, w_dim): normalize_2nd_moment, the FC
        layers (LeakyReLU, lr multiplier 0.01); truncation psi 1 (w_avg,
        kept for NVlabs' state dicts, is not read)."""
        x = pixel_norm(z.float())
        for i in range(self.mapping_layers):
            x = self._fc(i).apply(params["mapping"][f"fc{i}"], x)
        return x

    def synthesis(self, params: dict, ws: torch.Tensor) -> torch.Tensor:
        """ws (B, num_ws, w_dim) -> images (B, R, R, img_channels),
        float32, NHWC."""
        p = params["synthesis"]
        with trace.span("spgan.sg3.input"):
            x = self.input.apply(p["input"], ws[:, 0])
        for i, layer in enumerate(self.layers):
            dtype = self.layer_dtype(layer, ws.device)
            trace.count("spgan.sg3.layers_fp32" if dtype == torch.float32
                        else "spgan.sg3.layers_fp16")
            x = layer.apply(p[layer.spec.name], x, ws[:, i + 1], dtype)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()

    def apply(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """z (B, z_dim) -> images (B, R, R, img_channels), float32 NHWC,
        every layer on the same w (no style mixing)."""
        w = self.mapping(params, z)
        return self.synthesis(params, w[:, None].expand(-1, self.num_ws, -1))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
