"""StyleGAN2 patch discriminator with the auxiliary coordinate head
(counterpart of spgan_tpu/models/discriminator.py, the shipped config).

  * ConvLayer: optional [1,3,3,1] blur + stride-2 equalized conv
    (downsample), or a zero-padded equalized conv; fused bias LeakyReLU.
  * ResBlock: (conv1 + conv2-down + 1x1 skip-down) / sqrt(2).
  * 1x1 stem, log2(101) ~ 7 -> 5 ResBlocks (101 -> 3), minibatch stddev,
    final 3x3 conv, the NCHW flatten of the reference (checkpoint order),
    two linears -> d_patch and, with coord_use_ac, two linears ->
    ac_coords_pred.
  * the projection head (coord_use_pd): at training time the ac label (its
    last coord_proj_dim entries) goes through two linears and
    coord_pd_w * <label_proj, sum_hw(feature entering the last ResBlock)>
    is added to d_patch.
  * the categorical AC head (coord_ac_categorical) widens the coord
    head's output to num_dir * vert_sample_size.  The reference's
    categorical loss branch is unreachable (its loss returns on
    vert_only first, and categorical requires vert_only), so only the
    head's shape changes.

stddev_group: _smallest_divisor_at_least(batch=16, 4) returns 16 (the
search range(4, 4) is empty), so the statistic spans the whole batch, as
in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from portbench.reference.spgan.config import Config
from portbench.reference.spgan.ops.linear import EqualConv2d, EqualLinear, fused_leaky_relu
from portbench.reference.spgan.ops.upfirdn import Blur
from portbench.reference.spgan.tree import tree_map


def _smallest_divisor_at_least(number: int, start: int = 4) -> int:
    for i in range(start, int(math.sqrt(number))):
        if number % i == 0:
            return i
    return number


@dataclass(frozen=True)
class ConvLayer:
    in_ch: int
    out_ch: int
    kernel_size: int
    downsample: bool = False
    activate: bool = True
    bias: bool = True
    blur_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0)

    def conv_spec(self) -> EqualConv2d:
        stride = 2 if self.downsample else 1
        pad = 0 if self.downsample else self.kernel_size // 2
        return EqualConv2d(self.in_ch, self.out_ch, self.kernel_size,
                           stride=stride, padding=pad,
                           bias=self.bias and not self.activate)

    def init(self, gen: torch.Generator) -> dict:
        params = {"conv": self.conv_spec().init(gen)}
        if self.activate and self.bias:
            params["act_bias"] = torch.zeros((self.out_ch,))
        return params

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            k = len(self.blur_kernel)
            p = (k - 2) + (self.kernel_size - 1)
            x = Blur(self.blur_kernel, pad=((p + 1) // 2, p // 2))(x)
        y = self.conv_spec().apply(params["conv"], x)
        if self.activate:
            y = fused_leaky_relu(y, params.get("act_bias"))
        return y


@dataclass(frozen=True)
class ResBlock:
    in_ch: int
    out_ch: int

    def layers(self):
        return (ConvLayer(self.in_ch, self.in_ch, 3),
                ConvLayer(self.in_ch, self.out_ch, 3, downsample=True),
                ConvLayer(self.in_ch, self.out_ch, 1, downsample=True,
                          activate=False, bias=False))

    def init(self, gen: torch.Generator) -> dict:
        c1, c2, sk = self.layers()
        return {"conv1": c1.init(gen), "conv2": c2.init(gen),
                "skip": sk.init(gen)}

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        c1, c2, sk = self.layers()
        out = c2(params["conv2"], c1(params["conv1"], x))
        return (out + sk(params["skip"], x)) / math.sqrt(2.0)


def _stddev_channel(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B,H,W,1): the per-group feature stddev (biased variance over each
    group of B//group-strided samples), averaged, tiled over the group."""
    b, h, w, c = x.shape
    g = min(b, group)
    y = x.reshape(g, b // g, h, w, c)
    var = y.var(dim=0, unbiased=False)
    std = torch.sqrt(var + 1e-8)
    mean_std = std.mean(dim=(1, 2, 3), keepdim=True)      # (b//g,1,1,1)
    return mean_std.repeat(g, h, w, 1)


def minibatch_stddev(x: torch.Tensor, group: int) -> torch.Tensor:
    """x: (B,H,W,C).  Appends one channel of the per-group feature
    stddev."""
    return torch.cat([x, _stddev_channel(x, group)], dim=-1)


@dataclass(frozen=True)
class Discriminator:
    patch_size: int = 101
    channel_multiplier: int = 2
    batch_size: int = 16
    use_coord_ac: bool = True
    coord_num_dir: int = 3
    linear_ch: int = 512
    extra_multiplier: float = 1.0
    use_coord_pd: bool = False
    coord_pd_w: float = 0.0
    coord_pd_hori_only: bool = False
    coord_ac_categorical: bool = False
    coord_vert_sample_size: int = 10

    @classmethod
    def from_config(cls, cfg: Config) -> "Discriminator":
        tp = cfg.train_params
        return cls(patch_size=tp.patch_size,
                   channel_multiplier=tp.channel_multiplier,
                   linear_ch=round(512 * tp.d_extra_multiplier),
                   extra_multiplier=tp.d_extra_multiplier,
                   batch_size=tp.batch_size,
                   use_coord_ac=tp.coord_use_ac,
                   coord_num_dir=tp.coord_num_dir,
                   use_coord_pd=tp.coord_use_pd,
                   coord_pd_w=tp.coord_pd_w,
                   coord_pd_hori_only=tp.coord_pd_hori_only,
                   coord_ac_categorical=tp.coord_ac_categorical,
                   coord_vert_sample_size=tp.coord_vert_sample_size)

    @property
    def coord_proj_dim(self) -> int:
        return (self.coord_num_dir - 1 if self.coord_pd_hori_only
                else self.coord_num_dir)

    @property
    def ac_out_dim(self) -> int:
        if self.coord_ac_categorical:
            return self.coord_num_dir * self.coord_vert_sample_size
        return self.coord_num_dir

    def channels(self) -> dict:
        cm = self.channel_multiplier
        base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm,
                128: 128 * cm, 256: 64 * cm, 512: 32 * cm, 1024: 16 * cm,
                2048: 8 * cm}
        if self.extra_multiplier != 1.0:
            base = {k: round(v * self.extra_multiplier)
                    for k, v in base.items()}
        return base

    @property
    def log_size(self) -> int:
        return int(round(math.log(self.patch_size, 2)))

    @property
    def stddev_group(self) -> int:
        return _smallest_divisor_at_least(self.batch_size, 4)

    def plan(self):
        ch = self.channels()
        stem = ConvLayer(3, ch[2 ** self.log_size], 1)
        blocks = []
        in_ch = ch[2 ** self.log_size]
        size = self.patch_size
        for i in range(self.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            blocks.append(ResBlock(in_ch, out_ch))
            in_ch = out_ch
            size //= 2
        final_conv = ConvLayer(in_ch + 1, self.linear_ch, 3)
        return stem, blocks, final_conv, self.linear_ch * size * size

    def _heads(self, flat: int):
        """The d_patch, coord-AC and projection heads' linear pairs."""
        lc = self.linear_ch
        return ((EqualLinear(flat, lc, activation="fused_lrelu"),
                 EqualLinear(lc, 1)),
                (EqualLinear(flat, lc, activation="fused_lrelu"),
                 EqualLinear(lc, self.ac_out_dim)),
                (EqualLinear(self.coord_proj_dim, lc,
                             activation="fused_lrelu"),
                 EqualLinear(lc, lc)))

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from `gen` (a CPU generator), on `device`
        (default cuda)."""
        from portbench.reference.spgan.device import resolve
        from portbench.reference.spgan.models.generator import _tree_to

        stem, blocks, final_conv, flat = self.plan()
        (l1, l2), (c1, c2), (p1, p2) = self._heads(flat)
        params = {"stem": stem.init(gen),
                  "blocks": [b.init(gen) for b in blocks],
                  "final_conv": final_conv.init(gen),
                  "final_linear": [l1.init(gen), l2.init(gen)]}
        if self.use_coord_ac:
            params["coord_linear"] = [c1.init(gen), c2.init(gen)]
        if self.use_coord_pd:
            params["coord_proj"] = [p1.init(gen), p2.init(gen)]
        return _tree_to(params, resolve(device))

    def r1_graph_mask(self, params: dict) -> dict:
        """Per-leaf torch-Adam activity for the R1 phase: every parameter of
        the d_patch graph is stepped (with a zero gradient where it has
        none, as the reference's `+ 0 * d_patch[0]` makes torch do), the
        coord-AC head (outside that graph) is skipped.  The projection
        head is part of d_patch at training time, so it is stepped."""
        return {k: tree_map(lambda _: k != "coord_linear", v)
                for k, v in params.items()}

    def apply(self, params: dict, img: torch.Tensor,
              ac_coords: Optional[torch.Tensor] = None,
              train: bool = False) -> Dict[str, torch.Tensor]:
        """img: (B, H, W, 3) in [-1, 1]; ac_coords: (B, num_dir) labels,
        required at training time with coord_use_pd.  Returns
        {"d_patch": (B,1)} and, with coord_use_ac, "ac_coords_pred": (B,
        ac_out_dim)."""
        stem, blocks, final_conv, flat = self.plan()
        h = stem(params["stem"], img)
        last_feat = None
        for b, p in zip(blocks, params["blocks"]):
            last_feat = h          # the feature entering the last ResBlock
            h = b(p, h)
        h = minibatch_stddev(h, self.stddev_group)
        h = final_conv(params["final_conv"], h)
        # the reference's NCHW flatten order
        h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
        (l1, l2), (c1, c2), (p1, p2) = self._heads(flat)
        out = {"d_patch": l2.apply(params["final_linear"][1],
                                   l1.apply(params["final_linear"][0], h))}
        if self.use_coord_ac:
            out["ac_coords_pred"] = c2.apply(
                params["coord_linear"][1],
                c1.apply(params["coord_linear"][0], h))
        if self.use_coord_pd and train:
            if ac_coords is None:
                raise ValueError("coord_use_pd needs the ac_coords labels "
                                 "at training time")
            label = ac_coords[:, -self.coord_proj_dim:]
            label_proj = p2.apply(params["coord_proj"][1],
                                  p1.apply(params["coord_proj"][0], label))
            feat_proj = last_feat.sum(dim=(1, 2))               # (B, C)
            proj_pred = (label_proj * feat_proj).sum(dim=1, keepdim=True)
            out["d_patch"] = out["d_patch"] + proj_pred * self.coord_pd_w
        return out
