"""InceptionV3 of pytorch-fid for FID features (counterpart of
spgan_tpu/evalkit/inception.py).

The reference computes FID on pytorch-fid's InceptionV3 (libs/inception.py:
pool3 2048-d features, bilinear resize to 299, the FID-patched average
pools with count_include_pad=False, a max pool in Mixed_7c).  The
submodules carry pytorch-fid's names (``Conv2d_1a_3x3.conv``, ``.bn``,
``Mixed_5b.branch1x1``, ``fc``), so its checkpoint
(pt_inception-2015-12-05-6726825d.pth) loads with ``load_state_dict``;
``load_torch_inception`` is the thin wrapper.  The weights are not in the
repo; ``random_inception`` gives seeded random ones, for plumbing only
(FID values mean something only with the real weights).

The interface is the JAX package's: (B, H, W, 3) in [-1, 1] in, pool3
features (B, 2048) or, with_logits, the 1008 logits out.  The resize to
299 follows ``jax.image.resize(..., "bilinear")``, which antialiases an
axis that shrinks (the reference's pytorch-fid does not; ROADMAP fault
C6).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from spgan_tpu_torch.device import resolve

INPUT_SIZE = 299
BN_EPS = 1e-3
# the stem: (name, kh, kw, cin, cout, stride, padding)
_STEM = [("Conv2d_1a_3x3", 3, 3, 3, 32, 2, 0),
         ("Conv2d_2a_3x3", 3, 3, 32, 32, 1, 0),
         ("Conv2d_2b_3x3", 3, 3, 32, 64, 1, 1),
         ("Conv2d_3b_1x1", 1, 1, 64, 80, 1, 0),
         ("Conv2d_4a_3x3", 3, 3, 80, 192, 1, 0)]
# block name: (kind, cin, pool features of A / c7 of C)
BLOCKS = {
    "Mixed_5b": ("A", 192, 32), "Mixed_5c": ("A", 256, 64),
    "Mixed_5d": ("A", 288, 64),
    "Mixed_6a": ("B", 288, None),
    "Mixed_6b": ("C", 768, 128), "Mixed_6c": ("C", 768, 160),
    "Mixed_6d": ("C", 768, 160), "Mixed_6e": ("C", 768, 192),
    "Mixed_7a": ("D", 768, None),
    "Mixed_7b": ("E_avg", 1280, None), "Mixed_7c": ("E_max", 2048, None),
}


def block_convs(kind: str, cin: int, extra) -> List[Tuple[str, int, int,
                                                          int, int]]:
    """(name, kh, kw, cin, cout) of each BasicConv2d of a block."""
    if kind == "A":
        return [("branch1x1", 1, 1, cin, 64),
                ("branch5x5_1", 1, 1, cin, 48), ("branch5x5_2", 5, 5, 48, 64),
                ("branch3x3dbl_1", 1, 1, cin, 64),
                ("branch3x3dbl_2", 3, 3, 64, 96),
                ("branch3x3dbl_3", 3, 3, 96, 96),
                ("branch_pool", 1, 1, cin, extra)]
    if kind == "B":
        return [("branch3x3", 3, 3, cin, 384),
                ("branch3x3dbl_1", 1, 1, cin, 64),
                ("branch3x3dbl_2", 3, 3, 64, 96),
                ("branch3x3dbl_3", 3, 3, 96, 96)]
    if kind == "C":
        c7 = extra
        return [("branch1x1", 1, 1, cin, 192),
                ("branch7x7_1", 1, 1, cin, c7),
                ("branch7x7_2", 1, 7, c7, c7), ("branch7x7_3", 7, 1, c7, 192),
                ("branch7x7dbl_1", 1, 1, cin, c7),
                ("branch7x7dbl_2", 7, 1, c7, c7),
                ("branch7x7dbl_3", 1, 7, c7, c7),
                ("branch7x7dbl_4", 7, 1, c7, c7),
                ("branch7x7dbl_5", 1, 7, c7, 192),
                ("branch_pool", 1, 1, cin, 192)]
    if kind == "D":
        return [("branch3x3_1", 1, 1, cin, 192),
                ("branch3x3_2", 3, 3, 192, 320),
                ("branch7x7x3_1", 1, 1, cin, 192),
                ("branch7x7x3_2", 1, 7, 192, 192),
                ("branch7x7x3_3", 7, 1, 192, 192),
                ("branch7x7x3_4", 3, 3, 192, 192)]
    return [("branch1x1", 1, 1, cin, 320),
            ("branch3x3_1", 1, 1, cin, 384),
            ("branch3x3_2a", 1, 3, 384, 384), ("branch3x3_2b", 3, 1, 384, 384),
            ("branch3x3dbl_1", 1, 1, cin, 448),
            ("branch3x3dbl_2", 3, 3, 448, 384),
            ("branch3x3dbl_3a", 1, 3, 384, 384),
            ("branch3x3dbl_3b", 3, 1, 384, 384),
            ("branch_pool", 1, 1, cin, 192)]


class _FrozenBN(nn.Module):
    """Inference batchnorm: pytorch-fid's parameter and buffer names,
    without num_batches_tracked."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class BasicConv2d(nn.Module):
    """A conv without bias, frozen batchnorm (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, (kh, kw), bias=False)
        self.conv.weight.requires_grad_(False)
        self.bn = _FrozenBN(cout)

    def forward(self, x, stride=1, padding=0):
        y = F.conv2d(x, self.conv.weight, stride=stride, padding=padding)
        # the JAX package's folding of the batchnorm into a scale and bias
        scale = self.bn.weight * torch.rsqrt(self.bn.running_var + BN_EPS)
        bias = self.bn.bias - self.bn.running_mean * scale
        return F.relu(y * scale[:, None, None] + bias[:, None, None])


def avg_pool3(x):
    """3x3 stride-1 average pool, pad 1, the padding not counted."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionBlock(nn.Module):
    """One Mixed_* block of kind A, B, C, D, E_avg or E_max (torchvision's
    wiring; E_max is pytorch-fid's FIDInceptionE_2, max-pooled)."""

    def __init__(self, kind: str, cin: int, extra=None):
        super().__init__()
        self.kind = kind
        for name, kh, kw, ci, co in block_convs(kind[0], cin, extra):
            self.add_module(name, BasicConv2d(ci, co, kh, kw))

    def forward(self, x):
        k = self.kind
        if k == "A":
            b1 = self.branch1x1(x)
            b5 = self.branch5x5_2(self.branch5x5_1(x), padding=2)
            b3 = self.branch3x3dbl_1(x)
            b3 = self.branch3x3dbl_2(b3, padding=1)
            b3 = self.branch3x3dbl_3(b3, padding=1)
            return torch.cat([b1, b5, b3, self.branch_pool(avg_pool3(x))], 1)
        if k == "B":
            b3 = self.branch3x3(x, stride=2)
            bd = self.branch3x3dbl_1(x)
            bd = self.branch3x3dbl_2(bd, padding=1)
            bd = self.branch3x3dbl_3(bd, stride=2)
            return torch.cat([b3, bd, max_pool3s2(x)], 1)
        if k == "C":
            b1 = self.branch1x1(x)
            b7 = self.branch7x7_1(x)
            b7 = self.branch7x7_2(b7, padding=(0, 3))
            b7 = self.branch7x7_3(b7, padding=(3, 0))
            bd = self.branch7x7dbl_1(x)
            bd = self.branch7x7dbl_2(bd, padding=(3, 0))
            bd = self.branch7x7dbl_3(bd, padding=(0, 3))
            bd = self.branch7x7dbl_4(bd, padding=(3, 0))
            bd = self.branch7x7dbl_5(bd, padding=(0, 3))
            return torch.cat([b1, b7, bd, self.branch_pool(avg_pool3(x))], 1)
        if k == "D":
            b3 = self.branch3x3_2(self.branch3x3_1(x), stride=2)
            b7 = self.branch7x7x3_1(x)
            b7 = self.branch7x7x3_2(b7, padding=(0, 3))
            b7 = self.branch7x7x3_3(b7, padding=(3, 0))
            b7 = self.branch7x7x3_4(b7, stride=2)
            return torch.cat([b3, b7, max_pool3s2(x)], 1)
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3, padding=(0, 1)),
                        self.branch3x3_2b(b3, padding=(1, 0))], 1)
        bd = self.branch3x3dbl_1(x)
        bd = self.branch3x3dbl_2(bd, padding=1)
        bd = torch.cat([self.branch3x3dbl_3a(bd, padding=(0, 1)),
                        self.branch3x3dbl_3b(bd, padding=(1, 0))], 1)
        bp = (avg_pool3(x) if k == "E_avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


def resize_to_input(x: torch.Tensor, size: int = INPUT_SIZE) -> torch.Tensor:
    """(B, C, H, W) bilinearly resized to size x size as
    ``jax.image.resize(..., "bilinear")`` resizes (half-pixel centres; an
    axis that shrinks is antialiased, a triangle kernel widened by the
    scale)."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False,
                         antialias=bool(h > size or w > size))


class InceptionV3FID(nn.Module):
    """pytorch-fid's InceptionV3 to pool3 (and, with_logits, its fc)."""

    def __init__(self, resize_input: bool = True, with_logits: bool = False):
        super().__init__()
        self.resize_input = resize_input
        self.with_logits = with_logits
        for name, kh, kw, ci, co, _, _ in _STEM:
            self.add_module(name, BasicConv2d(ci, co, kh, kw))
        for name, (kind, cin, extra) in BLOCKS.items():
            self.add_module(name, InceptionBlock(kind, cin, extra))
        if with_logits:
            self.fc = nn.Linear(2048, 1008)
            self.fc.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [-1, 1] -> (B, 2048) pool3 features, or
        (B, 1008) logits with with_logits."""
        h = x.float().permute(0, 3, 1, 2)
        if self.resize_input:
            h = resize_to_input(h)
        for name, *_, stride, padding in _STEM:
            h = getattr(self, name)(h, stride=stride, padding=padding)
            if name in ("Conv2d_2b_3x3", "Conv2d_4a_3x3"):
                h = max_pool3s2(h)
        for name in BLOCKS:
            h = getattr(self, name)(h)
        feat = h.mean(dim=(2, 3))
        if self.with_logits:
            return F.linear(feat, self.fc.weight, self.fc.bias)
        return feat


def random_inception(with_logits: bool = False, seed: int = 0,
                     device=None) -> InceptionV3FID:
    """The network with seeded random weights on `device` (default cuda):
    He-normal convs, identity batchnorm, fc N(0, 0.02) with zero bias.
    For plumbing only: its FID values mean nothing."""
    model = InceptionV3FID(with_logits=with_logits)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv.weight"):
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (2.0 / fan_in) ** 0.5)
            elif name == "fc.weight":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name == "fc.bias":
                p.zero_()
    return model.to(resolve(device)).eval()


def load_inception_state_dict(model: InceptionV3FID,
                              sd: Dict[str, torch.Tensor]) -> InceptionV3FID:
    """Load a pytorch-fid state dict into `model`: its num_batches_tracked
    and AuxLogits entries are dropped, and its fc when the model has none;
    every other key must match."""
    keep = {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")
            and not k.startswith("AuxLogits.")
            and (model.with_logits or not k.startswith("fc."))}
    model.load_state_dict(keep, strict=True)
    return model


def load_torch_inception(path: str, with_logits: bool = False,
                         device=None) -> InceptionV3FID:
    """The network with a pytorch-fid checkpoint's weights
    (pt_inception-2015-12-05-*.pth), on `device` (default cuda)."""
    dev = resolve(device)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = load_inception_state_dict(
        InceptionV3FID(with_logits=with_logits), sd)
    return model.to(dev).eval()

