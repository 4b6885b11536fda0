"""LPIPS perceptual distance, the v0.1 "alex" variant (counterpart of
spgan_tpu/evalkit/lpips.py; the reference vendors the lpips package,
libs/lpips/).

AlexNet's five convs (ReLU after each, a 3x3 stride-2 max pool after the
first two) give five taps; each tap is unit-normalised over its channels,
the squared difference of the two images' taps goes through a 1x1 linear
head clamped at >= 0, is averaged over space, and the taps are summed.
The weights (torchvision's AlexNet and lpips' v0.1 linear heads) are not
in the repo: ``load_torch_lpips(alex_path, lin_path)`` reads them; a
seeded random network is for plumbing only.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from spgan_tpu_torch.device import resolve

# (out, k, stride, pad) of AlexNet's convs; torchvision's features indices
ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
        (256, 3, 1, 1)]
ALEX_FEATURE_IDS = [0, 3, 6, 8, 10]
# lpips' ScalingLayer
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """convs.{i}: AlexNet's conv i (weight OIHW, bias); lins.{i}: the
    linear head of tap i, (C,)."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, k, _, _ in ALEX:
            convs.append(nn.Conv2d(cin, cout, k))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(c)) for c, *_ in ALEX])
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) in [-1, 1] -> the five NCHW taps."""
        h = (x.float().permute(0, 3, 1, 2) - self.shift) / self.scale
        taps = []
        for i, ((_, _, stride, pad), conv) in enumerate(zip(ALEX,
                                                             self.convs)):
            h = F.relu(F.conv2d(h, conv.weight, conv.bias, stride=stride,
                                padding=pad))
            taps.append(h)
            if i in (0, 1):
                h = F.max_pool2d(h, 3, stride=2)
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (B, H, W, 3) in [-1, 1] -> (B,) distances."""
        total = 0.0
        for a, b, lin in zip(self.features(x), self.features(y), self.lins):
            an = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
            bn = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
            d = torch.square(an - bn)
            w = lin.clamp(min=0.0)
            total = total + (d * w[:, None, None]).sum(1).mean(dim=(1, 2))
        return total


def random_lpips(seed: int = 0, device=None) -> LPIPS:
    """Seeded random weights (He-normal convs, |N(0, 0.01)| heads) on
    `device` (default cuda).  For plumbing only."""
    model = LPIPS()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in model.convs:
            w = conv.weight
            w.copy_(torch.randn(w.shape, generator=gen)
                    * (2.0 / w[0].numel()) ** 0.5)
            conv.bias.zero_()
        for lin in model.lins:
            lin.copy_(torch.randn(lin.shape, generator=gen).abs() * 0.01)
    return model.to(resolve(device)).eval()


def load_lpips_lin_weights(lin_path: str) -> List[torch.Tensor]:
    """lpips' linear heads (lin{i}.model.1.weight, each (1, C, 1, 1)), as
    (C,) tensors; e.g. the reference's libs/lpips/weights/v0.1/alex.pth."""
    lsd = torch.load(lin_path, map_location="cpu", weights_only=False)
    return [lsd[f"lin{i}.model.1.weight"].reshape(-1).float()
            for i in range(len(ALEX))]


def load_torch_lpips(alex_features_path: str, lin_path: str,
                     device=None) -> LPIPS:
    """LPIPS from a torchvision AlexNet state dict (features.{0,3,6,8,10})
    and lpips' v0.1 linear heads, on `device` (default cuda)."""
    asd = torch.load(alex_features_path, map_location="cpu",
                     weights_only=False)
    if hasattr(asd, "state_dict"):
        asd = asd.state_dict()
    sd = {}
    for i, fid in enumerate(ALEX_FEATURE_IDS):
        sd[f"convs.{i}.weight"] = asd[f"features.{fid}.weight"]
        sd[f"convs.{i}.bias"] = asd[f"features.{fid}.bias"]
    for i, w in enumerate(load_lpips_lin_weights(lin_path)):
        sd[f"lins.{i}"] = w
    model = LPIPS()
    model.load_state_dict(sd)
    return model.to(resolve(device)).eval()
