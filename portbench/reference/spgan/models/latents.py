"""Latent sampling with explicit torch.Generators (counterpart of
spgan_tpu/models/latents.py: the training draws).

  * sample_global: a (B, 2, D) pair; the second entry equals the first
    unless one style-mixing coin (p = mixing) for the whole batch succeeds.
  * sample_local: (B, S+2*ss_pad, S+2*ss_pad, C), including the SS padding
    ring; spatial_size_enlarge m widens S to round(m * (S // 2)) * 2 + 1
    (the extrapolated grids of the training loop).
  * sample_circular_local: a closed-loop panorama's cylindrical field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class LatentSampler:
    global_dim: int = 512
    local_dim: int = 256
    ts_input_size: int = 11
    ss_unfold_size: int = 12
    mixing: float = 0.9

    def sample_global(self, gen: torch.Generator,
                      batch: int) -> torch.Tensor:
        """Drawn on gen's device; the mixing coin stays on the device."""
        dev = gen.device
        z1 = torch.randn((batch, self.global_dim), generator=gen, device=dev)
        z2 = torch.randn((batch, self.global_dim), generator=gen, device=dev)
        coin = torch.rand((), generator=gen, device=dev)
        z2 = torch.where(coin < self.mixing, z2, z1)
        return torch.stack([z1, z2], dim=1)

    def local_shape(self, spatial_size_enlarge: float = 1
                    ) -> Tuple[int, int]:
        """(H, W) of a local latent, the SS padding ring included."""
        s = self.ts_input_size
        if spatial_size_enlarge != 1:
            s = int(round(self.ts_input_size // 2 * spatial_size_enlarge)) \
                * 2 + 1
        return (s + 2 * self.ss_unfold_size, s + 2 * self.ss_unfold_size)

    def sample_local(self, gen: torch.Generator, batch: int,
                     spatial_size_enlarge: float = 1) -> torch.Tensor:
        h, w = self.local_shape(spatial_size_enlarge)
        return torch.randn((batch, h, w, self.local_dim), generator=gen,
                           device=gen.device)

