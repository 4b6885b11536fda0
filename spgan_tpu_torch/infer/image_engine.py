"""Whole-image rendering for a generator without a patch lattice
(models/stylegan3.py): each batch draws new latents from the caller's
generator and renders every image whole, on one device.

Its surface is the part of PanoramaEngine's that the managers and the
CLI use (``batch``, ``generate``, ``crop_to_target``), so
``ImageGenerationManager`` (infer/managers.py) runs the inference CLI's
batches through it unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.utils import trace


@dataclass
class ImageEngine:
    g: object   # models.stylegan3.Generator
    batch: int
    device: Optional[Union[str, torch.device]] = None  # default: cuda

    def __post_init__(self):
        self.device = resolve(self.device)

    def sample_latents(self, gen: torch.Generator) -> torch.Tensor:
        """(batch, z_dim) standard normal latents from `gen` (a generator
        on the engine's device)."""
        return torch.randn((self.batch, self.g.z_dim), generator=gen,
                           device=self.device)

    def generate(self, params, gen: torch.Generator) -> torch.Tensor:
        """One batch of images (B, R, R, C), float32, from new latents."""
        with trace.span("spgan.engine.generate",
                        trace.count("spgan.engine.batches")):
            return self.generate_from_latents(params,
                                              self.sample_latents(gen))

    @torch.inference_mode()
    def generate_from_latents(self, params, z: torch.Tensor) -> torch.Tensor:
        return self.g.apply(params, z)

    def crop_to_target(self, images):
        """The whole image is the target."""
        return images
