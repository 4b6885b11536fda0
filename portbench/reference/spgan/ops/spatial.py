"""Receptive-field algebra for the no-padding ("odd") architecture
(counterpart of spgan_tpu/ops/spatial.py; pure integers, no tensors).

With the shipped config the TS out-size chain from 11 is
[19,17,31,29,55,53,103,101] and the derived steps are 96 px (pixel space)
/ 6 px (latent space).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ConvSpec:
    """Static spatial behavior of one TS conv (kernel 3, no_zero_pad)."""

    upsample: bool
    kernel_size: int = 3
    blur_len: int = 3  # len(blur_kernel)

    @property
    def dirty_rm(self) -> Tuple[int, int]:
        if self.upsample:
            p = self.blur_len // 2
            return (p, p)
        k2 = self.kernel_size // 2
        return (k2, k2)

    def out_size(self, in_size: int) -> int:
        d0, d1 = self.dirty_rm
        if self.upsample:
            return in_size * 2 - 1 - d0 - d1
        return in_size - d0 - d1

    def in_size(self, out_size: int) -> int:
        d0, d1 = self.dirty_rm
        if self.upsample:
            v = out_size + 1 + d0 + d1
            if v % 2:
                v += 1
            return v // 2
        return out_size + d0 + d1


def out_size_chain(specs: Sequence[ConvSpec], in_size: int) -> List[int]:
    sizes = []
    for s in specs:
        in_size = s.out_size(in_size)
        sizes.append(in_size)
    return sizes


def in_size_chain(specs: Sequence[ConvSpec], out_size: int) -> List[int]:
    """Input sizes per layer, returned z->img ordered."""
    sizes = []
    for s in reversed(specs):
        out_size = s.in_size(out_size)
        sizes.append(out_size)
    return sizes[::-1]


@dataclass(frozen=True)
class StitchGeometry:
    """Step sizes that make independently generated patches consistent in
    their overlaps."""

    outfeat_sizes: Tuple[int, ...]
    infeat_sizes: Tuple[int, ...]
    pixelspace_step: int
    latentspace_step: int
    infeat_steps: Tuple[int, ...]
    outfeat_steps: Tuple[int, ...]


def derive_stitch_geometry(specs: Sequence[ConvSpec], ts_input_size: int
                           ) -> StitchGeometry:
    out_sizes = np.array(out_size_chain(specs, ts_input_size))
    out_sizes_2x = np.array(out_size_chain(specs, ts_input_size * 2))
    out_disps = out_sizes_2x - out_sizes
    if (out_disps % ts_input_size).any():
        raise ValueError(f"output displacements {out_disps} not stitchable")

    in_sizes = np.array(in_size_chain(specs, int(out_sizes[-1])))
    in_sizes_2x = np.array(in_size_chain(specs, int(out_sizes_2x[-1])))
    in_disps = in_sizes_2x - in_sizes
    if (in_disps % ts_input_size).any():
        raise ValueError(f"input displacements {in_disps} not stitchable")

    px_unit = int(out_disps[-1] // ts_input_size)
    px_step = (int(out_sizes[-1]) // px_unit) * px_unit
    z_step = px_step // px_unit
    in_units = in_disps // ts_input_size
    out_units = out_disps // ts_input_size
    return StitchGeometry(
        outfeat_sizes=tuple(int(v) for v in out_sizes),
        infeat_sizes=tuple(int(v) for v in in_sizes),
        pixelspace_step=px_step,
        latentspace_step=z_step,
        infeat_steps=tuple(int(z_step * u) for u in in_units),
        outfeat_steps=tuple(int(z_step * u) for u in out_units),
    )
