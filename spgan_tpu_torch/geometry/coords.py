"""Spherical coordinate fields and crop descriptors (counterpart of
spgan_tpu/geometry/coords.py: the inference subset)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class CoordsPartial:
    """Batch of crop descriptors: p_* are fractions of the coordinate field
    (tensors of shape (N,)), `circular` marks crops that wrap around the
    horizontal seam.  x_total/y_total are the coordinate-field size the
    fractions refer to; `grid_partial` is the vertical-extent fraction the
    gnomonic grid generator uses (config.partial at test time)."""

    p_x_st: torch.Tensor
    p_x_ed: torch.Tensor
    p_y_st: torch.Tensor
    p_y_ed: torch.Tensor
    circular: torch.Tensor
    x_total: int = 45
    y_total: int = 140
    grid_partial: float = 0.8

    @classmethod
    def from_scalars(cls, cps: np.ndarray, x_total: int, y_total: int,
                     grid_partial: float) -> "CoordsPartial":
        """From an (N, 5) array of (p_x_st, p_x_ed, p_y_st, p_y_ed,
        circular) rows, held in float32 as the JAX package holds them."""
        t = torch.as_tensor(np.asarray(cps, np.float32))
        return cls(p_x_st=t[:, 0], p_x_ed=t[:, 1], p_y_st=t[:, 2],
                   p_y_ed=t[:, 3], circular=t[:, 4], x_total=x_total,
                   y_total=y_total, grid_partial=grid_partial)


def encode_coords(coords: torch.Tensor, num_dir: int = 3) -> torch.Tensor:
    """Raw index coords -> network input encoding, channel-last:
    (tanh(x), cos(pi*y), sin(pi*y))."""
    if num_dir != 3:
        raise NotImplementedError(f"coord_num_dir={num_dir}")
    return torch.stack([
        torch.tanh(coords[..., 0]),
        torch.cos(coords[..., 1] * np.pi),
        torch.sin(coords[..., 2] * np.pi),
    ], dim=-1)


@dataclass(frozen=True)
class CoordGrid:
    """The constant coordinate field.  With the shipped config: ss window
    35, vert_sample 10, hori_occupy 0.25 => field is 45 x 140, x in [-3, 3]
    (cut_pt), y in [-1, 1]."""

    ts_input_size: int = 11
    ss_unfold_size: int = 12
    vert_sample_size: int = 10
    hori_occupy_ratio: float = 0.25
    vert_cut_pt: float = 3.0
    num_dir: int = 3
    partial: float = 0.6667
    continuous: bool = True

    @property
    def ss_spatial_size(self) -> int:
        return self.ts_input_size + 2 * self.ss_unfold_size  # 35

    @property
    def size_x(self) -> int:
        return self.ss_spatial_size + self.vert_sample_size  # 45

    @property
    def size_y(self) -> int:
        return int(round(self.ss_spatial_size / self.hori_occupy_ratio))  # 140

    def base_grid(self, height: Optional[int] = None,
                  width: Optional[int] = None,
                  coord_init: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        """(H, W, num_dir) raw coordinate field, channel-last, float32."""
        h = self.size_x if height is None else height
        w = self.size_y if width is None else width
        x = (np.arange(h, dtype=np.float64) + coord_init[0]) / (self.size_x - 1)
        y = (np.arange(w, dtype=np.float64) + coord_init[1]) / (self.size_y - 1)
        exceeding = x[-1] - 1.0
        x = x - exceeding / 2.0
        x = (x * 2.0 - 1.0) * self.vert_cut_pt
        y = y * 2.0 - 1.0
        xx = np.repeat(x[:, None], w, axis=1)
        yy = np.repeat(y[None, :], h, axis=0)
        if self.num_dir != 3:
            raise NotImplementedError(f"num_dir={self.num_dir}")
        return np.stack([xx, yy, yy], axis=-1).astype(np.float32)

    def test_field(self, height: int, width: int) -> np.ndarray:
        """Deterministic coordinate field over the full inference latent."""
        return self.base_grid(height=height, width=width)
