"""Spherical coordinate fields and crop descriptors (counterpart of
spgan_tpu/geometry/coords.py): the input encodings of every coord_num_dir,
the test field, the training crops with their shared jitter, ac labels
and crop descriptors, and the extrapolated training grids of windows
larger than the field.  Training runs num_dir 3 only (perturb_ranges
raises otherwise, as in the JAX package); num_dir 1 serves inference."""
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
    """Raw index coords -> network input encoding, channel-last.

    num_dir 3: (tanh(x), cos(pi*y), sin(pi*y)); 5 adds cos(2 pi y2) and
    cos(3 pi y3); 1: tanh; 2: the identity; 4: cos/sin pairs; 21: tanh(x)
    and cos/sin(y * pi * 2^i) for i in 0..9."""
    if num_dir == 3:
        return torch.stack([
            torch.tanh(coords[..., 0]),
            torch.cos(coords[..., 1] * np.pi),
            torch.sin(coords[..., 2] * np.pi),
        ], dim=-1)
    if num_dir == 5:
        return torch.stack([
            torch.tanh(coords[..., 0]),
            torch.cos(coords[..., 1] * np.pi),
            torch.sin(coords[..., 2] * np.pi),
            torch.cos(coords[..., 3] * np.pi * 2),
            torch.cos(coords[..., 4] * np.pi * 3),
        ], dim=-1)
    if num_dir == 1:
        return torch.tanh(coords)
    if num_dir == 2:
        return coords
    if num_dir == 4:
        return torch.stack([
            torch.cos(coords[..., 0] * np.pi),
            torch.sin(coords[..., 1] * np.pi),
            torch.cos(coords[..., 2] * np.pi),
            torch.sin(coords[..., 3] * np.pi),
        ], dim=-1)
    if num_dir == 21:
        parts = [torch.tanh(coords[..., 0])]
        for i in range(10):
            parts.append(torch.cos(coords[..., i * 2 + 1] * np.pi * 2 ** i))
            parts.append(torch.sin(coords[..., i * 2 + 2] * np.pi * 2 ** i))
        return torch.stack(parts, dim=-1)
    raise NotImplementedError(f"coord_num_dir={num_dir}")


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
        if self.num_dir == 3:
            grid = np.stack([xx, yy, yy], axis=-1)
        elif self.num_dir == 1:
            grid = xx[..., None]
        else:
            raise NotImplementedError(f"num_dir={self.num_dir}")
        return grid.astype(np.float32)

    def test_field(self, height: int, width: int) -> np.ndarray:
        """Deterministic coordinate field over the full inference latent."""
        return self.base_grid(height=height, width=width)

    def perturb_ranges(self) -> np.ndarray:
        """Half-pixel jitter amplitude per channel (num_dir 3 only)."""
        g = self.base_grid()
        if self.num_dir != 3:
            raise NotImplementedError(f"perturb_ranges: num_dir="
                                      f"{self.num_dir}")
        return np.array([abs(g[0, 0, 0] - g[1, 0, 0]) / 2,
                         abs(g[0, 0, 1] - g[0, 1, 1]) / 2,
                         abs(g[0, 0, 2] - g[0, 1, 2]) / 2], np.float32)

    # ---- training-time sampling ---------------------------------------
    def draw_training(self, gen: torch.Generator, batch: int):
        """The random part of sample_training: crop origins x_st (B,),
        y_st (B,) (int64) and the batch-shared jitter (num_dir,) float32,
        drawn from `gen` on its device."""
        dev = gen.device
        x_st = torch.randint(0, self.vert_sample_size, (batch,),
                             generator=gen, device=dev)
        y_st = torch.randint(0, self.size_y, (batch,), generator=gen,
                             device=dev)
        if self.continuous:
            pr = torch.as_tensor(self.perturb_ranges(), device=dev)
            u = torch.rand((pr.shape[0],), generator=gen, device=dev)
            jitter = (u * 2.0 - 1.0) * pr
        else:
            jitter = torch.zeros((self.num_dir,), device=dev)
        return x_st, y_st, jitter

    def training_crops(self, x_st: torch.Tensor, y_st: torch.Tensor,
                       jitter: torch.Tensor):
        """35x35 crops of the constant field at (x_st, y_st), wrapping
        horizontally, plus ONE jitter shared by the batch.  Returns (coords
        (B,35,35,C) raw, ac_coords (B,C), CoordsPartial) on x_st's device."""
        size = self.ss_spatial_size
        dev = x_st.device
        base = torch.as_tensor(self.base_grid(), device=dev)     # (45,140,C)
        padded = torch.cat([base, base[:, :size]], dim=1)        # wrap margin
        ar = torch.arange(size, device=dev)
        rows = (x_st[:, None] + ar)[:, :, None]                   # (B,35,1)
        cols = (y_st[:, None] + ar)[:, None, :]                   # (B,1,35)
        coords = padded[rows, cols] + jitter.to(base.dtype)
        return (coords, self._ac_coords(x_st, y_st),
                self._coords_partial(x_st, y_st, size, size))




    def _ac_coords(self, x_st, y_st):
        nx = (x_st / (self.vert_sample_size - 1)) * 2.0 - 1.0
        ny = (y_st / (self.size_y - 1)) * 2.0 - 1.0
        return torch.stack([nx, torch.cos(ny * np.pi), torch.sin(ny * np.pi)],
                           dim=-1).float()

    def _coords_partial(self, x_st, y_st, x_size, y_size) -> CoordsPartial:
        # circular iff the y window wraps; training grids use
        # grid_partial=0.8 (a faithful quirk of the reference)
        return CoordsPartial(
            p_x_st=x_st / self.size_x,
            p_x_ed=(x_st + x_size - 1) / self.size_x,
            p_y_st=y_st / self.size_y,
            p_y_ed=(y_st + y_size - 1) / self.size_y,
            circular=(y_st + y_size > self.size_y).float(),
            x_total=self.size_x, y_total=self.size_y, grid_partial=0.8)
