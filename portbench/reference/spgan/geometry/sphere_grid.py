"""Gnomonic (spherical) sampling grids and their row-offset tables
(counterpart of spgan_tpu/geometry/sphere_grid.py: the patch-grid and
offset-table forms, computed in float32 as the JAX package computes them).

Every function takes the crop fractions as float32 tensors of any common
shape S (one entry per patch) and returns tensors with S leading, on the
fractions' device.

Output convention: grid[..., 0] = gx (width/longitude), grid[..., 1] = gy
(height/latitude), both in [-1, 1] for align_corners=True sampling over the
patch itself.
"""
from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


def _kernel_offsets(k: int, x_total: int, y_total: int):
    """Static (numpy float64) gnomonic kernel-tap offsets; k odd."""
    dlat = np.pi / x_total
    dlon = TWO_PI / y_total
    rng = np.arange(-(k // 2), k // 2 + 1, dtype=np.float64)
    kx1 = np.tan(rng * dlon)
    ky1 = np.tan(rng * dlat) / np.cos(rng * dlon)
    ker_x, ker_y = np.meshgrid(kx1, ky1)  # (k,k): ker_x varies on axis 1
    rho = np.sqrt(ker_x ** 2 + ker_y ** 2)
    rho[k // 2, k // 2] = 1e-8
    nu = np.arctan(rho)
    return ker_x, ker_y, rho, nu


def _f32_offsets(k: int, x_total: int, y_total: int, device):
    ker_x, ker_y, rho, nu = _kernel_offsets(k, x_total, y_total)
    return [torch.as_tensor(np.asarray(v, np.float32), device=device)
            for v in (ker_x, ker_y, rho, np.cos(nu), np.sin(nu))]


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int
              ) -> torch.Tensor:
    """Batched float32 linspace with jnp.linspace's arithmetic:
    start*(1-step) + stop*step, then the exact endpoint."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32,
                        device=start.device) / float(div)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def _min_max_norm(v: torch.Tensor) -> torch.Tensor:
    lo = v.amin(dim=-1, keepdim=True)
    hi = v.amax(dim=-1, keepdim=True)
    return (v - lo) / (hi - lo) * 2.0 - 1.0


def _lat_pattern_lon_off(lat_range, k, x_total, y_total):
    """(…, h) row latitudes -> the center-relative latitude pattern and the
    longitude offsets of every tap, both (…, h, k, k)."""
    ker_x, ker_y, rho, cos_nu, sin_nu = _f32_offsets(k, x_total, y_total,
                                                     lat_range.device)
    sin_lat = torch.sin(lat_range)[..., None, None]
    cos_lat = torch.cos(lat_range)[..., None, None]
    # clip: the argument is analytically in [-1,1] but float32 rounding can
    # overshoot, which would give NaN latitudes
    lat = torch.arcsin(torch.clamp(
        cos_nu * sin_lat + ker_y * sin_nu * cos_lat / rho, -1.0, 1.0))
    pattern = lat - lat[..., k // 2, k // 2][..., None, None]
    lon_off = torch.arctan(
        ker_x * sin_nu / (rho * cos_lat * cos_nu - ker_y * sin_lat * sin_nu))
    return pattern, lon_off


def _lat_range(p_x_st, p_x_ed, grid_partial, h):
    x_st = p_x_st * np.pi * grid_partial
    x_ed = p_x_ed * np.pi * grid_partial
    return _linspace(x_st, x_ed, h) - (np.pi / 2.0) * grid_partial


def sphere_patch_grid(p_x_st, p_x_ed, p_y_st, p_y_ed, circular,
                      grid_partial: float, *, h: int, w: int, k: int,
                      x_total: int, y_total: int) -> torch.Tensor:
    """Sampling grid of each patch: (…, h*k, w*k, 2) in [-1, 1]."""
    lat_range = _lat_range(p_x_st, p_x_ed, grid_partial, h)
    y_st = p_y_st * TWO_PI
    y_ed_raw = p_y_ed * TWO_PI
    # wrap y_ed unless it lands exactly on 2*pi; then the circular flag
    # extends it by a full turn
    y_ed = torch.where(torch.abs(y_ed_raw - TWO_PI) < 1e-9,
                       y_ed_raw, torch.remainder(y_ed_raw, TWO_PI))
    y_ed = y_ed + circular * TWO_PI
    lon_range = _linspace(y_st, y_ed, w) - np.pi

    pattern, lon_off = _lat_pattern_lon_off(lat_range, k, x_total, y_total)
    lat_norm = _min_max_norm(lat_range)[..., None, None] + pattern  # (…,h,k,k)
    lon_norm = (lon_off[..., :, None, :, :]
                + _min_max_norm(lon_range)[..., None, :, None, None])
    lead = lat_range.shape[:-1]
    lat_full = lat_norm[..., :, None, :, :].expand(*lead, h, w, k, k)
    # (…, h, w, kh, kw) -> (…, h, kh, w, kw) -> (…, h*k, w*k)
    gy = lat_full.transpose(-3, -2).reshape(*lead, h * k, w * k)
    gx = lon_norm.transpose(-3, -2).reshape(*lead, h * k, w * k)
    return torch.stack([gx, gy], dim=-1)


def sphere_offset_tables(p_x_st, p_x_ed, p_y_st, p_y_ed, circular,
                         grid_partial: float, *, h: int, w: int, k: int,
                         x_total: int, y_total: int) -> dict:
    """Row-wise sampling offsets, the structural decomposition of the patch
    grid: the sampled position of output pixel (r, c), tap t is

        py = r + dy(r, t),   px = c + dx(r, t)

    so every output row is a uniformly translated bilinear resample of the
    input.  Returns a dict of (…, h, k*k) tensors: y0, y1 (clamped int32
    rows), wy (row fraction), sx (int32 column shift), fx (column
    fraction).  Tap order t = ti*k + tj matches sphere_patch_grid's
    (h*k, w*k) layout.  The p_y/circular arguments do not enter (the grid's
    longitude normalization cancels out of the per-row offsets); they are
    kept for the JAX signature."""
    del p_y_st, p_y_ed, circular
    lat_range = _lat_range(p_x_st, p_x_ed, grid_partial, h)
    pattern, lon_off = _lat_pattern_lon_off(lat_range, k, x_total, y_total)
    lead = lat_range.shape[:-1]
    dy = pattern.reshape(*lead, h, k * k) * (h - 1) / 2.0
    dx = lon_off.reshape(*lead, h, k * k) * (w - 1) / 2.0

    rows = torch.arange(h, dtype=torch.float32,
                        device=lat_range.device)[:, None]
    py = rows + dy
    y_floor = torch.floor(py)
    wy = py - y_floor
    yi = y_floor.to(torch.int32)
    y0 = torch.clamp(yi, 0, h - 1)
    y1 = torch.clamp(yi + 1, 0, h - 1)
    sx_f = torch.floor(dx)
    return {"y0": y0, "y1": y1, "wy": wy, "sx": sx_f.to(torch.int32),
            "fx": dx - sx_f}


def training_col_margin(w: int, k: int, x_total: int, y_total: int,
                        grid_partial: float, n: int = 8193) -> int:
    """Worst-case column-shift margin of the offset tables over ALL training
    crops at layer width ``w`` (numpy, static).

    dx(r, t) = lon_off(lat_r, t) * (w - 1) / 2 depends only on the row
    latitude, and training-crop latitudes lie inside
    [-pi/2, pi/2] * grid_partial, so a dense latitude sweep bounds the
    integer shift sx = floor(dx) for every possible crop.  Returns M
    guaranteeing sx in [-M, M-1] (the tap-conv contract), at least 6: the
    static counterpart of generator.skip_margin, which needs the tables on
    the host."""
    ker_x, ker_y, rho, nu = _kernel_offsets(k, x_total, y_total)
    cos_nu, sin_nu = np.cos(nu), np.sin(nu)
    half = np.pi / 2.0 * grid_partial
    lat = np.linspace(-half, half, n)
    sin_lat = np.sin(lat)[:, None, None]
    cos_lat = np.cos(lat)[:, None, None]
    lon_off = np.arctan(
        ker_x * sin_nu / (rho * cos_lat * cos_nu - ker_y * sin_lat * sin_nu))
    dx = lon_off.reshape(n, k * k) * (w - 1) / 2.0
    sx = np.floor(dx).astype(np.int64)
    return max(6, int(-sx.min()), int(sx.max()) + 1)


def sphere_offset_tables_batch(cp, h: int, w: int, k: int = 3) -> dict:
    """Offset tables from a CoordsPartial: dict of (N, h, k*k)."""
    return sphere_offset_tables(
        cp.p_x_st, cp.p_x_ed, cp.p_y_st, cp.p_y_ed, cp.circular,
        cp.grid_partial, h=h, w=w, k=k, x_total=cp.x_total,
        y_total=cp.y_total)


def sphere_patch_grid_batch(cp, h: int, w: int, k: int = 3) -> torch.Tensor:
    """Grids from a CoordsPartial: (N, h*k, w*k, 2)."""
    return sphere_patch_grid(
        cp.p_x_st, cp.p_x_ed, cp.p_y_st, cp.p_y_ed, cp.circular,
        cp.grid_partial, h=h, w=w, k=k, x_total=cp.x_total,
        y_total=cp.y_total)

