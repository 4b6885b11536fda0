"""Bilinear grid sampling (align_corners=True, border padding), the
straight-through 3x3 sampler of the sphere convs, and the row-offset tap
conv of the TS sphere skip convs (counterpart of
spgan_tpu/ops/grid_sample.py).

These are plain tensor ops in the JAX package too (XLA, no Pallas).
Layout NHWC.
"""
from __future__ import annotations

import torch


def bilinear_grid_sample_grouped(x: torch.Tensor, grid: torch.Tensor
                                 ) -> torch.Tensor:
    """JAX's bilinear_grid_sample (G == B) and bilinear_grid_sample_shared
    (per group) in one function.

    x: (B,H,W,C); grid: (G,Ho,Wo,2) shared by the B//G consecutive
    samples of each group (G == B: one grid per sample), grid[...,0] = gx
    (width), grid[...,1] = gy (height), both in [-1,1].  Returns
    (B,Ho,Wo,C)."""
    b, h, w, c = x.shape
    g, ho, wo, _ = grid.shape
    if b % g:
        raise ValueError(f"batch {b} is not a multiple of {g} grids")
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0).to(x.dtype)[:, None, :, :, None]
    wy = (gy - y0).to(x.dtype)[:, None, :, :, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(x0i, 0, w - 1)
    y0i = torch.clamp(y0i, 0, h - 1)

    flat = x.reshape(g, b // g, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(g, 1, ho * wo, 1)
        v = torch.take_along_dim(flat, idx, dim=2)
        return v.reshape(g, b // g, ho, wo, c)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x1i)
    v10 = gather(y1i, x0i)
    v11 = gather(y1i, x1i)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).reshape(b, ho, wo, c)


def _nearest_upsample3(z: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B,3H,3W,C) by repetition."""
    return z.repeat_interleave(3, dim=1).repeat_interleave(3, dim=2)


def st_grid_sample_3x3(z: torch.Tensor, grid: torch.Tensor,
                       grid_groups: int = 0) -> torch.Tensor:
    """Straight-through sampler for (B,H,W,C) -> (B,3H,3W,C) sphere-conv
    resampling.  Forward == bilinear sampling; backward w.r.t. ``z`` is
    0.1 * mean over each 3x3 block of the cotangent; no gradient to
    ``grid``.  grid: (B,3H,3W,2), or (G,3H,3W,2) shared by the B//G
    samples of each group when grid_groups == G > 0."""
    if grid.shape[-3] != 3 * z.shape[1] or grid.shape[-2] != 3 * z.shape[2]:
        raise ValueError(f"grid {tuple(grid.shape)} does not tile "
                         f"{tuple(z.shape)} by 3")
    if grid_groups and grid.shape[0] != grid_groups:
        raise ValueError(f"{grid.shape[0]} grids for {grid_groups} groups")
    primal = bilinear_grid_sample_grouped(z.detach(), grid.detach())
    lin = (0.1 / 9.0) * _nearest_upsample3(z)
    return primal + lin - lin.detach()


def tap_conv_tables(z: torch.Tensor, tables: dict, w9: torch.Tensor,
                    margin: int = 6, groups: int = 0) -> torch.Tensor:
    """Fused sphere resample + stride-k conv from row-offset tables
    (geometry/sphere_grid.sphere_offset_tables): output pixel (r, c), tap t
    samples the input at (r + dy(r,t), c + dx(r,t)).  Per tap: two row
    gathers (y0/y1) and a vertical lerp, a per-row integer column shift sx
    clipped to [-margin, margin-1] over the edge-clamped row, a horizontal
    lerp, and one (H*W, C) x (C, Cout) contraction.

    z: (B,H,W,C); tables: dict of (B,H,K2), or (G,H,K2) with groups=G > 0
    (each shared by B//G consecutive samples); w9: (K2,C,Cout).  Returns
    (B,H,W,Cout) in z's dtype, accumulated tap by tap in that dtype as the
    JAX package does."""
    B, H, W, C = z.shape
    K2, _, Cout = w9.shape
    M = margin
    G = groups if groups else B
    if B % G:
        raise ValueError(f"batch {B} is not a multiple of groups {G}")
    Bg = B // G
    zg = z.reshape(G, Bg, H, W, C)
    sx_all = torch.clamp(tables["sx"], -M, M - 1).to(torch.int64)
    cols = torch.arange(W, device=z.device)

    y = torch.zeros((G, Bg, H, W, Cout), dtype=z.dtype, device=z.device)
    for t in range(K2):
        y0 = tables["y0"][:, :, t].to(torch.int64)[:, None, :, None, None]
        y1 = tables["y1"][:, :, t].to(torch.int64)[:, None, :, None, None]
        wy = tables["wy"][:, :, t].to(z.dtype)[:, None, :, None, None]
        r0 = torch.take_along_dim(zg, y0, dim=2)
        r1 = torch.take_along_dim(zg, y1, dim=2)
        mixed = r0 * (1 - wy) + r1 * wy                         # (G,Bg,H,W,C)
        # edge padding by M columns + a shift in [-M, M-1] == a clamped
        # column index
        c0 = cols + sx_all[:, :, t, None]                         # (G,H,W)
        i0 = torch.clamp(c0, 0, W - 1)[:, None, :, :, None]
        i1 = torch.clamp(c0 + 1, 0, W - 1)[:, None, :, :, None]
        fx = tables["fx"][:, :, t].to(z.dtype)[:, None, :, None, None]
        tap = (torch.take_along_dim(mixed, i0, dim=3) * (1 - fx)
               + torch.take_along_dim(mixed, i1, dim=3) * fx)
        y = y + torch.einsum("gbhwc,co->gbhwo", tap, w9[t])
    return y.reshape(B, H, W, Cout)


def st_tap_conv(z: torch.Tensor, tables: dict, w9: torch.Tensor,
                margin: int = 6, groups: int = 0) -> torch.Tensor:
    """Straight-through tap conv: forward == tap_conv_tables; backward
    gives the true gradient to ``w9`` and the 0.1-blockmean gradient to
    ``z`` through a (0.1/9) * 1x1 surrogate with the tap-summed weight."""
    primal = tap_conv_tables(z.detach(), tables, w9, margin=margin,
                             groups=groups)
    wsum = w9.sum(dim=0).detach().to(z.dtype)
    lin = (0.1 / w9.shape[0]) * torch.einsum("bhwc,co->bhwo", z, wsum)
    return primal + lin - lin.detach()
