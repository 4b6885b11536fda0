"""The row-offset tap arithmetic shared by the plain versions of the sphere
kernels (sphere_kernel.py: resample + conv; sphere_sample.py: resample
only), and the table dtypes both CUDA kernels take."""
from __future__ import annotations

import torch

TABLE_DTYPES = {"y0": torch.int32, "y1": torch.int32, "wy": torch.float32,
                "sx": torch.int32, "fx": torch.float32}


def sample_tap(xg: torch.Tensor, tables: dict, t: int,
               margin: int) -> torch.Tensor:
    """Tap t of the row-offset resample in float32, the arithmetic every
    kernel of this package computes: xg (G,Bg,H,W,C), tables (G,H,K2)
    shared by the Bg samples of each group.  Row mix then column mix, each
    lerp a*(1-w) + b*w in float32 op by op.  Returns (G,Bg,H,W,C) float32."""
    W = xg.shape[3]
    y0 = tables["y0"][:, :, t].to(torch.int64)[:, None, :, None, None]
    y1 = tables["y1"][:, :, t].to(torch.int64)[:, None, :, None, None]
    wy = tables["wy"][:, :, t].float()[:, None, :, None, None]
    fx = tables["fx"][:, :, t].float()[:, None, :, None, None]
    sx = torch.clamp(tables["sx"][:, :, t], -margin, margin - 1).to(torch.int64)
    r0 = torch.take_along_dim(xg, y0, dim=2).float()
    r1 = torch.take_along_dim(xg, y1, dim=2).float()
    mixed = r0 * (1.0 - wy) + r1 * wy                   # (G,Bg,H,W,C)
    c0 = torch.arange(W, device=xg.device) + sx[:, :, None]   # (G,H,W)
    i0 = torch.clamp(c0, 0, W - 1)[:, None, :, :, None]
    i1 = torch.clamp(c0 + 1, 0, W - 1)[:, None, :, :, None]
    return (torch.take_along_dim(mixed, i0, dim=3) * (1.0 - fx)
            + torch.take_along_dim(mixed, i1, dim=3) * fx)
