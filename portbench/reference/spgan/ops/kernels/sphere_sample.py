"""The spherical tap sampler of the program's sampler kernel, as plain
PyTorch operations only (a frozen copy of the program's plain version),
and its straight-through wrapper."""
from __future__ import annotations

import torch

from portbench.reference.spgan.ops.kernels.taps import sample_tap


def sphere_sample_taps_plain(x: torch.Tensor, tables: dict,
                             margin: int = 6) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: per-sample tables (B,H,K2);
    each tap in float32, cast once to x's dtype.  Returns (B,K2,H,W,C)."""
    B = x.shape[0]
    K2 = tables["y0"].shape[-1]
    xg = x.reshape(B, 1, *x.shape[1:])
    return torch.stack([sample_tap(xg, tables, t, margin)[:, 0].to(x.dtype)
                        for t in range(K2)], dim=1)


def sphere_sample_taps(x: torch.Tensor, tables: dict,
                       margin: int = 6) -> torch.Tensor:
    return sphere_sample_taps_plain(x, tables, margin)


def st_sample_taps(z: torch.Tensor, tables: dict) -> torch.Tensor:
    """Straight-through tap sampler: forward == sphere_sample_taps; the
    gradient w.r.t. z is 0.1 * the mean over taps of the cotangent (the
    reference's 3x3 block-mean backward in the tap-major layout), and
    nothing flows to the tables.  Plain tensor algebra, so it stays twice
    differentiable (R1 and PPL)."""
    k2 = tables["y0"].shape[-1]
    primal = sphere_sample_taps(z.detach(), tables)
    lin = (0.1 / k2) * z[:, None].expand(z.shape[0], k2, *z.shape[1:])
    return primal + lin - lin.detach()
