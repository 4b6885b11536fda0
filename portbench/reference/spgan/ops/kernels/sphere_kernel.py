"""The fused spherical resample + conv of the program's sphere-conv kernel,
as plain PyTorch operations only (a frozen copy of the program's plain
version): every call, on any device, runs the plain arithmetic."""
from __future__ import annotations

import torch

from portbench.reference.spgan.ops.kernels.taps import sample_tap


def fused_sphere_conv_plain(x: torch.Tensor, tables: dict, w9: torch.Tensor,
                            groups: int, margin: int = 6) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: both lerps in float32, the
    staged tap rounded once to bf16 when x and w9 are bf16, products and
    tap sums in float32, output cast to x's dtype."""
    B, H, W, C = x.shape
    K2, _, Cout = w9.shape
    mxu_bf16 = x.dtype == torch.bfloat16 and w9.dtype == torch.bfloat16
    xg = x.reshape(groups, B // groups, H, W, C)
    acc = torch.zeros((B * H * W, Cout), dtype=torch.float32, device=x.device)
    for t in range(K2):
        tap = sample_tap(xg, tables, t, margin)
        if mxu_bf16:
            tap = tap.to(torch.bfloat16).float()
        acc = acc + tap.reshape(-1, C) @ w9[t].float()
    return acc.reshape(B, H, W, Cout).to(x.dtype)


def fused_sphere_conv_grouped(x: torch.Tensor, tables: dict, w9: torch.Tensor,
                              groups: int, margin: int = 6) -> torch.Tensor:
    return fused_sphere_conv_plain(x, tables, w9, groups, margin)

