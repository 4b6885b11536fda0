"""Spatial-shape calibration: map features and pixel locations between the
layers of the no-padding architecture (counterpart of
spgan_tpu/infer/calibrate.py).

direction "backward" (image -> z): for a plain no-pad conv, pad the dirty
ring back; for an upsample conv, pad the dirty ring, then resize bilinearly
(align_corners=True) down to the input size.  pin_loc tracks one pixel
through the same transformations.  Layout NHWC.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from spgan_tpu_torch.ops.grid_sample import bilinear_grid_sample_grouped
from spgan_tpu_torch.ops.spatial import ConvSpec


def _unit_linspace(num: int, device) -> torch.Tensor:
    """float32 linspace(-1, 1, num) rounded as the JAX package's is on the
    CPU: XLA evaluates jnp.linspace as fma(i, stop * r, start * (1 - i * r))
    with r = float32(1 / (num - 1)) (bit for bit up to num = 352, past
    every layer size of the shipped generators; longer vectors take other
    fmas in XLA's vector body).  A grid point one ulp off an integer pixel
    moves a bilinear sample by up to ~5e-5.  The fma is taken in float64,
    where i * (stop * r) is exact."""
    if num == 1:
        return torch.full((1,), -1.0, dtype=torch.float32, device=device)
    r = torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    i = torch.arange(num - 1, dtype=torch.float32)
    start_term = -(1.0 - i * r)                     # start * (1 - i * r)
    out = (i.double() * r.double() + start_term.double()).float()
    return torch.cat([out, torch.ones(1)]).to(device)


def resize_align_corners(x: torch.Tensor, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """Bilinear resize with align_corners=True, x: (B,H,W,C)."""
    gy = _unit_linspace(out_h, x.device)
    gx = _unit_linspace(out_w, x.device)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    grid = torch.stack([gxx, gyy], -1)[None].expand(x.shape[0], -1, -1, -1)
    return bilinear_grid_sample_grouped(x, grid)


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    y = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode="replicate")
    return y.permute(0, 2, 3, 1)


def calibrate_backward(specs: Sequence[ConvSpec], feature: torch.Tensor,
                       pin_loc: Optional[Tuple[int, int]] = None):
    """Walk the conv stack output -> input.  Returns (features, pin_locs),
    one entry per layer, ordered from the image side toward z."""
    feats: List[torch.Tensor] = []
    pins: List[Optional[Tuple[int, int]]] = []
    for spec in reversed(list(specs)):
        h, w = feature.shape[1], feature.shape[2]
        d0, d1 = spec.dirty_rm
        if (d0, d1) != (0, 0):
            feature = _pad_edge(feature, d0, d1)
        if spec.upsample:
            feature = resize_align_corners(feature, spec.in_size(h),
                                           spec.in_size(w))
            if pin_loc is not None:
                p = (pin_loc[0] + d0, pin_loc[1] + d1)
                old_c = (h + d0, w + d1)
                new_c = (old_c[0] // 2, old_c[1] // 2)
                pin_loc = ((p[0] - old_c[0]) // 2 + new_c[0],
                           (p[1] - old_c[1]) // 2 + new_c[1])
        elif pin_loc is not None:
            pin_loc = (pin_loc[0] + d0, pin_loc[1] + d1)
        feats.append(feature)
        pins.append(pin_loc)
    return feats, pins


def calibrate_backward_ss(n_layers: int, unfold_radius: int,
                          feature: torch.Tensor,
                          pin_loc: Optional[Tuple[int, int]] = None):
    """SS stack backward: sphere convs keep the size; each planar k7 conv
    pads unfold_radius per side."""
    feats, pins = [], []
    r = unfold_radius
    for _ in range(n_layers):
        feature = _pad_edge(feature, r, r)
        if pin_loc is not None:
            pin_loc = (pin_loc[0] + r, pin_loc[1] + r)
        feats += [feature, feature]   # after the planar conv; sphere: same
        pins += [pin_loc, pin_loc]
    return feats, pins
