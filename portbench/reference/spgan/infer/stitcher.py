"""Patch-lattice planning for the close-loop (360-degree) panorama and
the planar (infinite) canvas (counterpart of spgan_tpu/infer/stitcher.py;
pure numpy).

  * step sizes from the receptive-field algebra (ops/spatial.py)
  * lattice start points, plus 2 wrap columns when close-loop
  * per-position crop descriptors, including the reference's test-time
    quirks: x_size = window+1 in the p_* fractions and its circular-flag
    normalization
  * circular read margins (close-loop): every circular field is padded
    once with its first `window` columns so all per-patch reads are plain
    slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from portbench.reference.spgan.ops.spatial import StitchGeometry, in_size_chain

TEST_META_EXTRA_PAD = 3  # reference test_managers/global_config.py:1


@dataclass(frozen=True)
class LatticePlan:
    close_loop: bool
    target_h: int
    target_w: int
    meta_h: int
    meta_w: int
    num_steps_h: int
    num_steps_w: int          # includes wrap columns when close_loop
    num_steps_w_min: int      # excludes wrap columns
    window: int               # z window size (ss input, e.g. 35)
    z_field_h: int            # latent field height incl. ss padding
    z_field_w: int            # latent field width (circular when close_loop)
    geom: StitchGeometry
    # per-position (row-major, len = num_steps_h*num_steps_w):
    z_starts: np.ndarray          # (P, 2) row/col starts into padded z field
    noise_starts: List[np.ndarray]  # per layer (P, 2)
    img_starts: np.ndarray        # (P, 2) meta-image row/col (col pre-wrap)
    cp_scalars: np.ndarray        # (P, 5): p_x_st, p_x_ed, p_y_st, p_y_ed, circ
    x_total: int
    y_total: int
    noise_sizes: List[Tuple[int, int]]  # per-layer field (h, w) pre-padding

    @property
    def num_patches(self) -> int:
        return self.num_steps_h * self.num_steps_w



def build_close_loop_plan(g, target_h: int, target_w: int) -> LatticePlan:
    """`g`: a models.generator.Generator (only its static specs are read)."""
    geom = g.ts.stitch_geometry()
    patch = geom.outfeat_sizes[-1]
    px, zx = geom.pixelspace_step, geom.latentspace_step
    ss_pad = g.ss.unfold_size
    window = g.ts.ts_input_size + 2 * ss_pad

    nh = math.ceil((target_h - patch) / px) + TEST_META_EXTRA_PAD
    if target_w % px:
        raise ValueError(
            f"close-loop needs width divisible by the pixel step {px}")
    nw_min = target_w // px
    nw = nw_min + 2  # wrap columns
    meta_h = px * (nh - 1) + patch
    meta_w = nw_min * px

    # latent field: height covers meta_h, width is one full circle
    z_h_in = in_size_chain(g.ts.conv_specs_spatial(), meta_h)[0]
    z_field_h = z_h_in + 2 * ss_pad
    z_field_w = nw_min * zx
    x_total, y_total = z_field_h, z_field_w

    z_starts = []
    noise_starts = [[] for _ in geom.outfeat_steps]
    img_starts = []
    cp = []
    for i in range(nh):
        for j in range(nw):
            zr = i * zx
            zc_raw = j * zx
            z_starts.append((zr, zc_raw % z_field_w))  # circular read start
            for li, ostep in enumerate(geom.outfeat_steps):
                nw_field = ostep * nw_min
                noise_starts[li].append((i * ostep, (j * ostep) % nw_field))
            img_starts.append((i * px, j * px))
            # the reference's coords_partial and circular flag
            zy_st, zy_ed = zc_raw, zc_raw + window
            if zy_ed > y_total and zy_st >= y_total:
                zy_st = zy_st % y_total
                circ = False
            elif zy_ed > y_total:
                circ = True
            else:
                circ = False
            size1 = window + 1
            cp.append((zr / x_total, (zr + size1) / x_total,
                       zy_st / y_total, (zy_st + size1) / y_total,
                       float(circ)))

    noise_sizes = [
        (int(os_ * (nh - 1) + sz), int(os_ * nw_min))
        for os_, sz in zip(geom.outfeat_steps, geom.outfeat_sizes)]

    return LatticePlan(
        close_loop=True, target_h=target_h, target_w=target_w,
        meta_h=meta_h, meta_w=meta_w,
        num_steps_h=nh, num_steps_w=nw, num_steps_w_min=nw_min,
        window=window, z_field_h=z_field_h, z_field_w=z_field_w,
        geom=geom,
        z_starts=np.array(z_starts, np.int32),
        noise_starts=[np.array(v, np.int32) for v in noise_starts],
        img_starts=np.array(img_starts, np.int32),
        cp_scalars=np.array(cp, np.float64),
        x_total=x_total, y_total=y_total,
        noise_sizes=noise_sizes)


def build_infinite_plan(g, target_h: int, target_w: int) -> LatticePlan:
    """Planar (non-wrapping) lattice: the reference's infinite generation
    (infinite_generation.py:268-291, 393-423)."""
    geom = g.ts.stitch_geometry()
    patch = geom.outfeat_sizes[-1]
    px, zx = geom.pixelspace_step, geom.latentspace_step
    ss_pad = g.ss.unfold_size
    window = g.ts.ts_input_size + 2 * ss_pad

    nh = math.ceil((target_h - patch) / px) + TEST_META_EXTRA_PAD
    nw = math.ceil((target_w - patch) / px) + TEST_META_EXTRA_PAD
    meta_h = px * (nh - 1) + patch
    meta_w = px * (nw - 1) + patch

    specs = g.ts.conv_specs_spatial()
    z_field_h = in_size_chain(specs, meta_h)[0] + 2 * ss_pad
    z_field_w = in_size_chain(specs, meta_w)[0] + 2 * ss_pad
    x_total, y_total = z_field_h, z_field_w

    z_starts, img_starts, cp = [], [], []
    noise_starts = [[] for _ in geom.outfeat_steps]
    size1 = window + 1
    for i in range(nh):
        for j in range(nw):
            z_starts.append((i * zx, j * zx))
            for li, ostep in enumerate(geom.outfeat_steps):
                noise_starts[li].append((i * ostep, j * ostep))
            img_starts.append((i * px, j * px))
            cp.append((i * zx / x_total, (i * zx + size1) / x_total,
                       j * zx / y_total, (j * zx + size1) / y_total, 0.0))

    noise_sizes = [
        (int(os_ * (nh - 1) + sz), int(os_ * (nw - 1) + sz))
        for os_, sz in zip(geom.outfeat_steps, geom.outfeat_sizes)]

    return LatticePlan(
        close_loop=False, target_h=target_h, target_w=target_w,
        meta_h=meta_h, meta_w=meta_w,
        num_steps_h=nh, num_steps_w=nw, num_steps_w_min=nw,
        window=window, z_field_h=z_field_h, z_field_w=z_field_w,
        geom=geom,
        z_starts=np.array(z_starts, np.int32),
        noise_starts=[np.array(v, np.int32) for v in noise_starts],
        img_starts=np.array(img_starts, np.int32),
        cp_scalars=np.array(cp, np.float64),
        x_total=x_total, y_total=y_total,
        noise_sizes=noise_sizes)
