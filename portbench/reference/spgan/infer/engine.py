"""The panorama engine for close-loop and planar lattices, single device
(counterpart of spgan_tpu/infer/engine.py), cut to what the reference
renders: every lattice position, the close-loop wrap columns too, and no
SS noise (the benchmark's configurations set ss_disable_noise).

One `generate_from_fields` call

  1. takes the latent and noise fields `sample_fields` drew,
  2. pads the circular fields once (close-loop), so every per-patch read
     is a slice,
  3. runs the generator over the lattice in folded batches of
     `patch_chunk` positions x `batch` panoramas,
  4. scatters the patches into the meta image in the reference's
     row-major overwrite order.

The sphere grids and row-offset tables depend only on the lattice plan, so
they are computed once, at construction, on the host in float32 (as the
JAX package computes them) and kept on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from portbench.reference.spgan.device import resolve
from portbench.reference.spgan.geometry.coords import CoordsPartial
from portbench.reference.spgan.geometry.sphere_grid import (sphere_offset_tables_batch,
                                                  sphere_patch_grid_batch)
from portbench.reference.spgan.infer.stitcher import LatticePlan
from portbench.reference.spgan.models.generator import (Generator, skip_margin,
                                              tables_to)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def render_patches(g: Generator, params, styles, gz, z_src, coords_src,
                   noises_src, z_starts, noise_starts, grids, tables,
                   skip_tables, skip_margins, *, batch: int, win: int,
                   out_sizes, cdt) -> torch.Tensor:
    """Render len(z_starts) lattice positions x `batch` panoramas in ONE
    folded generator call.  Sample q*batch + b is panorama b at the q-th
    position (chunk-major fold).

    z_starts (chunk, 2) and noise_starts (per layer (chunk, 2)) are start
    indices into the (padded) z / coords / noise fields; grids, tables
    and skip_tables hold the chunk's positions in order.
    Returns (chunk, batch, patch, patch, 3) in `cdt`."""
    B, chunk = batch, len(z_starts)
    zw = torch.stack([z_src[:, r:r + win, c:c + win] for r, c in z_starts])
    zw = zw.reshape(chunk * B, win, win, -1).to(cdt)
    cw = torch.stack([coords_src[r:r + win, c:c + win]
                      for r, c in z_starts])
    cw = cw.repeat_interleave(B, dim=0)           # (chunk*B, win, win, 3)
    layer_noises = []
    for li, sz in enumerate(out_sizes):
        nw = torch.stack([noises_src[li][:, r:r + sz, c:c + sz]
                          for r, c in noise_starts[li]])
        layer_noises.append(nw.reshape(chunk * B, sz, sz, 1).to(cdt))
    gz_t = gz.repeat(chunk, 1).to(cdt)
    styles_t = styles.repeat(chunk, 1, 1).to(cdt)
    structure = g.ss.apply(params["ss"], gz_t, zw, cw, grids, tables,
                           groups=chunk)
    img = g.ts.synthesize(params["ts"], structure, styles_t, layer_noises,
                          skip_tables, skip_margins, groups=chunk)
    patch_sz = out_sizes[-1]
    return img.reshape(chunk, B, patch_sz, patch_sz, 3)


def scatter_patches(plan: LatticePlan, patches: torch.Tensor) -> torch.Tensor:
    """Meta assembly in the reference's row-major overwrite order: lattice
    position p writes patches[p], and a close-loop patch that runs past
    the right edge wraps to column 0."""
    patch_sz = plan.geom.outfeat_sizes[-1]
    B = patches.shape[1]
    meta = torch.zeros((B, plan.meta_h, plan.meta_w, 3),
                       dtype=torch.float32, device=patches.device)
    for p in range(plan.num_patches):
        r, c_raw = int(plan.img_starts[p, 0]), int(plan.img_starts[p, 1])
        patch = patches[p]
        c = c_raw % plan.meta_w if plan.close_loop else c_raw
        rows = slice(r, r + patch_sz)
        if c + patch_sz <= plan.meta_w:
            meta[:, rows, c:c + patch_sz] = patch
        else:
            split = plan.meta_w - c
            meta[:, rows, c:] = patch[:, :, :split]
            meta[:, rows, :patch_sz - split] = patch[:, :, split:]
    return meta


@dataclass
class PanoramaEngine:
    g: Generator
    plan: LatticePlan
    batch: int
    patch_chunk: int = 4
    grid_partial: float = 0.6667
    compute_dtype: str = "float32"
    device: Optional[Union[str, torch.device]] = None  # default: cuda

    def __post_init__(self):
        if not self.g.ss.disable_noise:
            raise ValueError("the reference engine renders without SS noise")
        self.device = resolve(self.device)
        plan = self.plan
        P = plan.num_patches
        if P % self.patch_chunk:
            self.patch_chunk = max(c for c in range(1, self.patch_chunk + 1)
                                   if P % c == 0)
        dev = self.device
        self._coords_field = torch.as_tensor(
            self.g.ss.coord_grid.test_field(plan.z_field_h, plan.z_field_w),
            device=dev)
        cp = CoordsPartial.from_scalars(plan.cp_scalars, plan.x_total,
                                        plan.y_total, self.grid_partial)
        ss_sizes = self.g.ss.layer_sizes(plan.window)
        self._ss_grids = [sphere_patch_grid_batch(cp, s, s).to(dev)
                          for s in ss_sizes]
        self._ss_tables = [tables_to(sphere_offset_tables_batch(cp, s, s), dev)
                           for s in ss_sizes]
        # skip convs: exact per-size shift margins over the whole plan (the
        # integer column shifts grow with the layer size)
        skip_sizes = self.g.ts.skip_sizes()
        skip = [sphere_offset_tables_batch(cp, s, s) for s in skip_sizes]
        self._skip_margins = [skip_margin(t) for t in skip]
        self._skip_tables = [tables_to(t, dev) for t in skip]

    # ----------------------------------------------------------------
    def sample_fields(self, gen: torch.Generator):
        """Latent + noise fields for one batch of panoramas, drawn from
        `gen` (a generator on the engine's device)."""
        plan = self.plan
        kw = dict(generator=gen, device=self.device)
        gl = torch.randn((self.batch, 2, self.g.ts.global_dim), **kw)
        gl[:, 1] = gl[:, 0]  # no mixing at test
        z_field = torch.randn((self.batch, plan.z_field_h, plan.z_field_w,
                               self.g.ts.local_dim), **kw)
        noises = [torch.randn((self.batch, h, w, 1), **kw)
                  for h, w in plan.noise_sizes]
        return gl, z_field, noises

    # ----------------------------------------------------------------
    def render_chunk(self, params, styles, gz, z_pad, coords_pad, noises_pad,
                     sel) -> torch.Tensor:
        """Render the lattice positions `sel` x `batch` panoramas in ONE
        folded generator call (render_patches).
        Returns (chunk, batch, patch, patch, 3) in the compute dtype."""
        plan = self.plan
        idx = torch.as_tensor(sel, device=self.device)

        def take(t):
            return t.index_select(0, idx)
        return render_patches(
            self.g, params, styles, gz, z_pad, coords_pad, noises_pad,
            plan.z_starts[sel], [s[sel] for s in plan.noise_starts],
            [take(gr) for gr in self._ss_grids],
            [{k: take(v) for k, v in t.items()} for t in self._ss_tables],
            [{k: take(v) for k, v in t.items()} for t in self._skip_tables],
            self._skip_margins, batch=self.batch, win=plan.window,
            out_sizes=plan.geom.outfeat_sizes,
            cdt=_DTYPES[self.compute_dtype])

    @torch.inference_mode()
    def generate_from_fields(self, params, gl, z_field, noises
                             ) -> torch.Tensor:
        """One batch of meta images (B, meta_h, meta_w, 3), float32."""
        plan = self.plan
        if plan.close_loop:
            win = plan.window
            z_pad = torch.cat([z_field, z_field[:, :, :win]], dim=2)
            coords_pad = torch.cat(
                [self._coords_field, self._coords_field[:, :win]], dim=1)
            noises_pad = [torch.cat([n, n[:, :, :osz]], dim=2)
                          for n, osz in zip(noises, plan.geom.outfeat_sizes)]
        else:
            z_pad, coords_pad, noises_pad = z_field, self._coords_field, noises
        styles = self.g.build_styles(params, gl)      # (B, n_latent, D)
        gz = gl[:, 0]
        chunk = self.patch_chunk
        patches = torch.cat([
            self.render_chunk(params, styles, gz, z_pad, coords_pad,
                              noises_pad,
                              np.arange(ci * chunk, (ci + 1) * chunk)).float()
            for ci in range(plan.num_patches // chunk)])
        return scatter_patches(plan, patches)

    def crop_to_target(self, meta: torch.Tensor) -> torch.Tensor:
        """The centred target_h x target_w crop of a meta batch (a view)."""
        plan = self.plan
        ph = (plan.meta_h - plan.target_h) // 2
        pw = (plan.meta_w - plan.target_w) // 2
        return meta[:, ph:ph + plan.target_h, pw:pw + plan.target_w]
