"""The panorama engine for close-loop and planar lattices (counterpart of
spgan_tpu/infer/engine.py: the single-device engine).

One `generate` call

  1. samples the latent and noise fields (or takes them injected); with
     ss_disable_noise False, one map per SS planar conv and sample
     follows the TS noise fields, shared by every patch of a panorama
     (the reference's test-time noise cache gives every patch the same
     per-sample map, since the SS sizes never change),
  2. pads the circular fields once (close-loop), so every per-patch read
     is a slice,
  3. runs the generator over the lattice in folded batches of
     `patch_chunk` positions x `batch` panoramas (close-loop wrap columns
     that are bit-identical re-renders of base columns are rendered once),
  4. scatters the patches into the meta image in the reference's
     row-major overwrite order.

The sphere grids and row-offset tables depend only on the lattice plan, so
they are computed once, at construction, on the host in float32 (as the
JAX package computes them) and kept on the device.

`make_sharded_generate(mesh)` splits the rendered lattice positions over
the ranks of a torch.distributed world (the JAX package's shard_map over
the mesh): each rank renders its whole chunks, the patches are
all-gathered and every rank scatters the same meta image.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from spgan_tpu_torch.config import COMPUTE_DTYPES
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.geometry.coords import CoordsPartial
from spgan_tpu_torch.geometry.sphere_grid import (sphere_offset_tables_batch,
                                                  sphere_patch_grid_batch)
from spgan_tpu_torch.infer.stitcher import LatticePlan
from spgan_tpu_torch.models.generator import (Generator, skip_margin,
                                              tables_to)
from spgan_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from spgan_tpu_torch.utils import trace


def refuse_planar(g: Generator) -> None:
    """Raise the JAX engine's ValueError for a generator without an SS
    (the styleGAN2 baseline): the lattice threads the SS coordinates and
    crops through every patch."""
    if g.ss is None:
        raise ValueError(
            "PanoramaEngine requires a generator with use_ss=true; "
            "got a planar generator (g.ss is None). Planar stitched "
            "generation is not a shipped reference path either "
            "(its InfinityGAN managers assume the SS coord handler, "
            "test_managers/base_test_manager.py:40).")


def render_patches(g: Generator, params, styles, gz, z_src, coords_src,
                   noises_src, z_starts, noise_starts, grids, tables,
                   skip_tables, skip_margins, *, batch: int, win: int,
                   out_sizes, cdt, ss_maps=(),
                   rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Render len(z_starts) lattice positions x `batch` panoramas in ONE
    folded generator call: the shared body of the engine, its
    lattice-sharded form and the width-sharded halo path
    (infer/halo.py).  Sample q*batch + b is panorama b at the q-th
    position (chunk-major fold).

    z_starts (chunk, 2) and noise_starts (per layer (chunk, 2)) are start
    indices into the (padded or halo-extended) z / coords / noise fields;
    grids, tables and skip_tables hold the chunk's positions in order, or,
    with `rows` (indices), more positions, of which the chunk's are these
    rows.
    ss_maps: the SS noise maps (B, s, s, 1), the same at every position.
    Returns (chunk, batch, patch, patch, 3) in `cdt`."""
    B, chunk = batch, len(z_starts)
    with trace.span("spgan.engine.chunk_inputs"):
        if rows is not None:
            rows = torch.as_tensor(rows, device=grids[0].device)

            def take(t):
                return t.index_select(0, rows)
            grids = [take(gr) for gr in grids]
            tables = [{k: take(v) for k, v in t.items()} for t in tables]
            skip_tables = [{k: take(v) for k, v in t.items()}
                           for t in skip_tables]
        zw = torch.stack([z_src[:, r:r + win, c:c + win]
                          for r, c in z_starts])
        zw = zw.reshape(chunk * B, win, win, -1).to(cdt)
        cw = torch.stack([coords_src[r:r + win, c:c + win]
                          for r, c in z_starts])
        cw = cw.repeat_interleave(B, dim=0)       # (chunk*B, win, win, 3)
        layer_noises = []
        for li, sz in enumerate(out_sizes):
            nw = torch.stack([noises_src[li][:, r:r + sz, c:c + sz]
                              for r, c in noise_starts[li]])
            layer_noises.append(nw.reshape(chunk * B, sz, sz, 1).to(cdt))
        gz_t = gz.repeat(chunk, 1).to(cdt)
        styles_t = styles.repeat(chunk, 1, 1).to(cdt)
        # the chunk-major fold order of zw: position q's samples take the
        # B maps in order
        ss_noises = [m.repeat(chunk, 1, 1, 1).to(cdt) for m in ss_maps]
    with trace.span("spgan.generator.ss"):
        structure = g.ss.apply(params["ss"], gz_t, zw, cw, grids, tables,
                               groups=chunk, noises=ss_noises or None)
    with trace.span("spgan.generator.ts"):
        img = g.ts.synthesize(params["ts"], structure, styles_t,
                              layer_noises, skip_tables, skip_margins,
                              groups=chunk)
    patch_sz = out_sizes[-1]
    return img.reshape(chunk, B, patch_sz, patch_sz, 3)


def scatter_patches(plan: LatticePlan, patches: torch.Tensor,
                    full_map: np.ndarray,
                    meta: Optional[torch.Tensor] = None,
                    positions: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """Meta assembly in the reference's row-major overwrite order: lattice
    position p writes patches[full_map[p]] (a close-loop wrap column its
    base column's render), and a close-loop patch that runs past the
    right edge wraps to column 0.  With SS noise, neighbouring patches
    differ in their overlaps, so the order shows in the image.  `meta`:
    write into this batch of meta images (in place) instead of zeros;
    `positions`: write only these lattice positions."""
    patch_sz = plan.geom.outfeat_sizes[-1]
    B = patches.shape[1]
    if meta is None:
        meta = torch.zeros((B, plan.meta_h, plan.meta_w, 3),
                           dtype=torch.float32, device=patches.device)
    if positions is None:
        positions = range(plan.num_patches)
    for p in positions:
        r, c_raw = int(plan.img_starts[p, 0]), int(plan.img_starts[p, 1])
        patch = patches[int(full_map[p])]
        c = c_raw % plan.meta_w if plan.close_loop else c_raw
        rows = slice(r, r + patch_sz)
        if c + patch_sz <= plan.meta_w:
            meta[:, rows, c:c + patch_sz] = patch
        else:
            split = plan.meta_w - c
            meta[:, rows, c:] = patch[:, :, :split]
            meta[:, rows, :patch_sz - split] = patch[:, :, split:]
    return meta


def wrap_full_map(plan: LatticePlan) -> np.ndarray:
    """Lattice position -> index among the row-major base-column renders
    (close-loop wrap column j >= num_steps_w_min -> base column j -
    num_steps_w_min)."""
    nw, nwm = plan.num_steps_w, plan.num_steps_w_min
    return np.array([(p // nw) * nwm + (p % nw) % nwm
                     for p in range(plan.num_patches)], np.int64)


@dataclass
class PanoramaEngine:
    g: Generator
    plan: LatticePlan
    batch: int
    patch_chunk: int = 4
    grid_partial: float = 0.6667
    compute_dtype: str = "float32"
    dedup_wrap: bool = True  # render the close-loop wrap columns once
    device: Optional[Union[str, torch.device]] = None  # default: cuda

    def __post_init__(self):
        refuse_planar(self.g)
        self.device = resolve(self.device)
        plan = self.plan
        P = plan.num_patches
        # Close-loop wrap columns (j >= num_steps_w_min) are bit-identical
        # re-renders of columns j - num_steps_w_min: same cp, same circular
        # field windows.  Render each distinct column once; the scatter
        # writes the seam with the values the full render would write.
        if plan.close_loop and self.dedup_wrap and self._wrap_cols_dedupable():
            nw, nwm = plan.num_steps_w, plan.num_steps_w_min
            self._render_idx = np.array(
                [p for p in range(P) if p % nw < nwm], np.int64)
            self._full_map = wrap_full_map(plan)
        else:
            self._render_idx = np.arange(P, dtype=np.int64)
            self._full_map = np.arange(P, dtype=np.int64)
        n = len(self._render_idx)
        if n % self.patch_chunk:
            self.patch_chunk = max(c for c in range(1, self.patch_chunk + 1)
                                   if n % c == 0)
        dev = self.device
        self._coords_field = torch.as_tensor(
            self.g.ss.coord_grid.test_field(plan.z_field_h, plan.z_field_w),
            device=dev)

        def cp_of(idx):
            return CoordsPartial.from_scalars(
                plan.cp_scalars[idx], plan.x_total, plan.y_total,
                self.grid_partial)

        cp = cp_of(self._render_idx)
        ss_sizes = self.g.ss.layer_sizes(plan.window)
        self._ss_grids = [sphere_patch_grid_batch(cp, s, s).to(dev)
                          for s in ss_sizes]
        self._ss_tables = [tables_to(sphere_offset_tables_batch(cp, s, s), dev)
                           for s in ss_sizes]
        # skip convs: exact per-size shift margins over the whole plan (the
        # integer column shifts grow with the layer size)
        skip_sizes = self.g.ts.skip_sizes()
        cp_all = cp_of(np.arange(P))
        self._skip_margins = [
            skip_margin(sphere_offset_tables_batch(cp_all, s, s))
            for s in skip_sizes]
        self._skip_tables = [
            tables_to(sphere_offset_tables_batch(cp, s, s), dev)
            for s in skip_sizes]

    def _wrap_cols_dedupable(self) -> bool:
        """Wrap column j is a bit-identical re-render of base column
        j - num_steps_w_min iff its cp scalars are exactly equal (its
        z/noise slice starts are congruent by construction).  Fails for
        narrow panoramas where a base column's own window wraps: the
        reference's circular flag then differs between the two."""
        plan = self.plan
        nw, nwm = plan.num_steps_w, plan.num_steps_w_min
        cps = plan.cp_scalars.reshape(plan.num_steps_h, nw, 5)
        return all(np.array_equal(cps[:, j], cps[:, j - nwm])
                   for j in range(nwm, nw))

    # ----------------------------------------------------------------
    def sample_fields(self, gen: torch.Generator):
        """Latent + noise fields for one batch of panoramas, drawn from
        `gen` (a generator on the engine's device).  With SS noise, its
        (B, s, s, 1) maps are appended to the TS noise fields."""
        plan = self.plan
        kw = dict(generator=gen, device=self.device)
        gl = torch.randn((self.batch, 2, self.g.ts.global_dim), **kw)
        gl[:, 1] = gl[:, 0]  # no mixing at test
        z_field = torch.randn((self.batch, plan.z_field_h, plan.z_field_w,
                               self.g.ts.local_dim), **kw)
        noises = [torch.randn((self.batch, h, w, 1), **kw)
                  for h, w in plan.noise_sizes]
        if not self.g.ss.disable_noise:
            noises += [torch.randn((self.batch, s, s, 1), **kw)
                       for s in self.g.ss.noise_sizes(plan.window)]
        return gl, z_field, noises

    # ----------------------------------------------------------------
    def render_chunk(self, params, styles, gz, z_pad, coords_pad, noises_pad,
                     sel, ss_maps=()) -> torch.Tensor:
        """Render a chunk of rendered positions x `batch` panoramas in ONE
        folded generator call (render_patches): sel holds the chunk's
        rendered-position indices (arange(ci*chunk, (ci+1)*chunk) for
        chunk ci; the sharded engine's padded chunks repeat the last).
        Returns (chunk, batch, patch, patch, 3) in the compute dtype."""
        plan = self.plan
        pos = self._render_idx[sel]
        return render_patches(
            self.g, params, styles, gz, z_pad, coords_pad, noises_pad,
            plan.z_starts[pos], [s[pos] for s in plan.noise_starts],
            self._ss_grids, self._ss_tables, self._skip_tables,
            self._skip_margins, batch=self.batch, win=plan.window,
            out_sizes=plan.geom.outfeat_sizes,
            cdt=COMPUTE_DTYPES[self.compute_dtype], ss_maps=ss_maps,
            rows=sel)

    @torch.inference_mode()
    def _render(self, params, gl, z_field, noises, chunks=None
                ) -> torch.Tensor:
        """(rendered positions, B, patch, patch, 3) float32 patches of every
        chunk in order, or of `chunks` (render_chunk's sel, in order)."""
        plan = self.plan
        n_ts = len(plan.noise_sizes)
        ss_maps, noises = noises[n_ts:], noises[:n_ts]
        with trace.span("spgan.engine.fields"):
            if plan.close_loop:
                win = plan.window
                z_pad = torch.cat([z_field, z_field[:, :, :win]], dim=2)
                coords_pad = torch.cat(
                    [self._coords_field, self._coords_field[:, :win]], dim=1)
                noises_pad = [torch.cat([n, n[:, :, :osz]], dim=2) for n, osz
                              in zip(noises, plan.geom.outfeat_sizes)]
            else:
                z_pad, coords_pad, noises_pad = (z_field, self._coords_field,
                                                 noises)
            styles = self.g.build_styles(params, gl)  # (B, n_latent, D)
            gz = gl[:, 0]
        if chunks is None:
            chunk = self.patch_chunk
            chunks = [np.arange(ci * chunk, (ci + 1) * chunk)
                      for ci in range(len(self._render_idx) // chunk)]
        return torch.cat([
            self.render_chunk(params, styles, gz, z_pad, coords_pad,
                              noises_pad, sel, ss_maps).float()
            for sel in chunks])

    def _scatter(self, patches: torch.Tensor,
                 meta: Optional[torch.Tensor] = None,
                 positions: Optional[Sequence[int]] = None) -> torch.Tensor:
        with trace.span("spgan.engine.scatter"):
            return scatter_patches(self.plan, patches, self._full_map, meta,
                                   positions)

    def make_sharded_generate(self, mesh: Mesh):
        """fn(params, gl, z_field, noises) -> the meta image (B, meta_h,
        meta_w, 3), the same on every rank (the JAX engine's
        make_sharded_generate).  The rendered positions are padded, by
        repeating the last, to the same whole number of patch_chunk chunks
        a rank; each rank renders only its chunks (fn.chunks of them), the
        patches are all-gathered, the padding dropped, and every rank
        scatters in the reference's overwrite order.  Every rank passes
        the same fields.  A chunk without padding is one of the folded
        engine's own chunks, so its patches are the folded engine's."""
        n_r, chunk = len(self._render_idx), self.patch_chunk
        per_rank = -(-n_r // mesh.world_size)
        per_rank = -(-per_rank // chunk) * chunk
        sel = np.minimum(np.arange(mesh.rank * per_rank,
                                   (mesh.rank + 1) * per_rank), n_r - 1)
        chunks = [sel[q * chunk:(q + 1) * chunk]
                  for q in range(per_rank // chunk)]

        @torch.inference_mode()
        def generate(params, gl, z_field, noises) -> torch.Tensor:
            with trace.span("spgan.engine.generate",
                            trace.count("spgan.engine.batches")):
                patches = self._render(params, gl, z_field, noises, chunks)
                with trace.span("spgan.engine.all_gather"):
                    patches = all_gather_rows(patches, mesh)[:n_r]
                return self._scatter(patches)

        generate.chunks = len(chunks)
        return generate

    # ----------------------------------------------------------------
    def generate(self, params, gen: torch.Generator) -> torch.Tensor:
        """One batch of meta images (B, meta_h, meta_w, 3), float32."""
        with trace.span("spgan.engine.generate",
                        trace.count("spgan.engine.batches")):
            with trace.span("spgan.engine.fields"):
                fields = self.sample_fields(gen)
            return self._generate(params, *fields)

    def generate_from_fields(self, params, gl, z_field, noises
                             ) -> torch.Tensor:
        with trace.span("spgan.engine.generate",
                        trace.count("spgan.engine.batches")):
            return self._generate(params, gl, z_field, noises)

    @torch.inference_mode()
    def _generate(self, params, gl, z_field, noises) -> torch.Tensor:
        return self._scatter(self._render(params, gl, z_field, noises))

    def generate_patches(self, params, gl, z_field, noises) -> torch.Tensor:
        """(num_patches, B, patch, patch, 3): the full lattice, wrap columns
        pointing at their base-column renders."""
        patches = self._render(params, gl, z_field, noises)
        return patches[torch.as_tensor(self._full_map, device=patches.device)]

    def crop_to_target(self, meta: torch.Tensor) -> torch.Tensor:
        """The centred target_h x target_w crop of a meta batch (a view)."""
        plan = self.plan
        ph = (plan.meta_h - plan.target_h) // 2
        pw = (plan.meta_w - plan.target_w) // 2
        return meta[:, ph:ph + plan.target_h, pw:pw + plan.target_w]
