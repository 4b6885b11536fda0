"""Width-sharded close-loop panoramas with a halo ring (counterpart of
spgan_tpu/infer/halo.py): the path for panoramas whose latent and noise
fields exceed what one card holds.

The cylindrical fields are split by width over the ranks of a
torch.distributed world, whole lattice columns to a rank.  Each rank
renders its own columns and receives only the SS padding ring (window -
step = 29 latent columns at the shipped widths) from its right neighbour
(mesh.ring_from_right, JAX's ppermute); each noise level exchanges its
own (size - step) halo the same way.

  * Only the num_steps_w_min base columns are rendered: the reference's
    two wrap columns are bit-identical re-renders of columns 0 and 1.
  * Lattice columns need not divide over the ranks: the fields are
    extended by `pad` wrapped columns (copies of columns 0..pad-1) so
    every rank holds an equal shard, rank 0 sends its halo from the wrap
    offset pad*step, and the duplicate patches are dropped before
    assembly.
  * Fields do not depend on the world size: the latent and noise fields
    of lattice column j are drawn from a generator keyed by (seed, j),
    so each rank draws only its own shard and N ranks equal one rank bit
    for bit.  `from_fields` takes global fields instead (parity tests).
  * Rendering shares the engine's folded body (engine.render_patches):
    the SS sphere convs on the sphere-conv kernel, one chunk of one
    lattice column (num_steps_h rows) x batch panoramas per call.
  * Rank 0 gathers the patches and assembles the meta image as the
    folded engine does (engine.scatter_patches: the reference's row-major
    overwrite order, the wrap columns writing their base columns'
    renders; with SS noise the overlaps of neighbouring patches differ,
    so the order shows); it returns the meta image, the other ranks
    None.
  * Build once (make_width_sharded_generate) and call per batch: all the
    static algebra (lattice metadata, tap tables, margins) is done at
    build.  generate_width_sharded builds anew on every call.
  * SS noise (ss_disable_noise false): one (B, s, s, 1) map per SS
    planar conv and sample, drawn after the global latents from the same
    tag-0 generator, so every rank holds the same maps; like the folded
    engine's, they are shared by every lattice position and never
    width-sharded.  (The JAX package's halo body renders without them,
    fault C8 of ROADMAP.)
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from spgan_tpu_torch.config import COMPUTE_DTYPES
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.geometry.coords import CoordsPartial
from spgan_tpu_torch.geometry.sphere_grid import (sphere_offset_tables_batch,
                                                  sphere_patch_grid_batch)
from spgan_tpu_torch.infer.engine import (refuse_planar, render_patches,
                                          scatter_patches, wrap_full_map)
from spgan_tpu_torch.infer.stitcher import LatticePlan
from spgan_tpu_torch.models.generator import Generator, skip_margin, tables_to
from spgan_tpu_torch.parallel.mesh import Mesh, gather_rows, ring_from_right


def halo_from_right(arr: torch.Tensor, width: int, dim: int, wrap_off: int,
                    mesh: Mesh) -> torch.Tensor:
    """The `width` columns (along `dim`) that follow this rank's shard:
    every rank sends the first `width` columns of its shard to its left
    neighbour, rank 0 from the wrap offset `wrap_off` (with padding, the
    last rank's halo is the true columns that follow the padded field's
    end, mod the circle)."""
    off = wrap_off if mesh.rank == 0 else 0
    if off + width > arr.shape[dim]:
        raise ValueError(f"halo {width} + offset {off} exceed the shard's "
                         f"{arr.shape[dim]} columns")
    return ring_from_right(arr.narrow(dim, off, width), mesh)


def column_generator(seed: int, tag: int, device) -> torch.Generator:
    """The generator of one block of fields: a function of (seed, tag)
    only (tag 0: the global latents; 1 + j: lattice column j)."""
    s = np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


class WidthShardedGenerate:
    """generate(params, seed) -> meta (B, meta_h, meta_w, 3) float32 on
    rank 0, None on the other ranks.  Build with
    make_width_sharded_generate."""

    def __init__(self, g: Generator, plan: LatticePlan, mesh: Mesh,
                 batch: int, grid_partial: float,
                 compute_dtype: str = "float32",
                 device: Optional[Union[str, torch.device]] = None):
        refuse_planar(g)
        if not plan.close_loop:
            raise ValueError("width sharding targets closed-loop panoramas")
        self.g, self.plan, self.mesh, self.batch = g, plan, mesh, batch
        self.device = resolve(device)
        self.cdt = COMPUTE_DTYPES[compute_dtype]
        ndev = mesh.world_size
        zx = plan.geom.latentspace_step
        win = plan.window
        nw = plan.num_steps_w_min
        nh = plan.num_steps_h
        # pad + drop: the cylindrical fields are extended by `pad` wrapped
        # columns so every rank holds an equal shard
        cols_per_dev = -(-nw // ndev)  # ceil
        nw_pad = cols_per_dev * ndev
        pad = nw_pad - nw
        shard_w = cols_per_dev * zx
        halo_z = win - zx
        # rank 0 sends its halo from offset pad*zx, so both the halo and
        # that offset must fit inside one shard; and a padded column's
        # window must not cross the seam
        if pad * zx + halo_z > shard_w:
            raise ValueError(
                f"shard width {shard_w} latent cols < halo {halo_z} + wrap "
                f"offset {pad * zx}; use a wider panorama or fewer devices")
        if pad * zx + win > plan.y_total:
            raise ValueError((pad, win, plan.y_total))
        out_sizes = plan.geom.outfeat_sizes
        out_steps = plan.geom.outfeat_steps
        for osz, ostep in zip(out_sizes, out_steps):
            if pad * ostep + (osz - ostep) > cols_per_dev * ostep:
                raise ValueError(
                    f"noise level size {osz} step {ostep}: halo "
                    f"{osz - ostep} + wrap offset {pad * ostep} exceeds "
                    f"shard width {cols_per_dev * ostep}; use a wider "
                    "panorama or fewer devices")
        self.cols_per_dev, self.pad, self.zx = cols_per_dev, pad, zx
        self.nw, self.nw_pad, self.nh = nw, nw_pad, nh
        self.halo_z = halo_z

        # ---- static per-position metadata (host) ----------------------
        # cp scalars of every global column, rank-major / column-major /
        # row-minor: x parts in f64-then-f32 as the stitcher, y parts in
        # f32; padded columns (jg >= nw) normalise to their base column's
        # cp by the mod-wrap rule.  One chunk is one lattice column.
        yt32 = np.float32(plan.y_total)
        cps_host = np.zeros((ndev, cols_per_dev, nh, 5), np.float32)
        for jg in range(nw_pad):
            dev, jl = divmod(jg, cols_per_dev)
            zy_raw = jg * zx
            circ = np.float32(zy_raw + win > plan.y_total
                              and zy_raw < plan.y_total)
            zy = np.float32(zy_raw % plan.y_total if zy_raw >= plan.y_total
                            else zy_raw)
            p_y_st = zy / yt32
            p_y_ed = (zy + np.float32(win + 1)) / yt32
            for i in range(nh):
                zr = i * zx
                cps_host[dev, jl, i] = (
                    np.float32(zr / plan.x_total),
                    np.float32((zr + win + 1) / plan.x_total),
                    p_y_st, p_y_ed, circ)
        # local slice starts: the same on every rank (column-major fold)
        self.zs = np.zeros((cols_per_dev, nh, 2), np.int64)
        self.ns = [np.zeros((cols_per_dev, nh, 2), np.int64)
                   for _ in out_steps]
        for jl in range(cols_per_dev):
            for i in range(nh):
                self.zs[jl, i] = (i * zx, jl * zx)
                for li, ostep in enumerate(out_steps):
                    self.ns[li][jl, i] = (i * ostep, jl * ostep)

        # exact skip-conv shift margins from the full static cp set
        def cp_of(rows):
            return CoordsPartial.from_scalars(rows, plan.x_total,
                                              plan.y_total, grid_partial)

        skip_sizes = g.ts.skip_sizes()
        cp_all = cp_of(cps_host.reshape(-1, 5))
        self.skip_margins = [skip_margin(sphere_offset_tables_batch(
            cp_all, s, s)) for s in skip_sizes]
        # this rank's grids and tables, chunk by chunk
        dev = self.device
        ss_sizes = g.ss.layer_sizes(win)
        self.grids, self.tables, self.skip_tables = [], [], []
        for q in range(cols_per_dev):
            cp = cp_of(cps_host[mesh.rank, q])
            self.grids.append([sphere_patch_grid_batch(cp, s, s).to(dev)
                               for s in ss_sizes])
            self.tables.append([
                tables_to(sphere_offset_tables_batch(cp, s, s), dev)
                for s in ss_sizes])
            self.skip_tables.append([
                tables_to(sphere_offset_tables_batch(cp, s, s), dev)
                for s in skip_sizes])
        # the coordinate field is static: this rank's shard of the padded
        # field and the halo its right neighbour would send
        coords = torch.as_tensor(g.ss.coord_grid.test_field(
            plan.z_field_h, plan.z_field_w))
        coords = torch.cat([coords, coords[:, :pad * zx]], dim=1)
        right = (mesh.rank + 1) % ndev
        h0 = right * shard_w + (pad * zx if right == 0 else 0)
        self.coords_ext = torch.cat(
            [coords[:, mesh.rank * shard_w:(mesh.rank + 1) * shard_w],
             coords[:, h0:h0 + halo_z]], dim=1).to(dev)

    # ----------------------------------------------------------- fields
    def _columns(self):
        """The global lattice columns of this rank's shard, padded columns
        as the base columns they copy."""
        r, cpd = self.mesh.rank, self.cols_per_dev
        return [jg % self.nw for jg in range(r * cpd, (r + 1) * cpd)]

    def _draw_column(self, seed: int, j: int):
        """(z block (B, z_field_h, step, local_dim), [noise block (B, h,
        step_l, 1) per level]) of lattice column j."""
        plan, B = self.plan, self.batch
        gen = column_generator(seed, 1 + j, self.device)
        kw = dict(generator=gen, device=self.device)
        z = torch.randn((B, plan.z_field_h, self.zx, self.g.ts.local_dim),
                        **kw)
        noises = [torch.randn((B, h, ostep, 1), **kw)
                  for (h, _), ostep in zip(plan.noise_sizes,
                                           plan.geom.outfeat_steps)]
        return z, noises

    def _draw_global(self, seed: int):
        """(gl (B, 2, D), [SS noise map (B, s, s, 1) per SS planar conv,
        none with ss_disable_noise]) of `seed`: the same on every rank."""
        kw = dict(generator=column_generator(seed, 0, self.device),
                  device=self.device)
        gl = torch.randn((self.batch, 2, self.g.ts.global_dim), **kw)
        gl[:, 1] = gl[:, 0]  # no mixing at test
        ss_maps = [] if self.g.ss.disable_noise else [
            torch.randn((self.batch, s, s, 1), **kw)
            for s in self.g.ss.noise_sizes(self.plan.window)]
        return gl, ss_maps

    def global_fields(self, seed: int):
        """(gl, z_field, noises) of `seed` whole, as the folded engine takes
        them (the SS noise maps after the TS noise fields): what every
        rank's shards are cut from."""
        cols = [self._draw_column(seed, j) for j in range(self.nw)]
        z = torch.cat([c[0] for c in cols], dim=2)
        noises = [torch.cat([c[1][li] for c in cols], dim=2)
                  for li in range(len(self.plan.noise_sizes))]
        gl, ss_maps = self._draw_global(seed)
        return gl, z, noises + ss_maps

    # ------------------------------------------------------------ render
    def __call__(self, params, seed: int) -> Optional[torch.Tensor]:
        """One batch from `seed`: this rank draws only its own columns."""
        cols = [self._draw_column(seed, j) for j in self._columns()]
        z_local = torch.cat([c[0] for c in cols], dim=2)
        n_local = [torch.cat([c[1][li] for c in cols], dim=2)
                   for li in range(len(self.plan.noise_sizes))]
        return self._render(params, *self._draw_global(seed), z_local,
                            n_local)

    def from_fields(self, params, gl, z_field, noises
                    ) -> Optional[torch.Tensor]:
        """One batch from global fields (B, z_field_h, z_field_w, D) and
        [(B, h, w, 1)], the SS noise maps after the TS noise fields as
        global_fields gives them (every rank passes the same); this rank
        takes its shard of the wrap-padded fields."""
        dev, r, pad = self.device, self.mesh.rank, self.pad
        n_ts = len(self.plan.noise_sizes)

        def shard(f, step):
            f = torch.as_tensor(f, device=dev)
            f = torch.cat([f, f[:, :, :pad * step]], dim=2)
            w = self.cols_per_dev * step
            return f[:, :, r * w:(r + 1) * w]

        steps = self.plan.geom.outfeat_steps
        return self._render(
            params, torch.as_tensor(gl, device=dev),
            [torch.as_tensor(m, device=dev) for m in noises[n_ts:]],
            shard(z_field, self.zx),
            [shard(n, s) for n, s in zip(noises[:n_ts], steps)])

    @torch.inference_mode()
    def _render(self, params, gl, ss_maps, z_local, n_local):
        plan, g, mesh, pad = self.plan, self.g, self.mesh, self.pad
        # SS padding ring and the noise levels' halos from the right
        z_ext = torch.cat([z_local, halo_from_right(
            z_local, self.halo_z, 2, pad * self.zx, mesh)], dim=2)
        n_ext = [torch.cat([n, halo_from_right(n, osz - ostep, 2,
                                               pad * ostep, mesh)], dim=2)
                 for n, osz, ostep in zip(n_local, plan.geom.outfeat_sizes,
                                          plan.geom.outfeat_steps)]
        styles = g.build_styles(params, gl)
        gz = gl[:, 0]
        patches = torch.cat([render_patches(
            g, params, styles, gz, z_ext, self.coords_ext, n_ext,
            self.zs[q], [ns[q] for ns in self.ns], self.grids[q],
            self.tables[q], self.skip_tables[q], self.skip_margins,
            batch=self.batch, win=plan.window,
            out_sizes=plan.geom.outfeat_sizes, cdt=self.cdt,
            ss_maps=ss_maps).float()
            for q in range(self.cols_per_dev)])
        patches = gather_rows(patches, mesh)
        if patches is None:
            return None
        # (rank, local column, row) -> row-major (row, base column),
        # dropping the padded wrap columns (duplicates of base columns
        # 0..pad-1); then the folded engine's assembly, the wrap columns
        # writing their base columns' renders
        p = plan.geom.outfeat_sizes[-1]
        patches = patches.reshape(self.nw_pad, self.nh, self.batch, p, p,
                                  3)[:self.nw].transpose(0, 1).reshape(
                                      self.nh * self.nw, self.batch, p, p, 3)
        return scatter_patches(plan, patches, wrap_full_map(plan))


def make_width_sharded_generate(g: Generator, plan: LatticePlan, mesh: Mesh,
                                batch: int, grid_partial: float,
                                compute_dtype: str = "float32", device=None
                                ) -> WidthShardedGenerate:
    """Build the width-sharded generator ONCE; call it per batch as
    generate(params, seed), or generate.from_fields(params, gl, z_field,
    noises).  Every rank builds and calls it together.

    Bit-identity across world sizes: every render call is one whole
    global lattice column, so every position is rendered by the same
    program on the same inputs whatever the number of ranks."""
    return WidthShardedGenerate(g, plan, mesh, batch, grid_partial,
                                compute_dtype=compute_dtype, device=device)


def generate_width_sharded(g: Generator, params, plan: LatticePlan,
                           mesh: Mesh, seed: int, batch: int,
                           grid_partial: float,
                           compute_dtype: str = "float32", device=None
                           ) -> Optional[np.ndarray]:
    """One call: the meta image (B, meta_h, meta_w, 3) as numpy on rank 0,
    None on the others.  It builds the generator on every call (nothing is
    cached); to render more than one batch, keep the callable of
    make_width_sharded_generate."""
    meta = make_width_sharded_generate(
        g, plan, mesh, batch, grid_partial, compute_dtype=compute_dtype,
        device=device)(params, seed)
    return None if meta is None else meta.cpu().numpy()
