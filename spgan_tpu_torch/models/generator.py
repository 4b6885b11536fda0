"""The SP-GAN generator: structure synthesizer (spherical refiner) + texture
synthesizer (no-padding StyleGAN2 chain with spherical skip convs).
Counterpart of spgan_tpu/models/generator.py: the inference forward and
the training forward (sample-mode sphere convs, style mixing, the
mode-seeking diversity loss), with the SS options of the reference: noise
in the SS planar convs (ss_disable_noise false; the sphere convs never
take noise) and ss_mapping, an 8-layer mapping MLP on the global latent
before the SS modulation.

The styleGAN2 baseline family (styleGAN2_baseline, or use_ss false) has
no SS (``Generator.ss`` is None): its TS takes the local latent (B,4,4,C)
as the structure latent, in the zero-padding arch with a [1,3,3,1] blur,
to out_res 64 or 128.  It has the forward and the weight maps only; the
engines and the trainer refuse it, as the JAX package's do.

Parameters are nested dicts/lists of float32 tensors with the JAX
package's tree structure (so ``compat/from_jax.py`` carries weights across
key for key); conv weights are OIHW and linear weights (out, in).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.geometry.coords import (CoordGrid, CoordsPartial,
                                             encode_coords)
from spgan_tpu_torch.geometry.sphere_conv import (SphereSkipConv,
                                                  SphereStyledConv)
from spgan_tpu_torch.geometry.sphere_grid import (sphere_offset_tables_batch,
                                                  sphere_patch_grid_batch,
                                                  training_col_margin)
from spgan_tpu_torch.ops.linear import EqualLinear, pixel_norm
from spgan_tpu_torch.ops.modulated import (ModulatedConv2d, StyledConv, ToRGB,
                                           conv2d_nhwc)
from spgan_tpu_torch.ops.spatial import (ConvSpec, derive_stitch_geometry,
                                         out_size_chain)
from spgan_tpu_torch.parallel.mesh import all_reduce_mean
from spgan_tpu_torch.tree import tree_map
from spgan_tpu_torch.utils import trace


def create_fusion_styles(fusion_map: torch.Tensor, styles) -> torch.Tensor:
    """(B,N,H,W) region-weight maps and N style centres (B,D) -> the
    spatially fused style (B,H,W,D)."""
    fused = 0.0
    for i, st in enumerate(styles):
        fused = fused + fusion_map[:, i][..., None] * st[:, None, None, :]
    return fused


def pair_inputs(x: torch.Tensor) -> torch.Tensor:
    """[A,B,C,D] -> [A,A,C,C] (dual latents for the diversity loss); even
    batch only."""
    if x.shape[0] % 2:
        raise ValueError("dual-latent diversity loss expects an even batch")
    return x[0::2].repeat_interleave(2, dim=0)


def angular_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - angle(a, b)/pi per sample, in float32 whatever the compute dtype,
    with the cosine clipped strictly inside (-1, 1): arccos' is infinite at
    the clip boundary, and near-identical dual-latent outputs (bf16) would
    otherwise NaN every SS gradient."""
    a = a.reshape(a.shape[0], -1).float()
    b = b.reshape(b.shape[0], -1).float()
    denom = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1)
    cos = torch.sum(a * b, dim=1) / denom
    cos = torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)
    return 1.0 - torch.arccos(cos) / np.pi


def _center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    ph = (x.shape[1] - h) // 2
    pw = (x.shape[2] - w) // 2
    return x[:, ph:ph + h, pw:pw + w, :]


def _plain_conv1x1_init(gen: torch.Generator, in_ch: int, out_ch: int):
    """torch nn.Conv2d default init (kaiming uniform a=sqrt(5)): the SS
    residual projection `sc` is a plain conv."""
    bound = 1.0 / np.sqrt(in_ch)
    w = torch.rand((out_ch, in_ch, 1, 1), generator=gen) * (2 * bound) - bound
    b = torch.rand((out_ch,), generator=gen) * (2 * bound) - bound
    return {"weight": w, "bias": b}


def _plain_conv1x1(params, x):
    y = conv2d_nhwc(x, params["weight"].to(x.dtype))
    return y + params["bias"].to(x.dtype)


def tables_to(tables: dict, device) -> dict:
    return {k: v.to(device).contiguous() for k, v in tables.items()}


def patch_grids(cp: CoordsPartial, sizes: Sequence[int],
                device) -> List[torch.Tensor]:
    """The per-pixel patch grids of cp at each feature size, on device."""
    return [sphere_patch_grid_batch(cp, s, s).to(device) for s in sizes]


# layers of the ss_mapping MLP (reference: n_mlp 8)
SS_MAPPING_LAYERS = 8
# TS convs of the 101-pixel plan: a larger plan's convs past these (9-10
# of the 197 plan, with its fourth sphere skip conv and last ToRGB) run
# under the span spgan.generator.ts_top
TS_BASE_LAYERS = 8


# ----------------------------------------------------------------------
# Structure synthesizer
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class StructureSynthesizer:
    local_dim: int = 256
    global_dim: int = 512
    coord_dim: int = 3
    n_layers: int = 4
    unfold_radius: int = 3
    use_angular_div: bool = True
    # ss_disable_noise: when False the planar styled convs inject a noise
    # map each (the sphere convs never do)
    disable_noise: bool = True
    # ss_mapping: an 8-layer PixelNorm + EqualLinear(lr_mul 0.01,
    # fused_lrelu) MLP on the global latent before the SS modulation
    use_mapping: bool = False
    coord_grid: CoordGrid = dfield(default_factory=CoordGrid)

    @property
    def unfold_size(self) -> int:
        return self.n_layers * self.unfold_radius

    def sphere_spec(self) -> SphereStyledConv:
        return SphereStyledConv(
            local_dim=self.local_dim, coord_dim=self.coord_dim,
            out_ch=self.local_dim, style_dim=self.global_dim)

    def planar_spec(self) -> StyledConv:
        k = self.unfold_radius * 2 + 1
        return StyledConv(
            conv=ModulatedConv2d(
                in_ch=self.local_dim + self.coord_dim, out_ch=self.local_dim,
                kernel_size=k, style_dim=self.global_dim, demodulate=True,
                no_zero_pad=True),
            disable_noise=self.disable_noise)

    def mapping_spec(self) -> EqualLinear:
        return EqualLinear(self.global_dim, self.global_dim, lr_mul=0.01,
                           activation="fused_lrelu")

    def init(self, gen: torch.Generator) -> dict:
        params = {"blocks": [
            {"sphere": self.sphere_spec().init(gen),
             "sc": _plain_conv1x1_init(gen, self.local_dim, self.local_dim),
             "planar": self.planar_spec().init(gen)}
            for _ in range(self.n_layers)]}
        if self.use_mapping:
            params["mapping"] = [self.mapping_spec().init(gen)
                                 for _ in range(SS_MAPPING_LAYERS)]
        return params

    def map_global(self, params: dict, global_z: torch.Tensor) -> torch.Tensor:
        """The ss_mapping MLP (the identity when it is off)."""
        if not self.use_mapping:
            return global_z
        h = pixel_norm(global_z)
        spec = self.mapping_spec()
        for p in params["mapping"]:
            h = spec.apply(p, h)
        return h

    def layer_sizes(self, in_size: int) -> List[int]:
        """Feature size at each sphere conv (sphere convs preserve size, the
        k=7 planar convs shrink by 2*unfold_radius)."""
        return [in_size - 2 * self.unfold_radius * i
                for i in range(self.n_layers)]

    def noise_sizes(self, in_size: int) -> List[int]:
        """Size of each planar conv's output, where its noise map applies:
        the shapes of the SS noise maps."""
        return [s - 2 * self.unfold_radius for s in self.layer_sizes(in_size)]

    def train_tables(self, cp: CoordsPartial, in_size: int) -> List[dict]:
        """Per-sample offset tables for every sphere layer, on cp's device:
        the tables_list of tables_mode "sample"."""
        return [tables_to(sphere_offset_tables_batch(cp, s, s),
                          cp.p_x_st.device)
                for s in self.layer_sizes(in_size)]

    def apply(self, params: dict, global_z: torch.Tensor,
              local_latent: torch.Tensor, coords: torch.Tensor,
              grids: Optional[Sequence[torch.Tensor]],
              tables_list: Optional[Sequence[dict]], groups: int = 0,
              tables_mode: str = "fused",
              noises: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
        """global_z: (B, global_dim) raw z (mapped first with ss_mapping);
        local_latent: (B,S,S,local_dim); coords: (B,S,S,coord_dim) raw
        indices; grids/tables_list: per sphere layer, per patch (shared by
        B//groups samples when groups > 0).  tables_mode "sample" (training)
        takes per-sample tables and no grids, "grid" grids and no tables.
        noises: one (B,h,w,1) map per planar conv (noise_sizes), used when
        ss_disable_noise is False; None adds no noise."""
        h = local_latent
        global_z = self.map_global(params, global_z)
        sphere = self.sphere_spec()
        planar = self.planar_spec()
        for i, blk in enumerate(params["blocks"]):
            c = _center_crop(coords, h.shape[1], h.shape[2])
            y = sphere.apply(blk["sphere"], h, global_z, c,
                             None if grids is None else grids[i],
                             None if tables_list is None else tables_list[i],
                             groups=groups, tables_mode=tables_mode)
            y = F.leaky_relu(y, 0.01)
            h = y + _plain_conv1x1(blk["sc"], h)
            c = _center_crop(coords, h.shape[1], h.shape[2])
            enc = encode_coords(c, self.coord_dim).to(h.dtype)
            h = planar.apply(blk["planar"], torch.cat([h, enc], -1), global_z,
                             noise=None if noises is None else noises[i])
        return h

    def diversity_z_loss(self, local_latent: torch.Tensor,
                         structure_latent: torch.Tensor,
                         eps: float = 1e-5, mesh=None) -> torch.Tensor:
        """Mode-seeking loss over the dual-latent pairs (0,1), (2,3), ...:
        1 / (dist(structure) / dist(local latent) + eps).  With a mesh of
        more than one rank (data-parallel training, each rank an even
        block of the global batch), each mean distance is the mean over
        every rank's pairs."""
        def dist(v):
            if self.use_angular_div:
                d = angular_similarity(v[0::2], v[1::2]).mean()
            else:
                d = torch.abs(v[0::2] - v[1::2]).mean()
            if mesh is not None and mesh.world_size > 1:
                d = all_reduce_mean(d, mesh)
            return d

        return 1.0 / (dist(structure_latent) / dist(local_latent) + eps)


# ----------------------------------------------------------------------
# Texture synthesizer
# ----------------------------------------------------------------------

def ts_conv_plan(out_res: int, ts_input_size: int, channel_multiplier: int,
                 channel_base: int = 512
                 ) -> Tuple[List[dict], List[dict], Dict[int, int]]:
    """conv specs / to-rgb specs / sphere-skip map per output resolution.
    channel_base scales every width (512 in the shipped model)."""
    cm = channel_multiplier
    s = channel_base / 512.0

    def c(v):
        return max(8, int(round(v * s)))

    if ts_input_size == 11:
        base = [c(512)] * 6 + [c(256 * cm)] * 2
        ext = [c(128 * cm), c(64 * cm), c(32 * cm), c(16 * cm)]
        res_to_layers = {101: 8, 197: 10, 389: 12, 773: 14, 1541: 16}
        if out_res not in res_to_layers:
            raise NotImplementedError(f"no arch for out_res={out_res}")
        n = res_to_layers[out_res]
        chans = list(base)
        for i in range((n - 8) // 2):
            chans += [ext[i], ext[i]]
    elif ts_input_size == 4:  # the styleGAN2 baseline
        n = {128: 10, 64: 8}[out_res]
        chans = [c(512)] * 8 + [c(256 * cm)] * 2
    else:
        raise NotImplementedError(f"ts_input_size={ts_input_size}")
    convs = [dict(out_ch=ch, upsample=(i % 2 == 0))
             for i, ch in enumerate(chans[:n])]
    to_rgbs = [dict(src=s_, tgt=s_ + 2) for s_ in range(1, n - 2, 2)]
    to_rgbs.append(dict(src=n - 1, tgt=n))
    i2j = {101: {3: 0, 5: 1, 7: 2}, 197: {3: 0, 5: 1, 7: 2, 9: 3}}.get(
        out_res, {})
    return convs, to_rgbs, i2j


@dataclass(frozen=True)
class TextureSynthesizer:
    out_res: int = 101
    ts_input_size: int = 11
    local_dim: int = 256
    global_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    channel_base: int = 512
    no_zero_pad: bool = True
    blur_kernel: Tuple[float, ...] = (1.0, 2.0, 1.0)

    def plan(self):
        return ts_conv_plan(self.out_res, self.ts_input_size,
                            self.channel_multiplier, self.channel_base)

    @property
    def num_layers(self) -> int:
        return len(self.plan()[0])

    @property
    def n_latent(self) -> int:
        return self.num_layers + 1

    def conv_specs_spatial(self) -> List[ConvSpec]:
        return [ConvSpec(upsample=c["upsample"],
                         blur_len=len(self.blur_kernel))
                for c in self.plan()[0]]

    def stitch_geometry(self):
        return derive_stitch_geometry(self.conv_specs_spatial(),
                                      self.ts_input_size)

    def skip_sizes(self, in_size: Optional[int] = None) -> List[int]:
        """Input spatial size of each sphere skip conv (= the previous
        ToRGB's output size) for a structure latent of `in_size` (default
        ts_input_size)."""
        _, _, i2j = self.plan()
        out_sizes = out_size_chain(self.conv_specs_spatial(),
                                   in_size or self.ts_input_size)
        return [int(out_sizes[src - 2]) for src in sorted(i2j)]

    def noise_sizes(self, in_size: Optional[int] = None) -> List[int]:
        """Output size of each conv, where its noise map applies, for a
        structure latent of `in_size` (default ts_input_size): the
        no-padding chain, or with zero padding 2x at each upsample and
        the same size at each plain conv (4 -> 8 -> 8 -> 16 ...)."""
        h = in_size or self.ts_input_size
        if self.no_zero_pad:
            return out_size_chain(self.conv_specs_spatial(), h)
        sizes = []
        for c in self.plan()[0]:
            h = 2 * h if c["upsample"] else h
            sizes.append(h)
        return sizes

    def mapping_spec(self) -> EqualLinear:
        return EqualLinear(self.global_dim, self.global_dim, lr_mul=0.01,
                           activation="fused_lrelu")

    def _styled_convs(self) -> List[StyledConv]:
        specs = []
        in_ch = self.local_dim
        for c in self.plan()[0]:
            specs.append(StyledConv(
                conv=ModulatedConv2d(
                    in_ch=in_ch, out_ch=c["out_ch"], kernel_size=3,
                    style_dim=self.global_dim, demodulate=True,
                    upsample=c["upsample"], blur_kernel=self.blur_kernel,
                    no_zero_pad=self.no_zero_pad)))
            in_ch = c["out_ch"]
        return specs

    def _to_rgbs(self) -> List[ToRGB]:
        convs, to_rgbs, _ = self.plan()
        return [ToRGB(in_ch=convs[t["src"]]["out_ch"],
                      style_dim=self.global_dim,
                      blur_kernel=self.blur_kernel,
                      no_zero_pad=self.no_zero_pad)
                for t in to_rgbs]

    def init(self, gen: torch.Generator) -> dict:
        _, _, i2j = self.plan()
        return {
            "mapping": [self.mapping_spec().init(gen)
                        for _ in range(self.n_mlp)],
            "convs": [s.init(gen) for s in self._styled_convs()],
            "to_rgbs": [s.init(gen) for s in self._to_rgbs()],
            "sp_convs": [SphereSkipConv().init(gen) for _ in range(len(i2j))],
        }

    def mapping(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(z)
        spec = self.mapping_spec()
        for p in params["mapping"]:
            h = spec.apply(p, h)
        return h

    def mean_latent(self, params: dict, gen: torch.Generator,
                    n: int) -> torch.Tensor:
        """(1, D): the mean w of n z's drawn from `gen` (on the params'
        device)."""
        dev = params["mapping"][0]["weight"].device
        z = torch.randn((n, self.global_dim), generator=gen, device=dev)
        return self.mapping(params, z).mean(0, keepdim=True)

    def synthesize(self, params: dict, structure_latent: torch.Tensor,
                   styles, noises: Optional[Sequence[Optional[torch.Tensor]]],
                   skip_tables: Optional[Sequence[dict]],
                   skip_margins: Optional[Sequence[int]], groups: int = 0,
                   skip_grids: Optional[Sequence[torch.Tensor]] = None,
                   return_feats: bool = False):
        """structure_latent: (B,11,11,local_dim); styles: (B, n_latent, D),
        or a per-layer list of (B,D) vectors or (B,H,W,D) fused spatial
        styles; noises: one map per conv (None: no noise); skip_tables:
        per sphere skip conv, per patch (shared by B//groups samples when
        groups > 0); or, with skip_grids (B,3h,3w,2) per skip conv, no
        tables.  return_feats: also return the RGB skip before and after
        each sphere skip conv ({"to_rgb_i", "sphere_to_rgb_i"}).

        The skip graph: conv i runs, then when i == src of the pending
        to_rgb, the sphere skip conv (for i in i2j) transforms the running
        RGB skip before ToRGB(h, style[tgt], skip)."""
        convs, to_rgbs, i2j = self.plan()
        rgb_specs = self._to_rgbs()
        sphere_skip = SphereSkipConv()

        def style_at(idx):
            if isinstance(styles, (list, tuple)):
                return styles[idx]
            return styles[:, idx]

        h = structure_latent
        skip = None
        feats = {}
        cur_rgb = 0
        with contextlib.ExitStack() as top:
            for i, spec in enumerate(self._styled_convs()):
                if i == TS_BASE_LAYERS:
                    top.enter_context(trace.span("spgan.generator.ts_top"))
                h = spec.apply(params["convs"][i], h, style_at(i),
                               noise=None if noises is None else noises[i])
                t = to_rgbs[cur_rgb]
                if i == t["src"]:
                    if i in i2j:
                        j = i2j[i]
                        trace.count("spgan.generator.sphere_skip")
                        if return_feats:
                            feats[f"to_rgb_{i}"] = skip
                        if skip_grids is not None:
                            skip = sphere_skip.apply(
                                params["sp_convs"][j], skip, None,
                                grid=skip_grids[j])
                        else:
                            skip = sphere_skip.apply(
                                params["sp_convs"][j], skip, skip_tables[j],
                                groups=groups, margin=skip_margins[j])
                        if return_feats:
                            feats[f"sphere_to_rgb_{i}"] = skip
                    skip = rgb_specs[cur_rgb].apply(
                        params["to_rgbs"][cur_rgb], h, style_at(t["tgt"]),
                        skip)
                    cur_rgb += 1
        if return_feats:
            return skip, feats
        return skip


# ----------------------------------------------------------------------
# Full generator
# ----------------------------------------------------------------------

def skip_margin(tables: dict) -> int:
    """Exact column-shift margin of skip-conv tables: the tap conv needs
    margin >= max(-sx) and margin - 1 >= max(sx); at least 6."""
    return max(6, int(tables["sx"].abs().max()) + 1)


@dataclass(frozen=True)
class Generator:
    ss: Optional[StructureSynthesizer]
    ts: TextureSynthesizer
    use_div_z: bool = True

    @classmethod
    def from_config(cls, cfg: Config) -> "Generator":
        tp = cfg.train_params
        if tp.ss_coord_all_layers != "each_layer":
            raise ValueError(
                f"ss_coord_all_layers={tp.ss_coord_all_layers!r} is not "
                "supported; only 'each_layer' (the shipped mode)")
        ss = None
        if tp.use_ss and not tp.styleGAN2_baseline:
            ss = StructureSynthesizer(
                local_dim=tp.local_latent_dim,
                global_dim=tp.global_latent_dim,
                coord_dim=tp.coord_num_dir, n_layers=tp.ss_n_layers,
                unfold_radius=tp.ss_unfold_radius,
                use_angular_div=tp.diversity_angular,
                disable_noise=tp.ss_disable_noise,
                use_mapping=tp.ss_mapping,
                coord_grid=CoordGrid(
                    ts_input_size=tp.ts_input_size,
                    ss_unfold_size=tp.ss_unfold_size,
                    vert_sample_size=tp.coord_vert_sample_size,
                    hori_occupy_ratio=tp.coord_hori_occupy_ratio,
                    vert_cut_pt=tp.coord_vert_cut_pt,
                    num_dir=tp.coord_num_dir,
                    partial=tp.partial,
                    continuous=tp.coord_continuous))
        ts = TextureSynthesizer(
            out_res=(tp.patch_size if tp.training_modality == "patch"
                     else tp.full_size),
            ts_input_size=tp.ts_input_size,
            local_dim=tp.local_latent_dim, global_dim=tp.global_latent_dim,
            n_mlp=tp.n_mlp, channel_multiplier=tp.channel_multiplier,
            no_zero_pad=tp.ts_no_zero_pad,
            blur_kernel=(1.0, 2.0, 1.0) if tp.ts_no_zero_pad
            else (1.0, 3.0, 3.0, 1.0))
        return cls(ss=ss, ts=ts, use_div_z=(tp.diversity_z_w != 0))

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from `gen` (a CPU generator, so the same seed
        gives the same weights on every device), placed on `device`."""
        from spgan_tpu_torch.device import resolve

        dev = resolve(device)
        params = {"ts": self.ts.init(gen)}
        if self.ss is not None:
            params["ss"] = self.ss.init(gen)
        return _tree_to(params, dev)

    def build_styles(self, params: dict, global_latent: torch.Tensor,
                     inject_index: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """global_latent: (B, 2, D) -> (B, n_latent, D) w-space styles.
        inject_index (int or 0-d tensor in [1, n_latent]): styles before it
        map global_latent[:, 0], from it on global_latent[:, 1] (style
        mixing); None: no mixing."""
        n = self.ts.n_latent
        w1 = self.ts.mapping(params["ts"], global_latent[:, 0])
        if inject_index is None:
            return w1[:, None].expand(-1, n, -1)
        w2 = self.ts.mapping(params["ts"], global_latent[:, 1])
        idx = torch.arange(n, device=w1.device)[None, :, None]
        return torch.where(idx < inject_index, w1[:, None], w2[:, None])

    def training_skip_margins(self) -> List[int]:
        """Static column margins of the TS skip convs over every training
        crop (training grids use grid_partial 0.8)."""
        grid = self.ss.coord_grid
        return [training_col_margin(s, 3, grid.size_x, grid.size_y, 0.8)
                for s in self.ts.skip_sizes()]

    def apply(self, params: dict, *, global_latent: torch.Tensor,
              local_latent: torch.Tensor, coords: Optional[torch.Tensor],
              cp: Optional[CoordsPartial], noises: Sequence[torch.Tensor],
              ss_noises: Optional[Sequence[torch.Tensor]] = None,
              inject_index: Optional[torch.Tensor] = None,
              ss_tables_mode: str = "fused",
              ts_skip_margins: Optional[Sequence[int]] = None
              ) -> Dict[str, torch.Tensor]:
        """One patch per sample: global_latent (B,2,D), local_latent
        (B,S,S,local_dim), coords (B,S,S,coord_dim) raw indices, cp one
        crop per sample (on local_latent's device, or the CPU), noises one
        map per TS conv, ss_noises one map per SS planar conv (with
        ss_disable_noise False; None adds none).  The skip convs run on
        per-sample tap tables at the sizes this structure latent gives.

        ss_tables_mode "fused" (inference): the SS sphere convs run on the
        per-sample sphere-conv kernel; "sample" (training): on the tap
        sampler + einsum; "grid": SS and skip convs on the per-pixel patch
        grids, the JAX package's path without tables, exact on windows the
        row-offset tables do not describe (extrapolated crops).
        ts_skip_margins: static skip margins (training, no host sync);
        None measures them from the tables.  Returns {"gen":
        (B,patch,patch,3), "structure_latent", "styles"} (the training
        step takes the diversity loss of the structure latent,
        ss.diversity_z_loss).

        A styleGAN2 baseline (ss None) takes local_latent (B,4,4,C) as
        the structure latent; coords and cp are not read (None)."""
        dev = local_latent.device
        grids = tables = skip_grids = skip_tables = None
        if self.ss is None:
            structure = local_latent
        else:
            sizes = self.ss.layer_sizes(local_latent.shape[1])
            if ss_tables_mode == "sample":
                tables = self.ss.train_tables(cp, local_latent.shape[1])
            else:
                grids = patch_grids(cp, sizes, dev)
            if ss_tables_mode == "fused":
                tables = [tables_to(sphere_offset_tables_batch(cp, s, s),
                                    dev) for s in sizes]
            structure = self.ss.apply(params["ss"], global_latent[:, 0],
                                      local_latent, coords, grids, tables,
                                      tables_mode=ss_tables_mode,
                                      noises=ss_noises)
        skip_sizes = self.ts.skip_sizes(structure.shape[1])
        if ss_tables_mode == "grid":
            skip_grids = patch_grids(cp, skip_sizes, dev)
        else:
            skip = [sphere_offset_tables_batch(cp, s, s) for s in skip_sizes]
            if ts_skip_margins is None:
                ts_skip_margins = [skip_margin(t) for t in skip]
            skip_tables = [tables_to(t, dev) for t in skip]
        styles = self.build_styles(params, global_latent, inject_index)
        img = self.ts.synthesize(params["ts"], structure, styles, noises,
                                 skip_tables, ts_skip_margins,
                                 skip_grids=skip_grids)
        return {"gen": img, "structure_latent": structure, "styles": styles}

    def ss_on_grids(self, params: dict, gz: torch.Tensor,
                    local_latent: torch.Tensor, coords: torch.Tensor,
                    cp: CoordsPartial) -> torch.Tensor:
        """The SS modulated by gz (B, global_dim), its sphere convs on the
        per-pixel patch grids of cp (no SS noise)."""
        grids = patch_grids(cp, self.ss.layer_sizes(local_latent.shape[1]),
                            local_latent.device)
        return self.ss.apply(params["ss"], gz, local_latent, coords, grids,
                             None, tables_mode="grid")

    def ts_on_grids(self, params: dict, structure: torch.Tensor, styles,
                    cp: CoordsPartial, noises=None,
                    return_feats: bool = False):
        """The TS on `structure` with its sphere skip convs on the patch
        grids of cp; styles (B, n_latent, D) or a per-layer list."""
        skip_grids = patch_grids(cp, self.ts.skip_sizes(structure.shape[1]),
                                 structure.device)
        return self.ts.synthesize(params["ts"], structure, styles, noises,
                                  None, None, skip_grids=skip_grids,
                                  return_feats=return_feats)

    def get_to_rgb(self, params: dict, *, cp: CoordsPartial,
                   global_latent: Optional[torch.Tensor] = None,
                   local_latent: Optional[torch.Tensor] = None,
                   coords: Optional[torch.Tensor] = None,
                   structure_latent: Optional[torch.Tensor] = None,
                   styles=None, noises=None,
                   inject_index: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Debug forward returning the RGB skip around each sphere skip
        conv ("to_rgb_i", "sphere_to_rgb_i") and the patch ("patch"), on
        the patch grids.  structure_latent, or global_latent with
        local_latent and coords (not on a styleGAN2 baseline); styles, or
        global_latent (built as apply builds them)."""
        if structure_latent is None:
            if self.ss is None:
                raise ValueError(
                    "get_to_rgb without a structure_latent needs a structure "
                    "synthesizer; this is a styleGAN2 baseline generator "
                    "(styleGAN2_baseline, or use_ss false: g.ss is None)")
            structure_latent = self.ss_on_grids(
                params, global_latent[:, 0], local_latent, coords, cp)
        if styles is None:
            styles = self.build_styles(params, global_latent, inject_index)
        img, feats = self.ts_on_grids(params, structure_latent, styles, cp,
                                      noises, return_feats=True)
        feats["patch"] = img
        return feats

    def mean_latent(self, params: dict, gen: torch.Generator,
                    n: int = 4096) -> torch.Tensor:
        return self.ts.mean_latent(params["ts"], gen, n)

    def get_style(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        return self.ts.mapping(params["ts"], z)


def _tree_to(tree, device):
    return tree_map(lambda t: t.to(device), tree)
