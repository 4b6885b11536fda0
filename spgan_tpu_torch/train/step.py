"""The GAN training step: D, lazy R1, G, lazy PPL and EMA (counterpart of
spgan_tpu/train/step.py).

  1. D adversarial step (+ coordinate-AC losses) on a fake batch made
     without a graph;
  2. lazy R1 (double grad through D) with the torch-Adam graph mask;
  3. G adversarial step (+ coordinate AC + mode-seeking diversity);
  4. lazy PPL (double grad through the texture synthesizer);
  5. EMA accumulate.

Gradients come from torch.autograd.grad on parameter trees
(create_graph=True inside R1 and PPL).  After each optimizer update the
G update is zeroed on the leaves of the freeze mask (baseline transfer)
and, with freeze, the whole D update (R1 included); the optimizer's state
still advances.  The lr schedule's factor multiplies every update.  Every G forward runs the SS sphere
convs in tables_mode "sample": the tap sampler kernel on cuda, its plain
version on the CPU.  Every random draw of a step (latents, crop origins and
jitter, the mixing coin, the inject index, the noise maps of each G forward
and the PPL perturbation) comes from one function, ``TrainStep.draw``,
which a caller may replace to feed known draws.

Data-parallel (a mesh of N ranks, one process each; the JAX step's batch
sharding): every rank draws the same global StepDraws and keeps its block
of rows of each, takes its block of the real batch, and backpropagates
its local-mean losses; the D's minibatch stddev and the batch means of
the diversity loss and the PPL running mean span every rank's rows.  Each
phase's gradients are all-reduced (one flat buffer, the sum over the
ranks divided by N) before anything reads them (the grad norms, Adam's
zero test, the R1 mask), so every rank applies the same update; the
loss metrics are averaged over the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from spgan_tpu_torch.config import COMPUTE_DTYPES, Config
from spgan_tpu_torch.geometry.sphere_grid import sphere_offset_tables_batch
from spgan_tpu_torch.models import losses
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator, pair_inputs, tables_to
from spgan_tpu_torch.models.latents import LatentSampler
from spgan_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean,
                                           all_reduce_mean_, shard_batch)
from spgan_tpu_torch.train.state import (TrainState, ema_update, global_norm,
                                         lr_schedule_factor, make_optimizers)
from spgan_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from spgan_tpu_torch.utils import trace


@dataclass
class GDraws:
    """The random inputs of one G forward of `bsz` samples."""

    gl: torch.Tensor            # (bsz, 2, global_dim) float32, mixing applied
    ll: torch.Tensor            # (bsz, S, S, local_dim) float32
    x_st: torch.Tensor          # (bsz,) int64 crop rows
    y_st: torch.Tensor          # (bsz,) int64 crop columns
    jitter: torch.Tensor        # (num_dir,) float32, shared by the batch
    inject: torch.Tensor        # 0-d int64 in [1, n_latent)
    noises: List[torch.Tensor]  # one (bsz, h, w, 1) map per TS conv
    # one (bsz, h, w, 1) map per SS planar conv (ss_disable_noise False)
    ss_noises: List[torch.Tensor] = field(default_factory=list)


@dataclass
class StepDraws:
    d: GDraws
    g: GDraws
    ppl: Optional[GDraws] = None
    ppl_noise: Optional[torch.Tensor] = None  # (pbsz, P, P, 3) N(0, 1)


def _with_grad(tree):
    """A copy of `tree` whose leaves require grad, and those leaves."""
    t = tree_map(lambda p: p.detach().requires_grad_(True), tree)
    return t, tree_leaves(t)


def shard_draws(draws, mesh: Mesh):
    """This rank's rows of every per-sample tensor of a StepDraws or
    GDraws (the crop jitter and the inject index are shared)."""
    def take(name, v):
        if name in ("jitter", "inject"):
            return v
        if dataclasses.is_dataclass(v):
            return shard_draws(v, mesh)
        return shard_batch(v, mesh)

    return dataclasses.replace(draws, **{
        f.name: take(f.name, getattr(draws, f.name))
        for f in dataclasses.fields(draws)})


def refuse_baseline(cfg: Config) -> None:
    """Raise for a styleGAN2 baseline config: the step draws SS crops and
    runs the SS every phase (the JAX package's step fails on it with an
    AttributeError)."""
    tp = cfg.train_params
    if tp.styleGAN2_baseline or not tp.use_ss:
        raise ValueError(
            f"styleGAN2_baseline: {tp.styleGAN2_baseline}, use_ss: "
            f"{tp.use_ss}: the styleGAN2 baseline family has no structure "
            "synthesizer and cannot be trained here (the training step "
            "needs one, as the JAX package's does); Generator.apply "
            "renders it")


class TrainStep:
    """step(state, real_patch, real_ac, gen, do_r1, do_ppl) -> (state,
    metrics).  real_patch (B,P,P,3) in [-1,1] and real_ac (B,3) on the
    state's device (with a mesh: this rank's B/N rows of the global
    batch); gen a torch.Generator on that device (used by ``draw``).
    Metrics are 0-d tensors on the device (no host sync)."""

    def __init__(self, cfg: Config, g: Generator, d: Discriminator,
                 draw: Optional[Callable[..., StepDraws]] = None,
                 freeze_g_mask: Optional[Any] = None,
                 mesh: Optional[Mesh] = None):
        refuse_baseline(cfg)
        tp = cfg.train_params
        self.mesh = mesh if mesh is not None else Mesh()
        # a process group (NCCL's world of one included) runs the
        # collectives; the batch statistics gather only across ranks
        self.multi = self.mesh.backend is not None
        if self.mesh.world_size > 1:
            self._check_split(cfg, g)
        self.cfg, self.g, self.d = cfg, g, d
        # a tree of python bools over params_g (True: the update is zeroed)
        self.freeze_g_mask = freeze_g_mask
        self.opt_g, self.opt_d = make_optimizers(cfg)
        self.cdt = COMPUTE_DTYPES[tp.compute_dtype]
        self.sampler = LatentSampler(
            global_dim=tp.global_latent_dim, local_dim=tp.local_latent_dim,
            ts_input_size=tp.ts_input_size, ss_unfold_size=tp.ss_unfold_size,
            mixing=tp.mixing)
        self.skip_margins = g.training_skip_margins()
        self.noise_sizes = g.ts.noise_sizes(tp.ts_input_size)
        self.ss_noise_sizes = ([] if g.ss.disable_noise else
                               g.ss.noise_sizes(self.sampler.local_shape()[0]))
        if draw is not None:
            self.draw = draw

    def _check_split(self, cfg: Config, g: Generator) -> None:
        """The global batches must split into whole blocks, even ones where
        dual latents pair adjacent samples."""
        tp, n = cfg.train_params, self.mesh.world_size
        paired = g.use_div_z and tp.diversity_dual
        batches = [("batch_size", tp.batch_size)]
        if tp.path_regularize != 0:
            batches.append((f"the PPL batch (batch_size {tp.batch_size} // "
                            f"path_batch_shrink {tp.path_batch_shrink})",
                            max(1, tp.batch_size // tp.path_batch_shrink)))
        for what, b in batches:
            if b % n:
                raise ValueError(f"{what} = {b} does not split over {n} "
                                 "ranks")
            if paired and (b // n) % 2:
                raise ValueError(
                    f"{what} = {b} over {n} ranks gives {b // n} a rank: "
                    "the diversity loss pairs adjacent samples, so each "
                    "rank's block must be even")

    # ---------------------------------------------------------------- draws
    def draw_g(self, gen: torch.Generator, bsz: int) -> GDraws:
        dev = gen.device
        x_st, y_st, jitter = self.g.ss.coord_grid.draw_training(gen, bsz)
        return GDraws(
            gl=self.sampler.sample_global(gen, bsz),
            ll=self.sampler.sample_local(gen, bsz),
            x_st=x_st, y_st=y_st, jitter=jitter,
            inject=torch.randint(1, self.g.ts.n_latent, (), generator=gen,
                                 device=dev),
            noises=[torch.randn((bsz, s, s, 1), generator=gen,
                                device=dev).to(self.cdt)
                    for s in self.noise_sizes],
            ss_noises=[torch.randn((bsz, s, s, 1), generator=gen,
                                   device=dev).to(self.cdt)
                       for s in self.ss_noise_sizes])

    def draw(self, gen: torch.Generator, do_ppl: bool) -> StepDraws:
        """Every random draw of one step, from `gen`."""
        tp = self.cfg.train_params
        b = tp.batch_size
        dr = StepDraws(d=self.draw_g(gen, b), g=self.draw_g(gen, b))
        if do_ppl and tp.path_regularize != 0:
            pb = max(1, b // tp.path_batch_shrink)
            dr.ppl = self.draw_g(gen, pb)
            p = self.g.ts.out_res
            dr.ppl_noise = torch.randn((pb, p, p, 3), generator=gen,
                                       device=gen.device).to(self.cdt)
        return dr

    # -------------------------------------------------------------- forward
    def g_inputs(self, dr: GDraws):
        """(gl, ll, coords, ac, cp) of one G forward.  Dual latents pair gl
        and coords only: ll, ac and cp stay unpaired (faithful)."""
        coords, ac, cp = self.g.ss.coord_grid.training_crops(
            dr.x_st, dr.y_st, dr.jitter)
        gl = dr.gl
        if self.g.use_div_z and self.cfg.train_params.diversity_dual:
            gl = pair_inputs(gl)
            coords = pair_inputs(coords)
        return gl.to(self.cdt), dr.ll.to(self.cdt), coords, ac, cp

    def g_forward(self, params_g, dr: GDraws, compute_diversity: bool):
        gl, ll, coords, ac, cp = self.g_inputs(dr)
        out = self.g.apply(params_g, global_latent=gl, local_latent=ll,
                           coords=coords, cp=cp, noises=dr.noises,
                           ss_noises=dr.ss_noises or None,
                           inject_index=dr.inject, ss_tables_mode="sample",
                           ts_skip_margins=self.skip_margins)
        if compute_diversity and self.g.use_div_z:
            out["diversity_z_loss"] = self.g.ss.diversity_z_loss(
                ll, out["structure_latent"], mesh=self.mesh)
        out["ac_coords"] = ac
        return out

    def d_out(self, params_d, img, ac) -> Dict[str, torch.Tensor]:
        """D at training time (the projection head reads the labels `ac`),
        in float32."""
        return {k: v.float() for k, v in
                self.d.apply(params_d, img, ac_coords=ac, train=True,
                             mesh=self.mesh).items()}

    def ac_loss(self, pred, label):
        tp = self.cfg.train_params
        return losses.coord_ac_loss(pred, label,
                                    vert_only=tp.coord_ac_vert_only,
                                    hori_only=tp.coord_ac_hori_only)

    # --------------------------------------------------------------- phases
    def d_grads(self, params_g, params_d, real, real_ac, dr: GDraws):
        """D adversarial (+ coordinate-AC) loss on a fake batch made without
        a graph: (grads in tree_leaves order, metrics)."""
        tp = self.cfg.train_params
        with torch.no_grad():
            fake = self.g_forward(params_g, dr, False)
        pd, leaves = _with_grad(params_d)
        fp = self.d_out(pd, fake["gen"], fake["ac_coords"])
        rp = self.d_out(pd, real, real_ac)
        loss = losses.d_logistic_loss(rp["d_patch"], fp["d_patch"])
        metrics = {"d_adv_loss": loss.detach()}
        if self.d.use_coord_ac:
            ac_r = self.ac_loss(rp["ac_coords_pred"], real_ac)
            ac_f = self.ac_loss(fp["ac_coords_pred"], fake["ac_coords"])
            loss = loss + (ac_r + ac_f) * tp.coord_ac_w
            metrics["d_ac_coords_real"] = ac_r.detach()
            metrics["d_ac_coords_fake"] = ac_f.detach()
        metrics["d_total_loss"] = loss.detach()
        return list(torch.autograd.grad(loss, leaves, allow_unused=True)), \
            metrics

    def r1_grads(self, params_d, real, real_ac):
        """Lazy R1 through the training-time D: (grads of r1/2 * penalty *
        d_reg_every, penalty)."""
        tp = self.cfg.train_params
        pd, leaves = _with_grad(params_d)
        r1 = losses.d_r1_penalty(self.d.apply, pd, real, ac_coords=real_ac,
                                 train=True, mesh=self.mesh)
        loss = tp.r1 / 2.0 * r1 * tp.d_reg_every
        return (list(torch.autograd.grad(loss, leaves, allow_unused=True)),
                r1.detach())

    def g_grads(self, params_g, params_d, dr: GDraws):
        """G non-saturating (+ coordinate AC + diversity) loss: (grads,
        metrics)."""
        tp = self.cfg.train_params
        pg, leaves = _with_grad(params_g)
        out = self.g_forward(pg, dr, True)
        fp = self.d_out(params_d, out["gen"], out["ac_coords"])
        loss = losses.g_nonsaturating_loss(fp["d_patch"])
        metrics = {"g_adv_loss": loss.detach()}
        if self.d.use_coord_ac:
            ac_f = self.ac_loss(fp["ac_coords_pred"], out["ac_coords"])
            loss = loss + ac_f * tp.coord_ac_w
            metrics["g_ac_coords_fake"] = ac_f.detach()
        if self.g.use_div_z:
            div = out["diversity_z_loss"]
            loss = loss + div * tp.diversity_z_w
            metrics["diversity_z_loss"] = div.detach()
        metrics["g_total_loss"] = loss.detach()
        return list(torch.autograd.grad(loss, leaves, allow_unused=True)), \
            metrics

    def ppl_grads(self, params_g, dr: StepDraws, mean_path: torch.Tensor):
        """Lazy PPL: (grads of path_regularize * g_reg_every * penalty,
        penalty, new running mean, mean path length)."""
        tp = self.cfg.train_params
        pg, leaves = _with_grad(params_g)
        penalty, new_mean, plen = self.ppl_penalty(pg, dr, mean_path)
        weighted = tp.path_regularize * tp.g_reg_every * penalty
        grads = list(torch.autograd.grad(weighted, leaves, allow_unused=True))
        return grads, penalty.detach(), new_mean, plen.detach()

    def _reduce(self, grads: List[Optional[torch.Tensor]]):
        """The phase's gradients averaged over the ranks, in place."""
        if self.multi:
            with trace.span("spgan.train.all_reduce"):
                all_reduce_mean_(grads, self.mesh)
        return grads

    # ----------------------------------------------------------------- step
    def __call__(self, state: TrainState, real_patch: torch.Tensor,
                 real_ac: torch.Tensor, gen: torch.Generator,
                 do_r1: bool, do_ppl: bool
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        trace.count("spgan.train.steps")
        with trace.span("spgan.train.step", state.step):
            return self._step(state, real_patch, real_ac, gen, do_r1, do_ppl)

    def _step(self, state, real_patch, real_ac, gen, do_r1, do_ppl):
        tp = self.cfg.train_params
        with trace.span("spgan.train.draw"):
            dr = self.draw(gen, do_ppl)
            if self.multi:
                dr = shard_draws(dr, self.mesh)
        real = real_patch.to(self.cdt)
        zero = torch.zeros((), device=real.device)
        # the update rules of the JAX step: the lr factor of this
        # iteration; with freeze the D update is zeroed whole, and the G
        # update on the freeze mask's leaves
        upd_d = {"factor": lr_schedule_factor(self.cfg, state.step),
                 "frozen": (tree_map(lambda _: True, state.params_d)
                            if tp.freeze else None)}
        upd_g = {"factor": upd_d["factor"], "frozen": self.freeze_g_mask}

        with trace.span("spgan.train.d"):
            grads, metrics = self.d_grads(state.params_g, state.params_d,
                                          real, real_ac, dr.d)
        self._reduce(grads)
        with trace.span("spgan.train.update"), torch.no_grad():
            metrics["grad_norm/d"] = global_norm(grads)
            params_d, opt_d = self.opt_d.step(
                state.params_d, tree_unflatten(state.params_d, grads),
                state.opt_d, **upd_d)

        metrics["r1"] = zero
        if do_r1 and tp.r1 != 0:
            with trace.span("spgan.train.r1"):
                grads, metrics["r1"] = self.r1_grads(params_d, real, real_ac)
            self._reduce(grads)
            with trace.span("spgan.train.update"), torch.no_grad():
                # torch-Adam's graph membership in the R1 phase; SGD has
                # no per-leaf state, so it takes no mask
                active = (None if tp.optimizer == "sgd"
                          else self.d.r1_graph_mask(params_d))
                params_d, opt_d = self.opt_d.step(
                    params_d, tree_unflatten(params_d, grads), opt_d,
                    active=active, **upd_d)

        with trace.span("spgan.train.g"):
            grads, g_metrics = self.g_grads(state.params_g, params_d, dr.g)
        self._reduce(grads)
        metrics.update(g_metrics)
        with trace.span("spgan.train.update"), torch.no_grad():
            gtree = tree_unflatten(state.params_g, grads)
            metrics["grad_norm/g"] = global_norm(gtree)
            metrics["grad_norm/g_ss"] = global_norm(gtree["ss"])
            metrics["grad_norm/g_ts"] = global_norm(gtree["ts"])
            params_g, opt_g = self.opt_g.step(state.params_g, gtree,
                                              state.opt_g, **upd_g)

        mean_path = state.mean_path_length
        metrics["path"] = metrics["path_lengths"] = zero
        if do_ppl and tp.path_regularize != 0:
            with trace.span("spgan.train.ppl"):
                grads, metrics["path"], mean_path, metrics["path_lengths"] = \
                    self.ppl_grads(params_g, dr, mean_path)
            self._reduce(grads)
            with trace.span("spgan.train.update"), torch.no_grad():
                params_g, opt_g = self.opt_g.step(
                    params_g, tree_unflatten(params_g, grads), opt_g,
                    **upd_g)
        if self.multi:
            # the loss metrics of each rank's rows, averaged (the grad
            # norms are of the reduced gradients already)
            keys = [k for k in metrics if not k.startswith("grad_norm")]
            vals = torch.stack([metrics[k].float() for k in keys])
            with trace.span("spgan.train.all_reduce"):
                all_reduce_mean_([vals], self.mesh)
            metrics.update(zip(keys, vals.unbind()))
        metrics["mean_path_length"] = mean_path

        with trace.span("spgan.train.ema"), torch.no_grad():
            params_g_ema = ema_update(state.params_g_ema, params_g)
        return TrainState(step=state.step + 1, params_g=params_g,
                          params_d=params_d, params_g_ema=params_g_ema,
                          opt_g=opt_g, opt_d=opt_d,
                          mean_path_length=mean_path), metrics

    def path_lengths(self, params_g, dr: StepDraws) -> torch.Tensor:
        """(pbsz,) path lengths of the PPL phase (the graph kept): the
        texture synthesizer's w.r.t. the styles, with the structure latent
        computed outside the differentiated map."""
        g = self.g
        gl, ll, coords, _, cp = self.g_inputs(dr.ppl)
        tables = g.ss.train_tables(cp, ll.shape[1])
        structure = g.ss.apply(params_g["ss"], gl[:, 0], ll, coords, None,
                               tables, tables_mode="sample")
        styles = g.build_styles(params_g, gl, dr.ppl.inject)
        skip_tables = [tables_to(sphere_offset_tables_batch(cp, s, s),
                                 ll.device) for s in g.ts.skip_sizes()]

        def synth(st):
            return g.ts.synthesize(params_g["ts"], structure, st,
                                   dr.ppl.noises, skip_tables,
                                   self.skip_margins)

        p = dr.ppl_noise
        return losses.ppl_lengths(
            synth, styles, noise=p / math.sqrt(p.shape[1] * p.shape[2]))

    def ppl_penalty(self, params_g, dr: StepDraws, mean_path: torch.Tensor):
        """(penalty, new running mean, mean path length) of the PPL
        phase."""
        lengths = self.path_lengths(params_g, dr)
        batch_mean = (all_reduce_mean(lengths.mean(), self.mesh)
                      if self.multi else None)
        penalty, new_mean = losses.g_path_regularize(lengths, mean_path,
                                                     batch_mean=batch_mean)
        return penalty, new_mean, lengths.mean()


def make_train_step(cfg: Config, g: Generator, d: Discriminator,
                    draw: Optional[Callable[..., StepDraws]] = None,
                    freeze_g_mask: Optional[Any] = None,
                    mesh: Optional[Mesh] = None) -> TrainStep:
    return TrainStep(cfg, g, d, draw=draw, freeze_g_mask=freeze_g_mask,
                     mesh=mesh)
