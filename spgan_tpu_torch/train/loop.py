"""Training loop (counterpart of spgan_tpu/train/loop.py).

  * lazy R1 every d_reg_every, lazy PPL every g_reg_every from
    g_path_start on, on absolute iterations;
  * steps_per_call K: K batches and K steps a loop call (the ticks fire
    when the K iterations of a call cross their multiple, crossed_tick);
  * scalars every log_tick (stdout; tensorboard when tensorboardX
    imports), image grids of the EMA generator every img_tick (tensorboard
    only; with no_ext false also the extrapolated grids of 2x and 4x
    wider latents), rolling checkpoints every save_tick, auto-resume from
    the newest;
  * FID every eval_tick and EXT2-FID every fid_ext2_tick with
    test_params.calc_fid (and calc_fid_ext2), when $SPGAN_TPU_INCEPTION
    names the inception weights (or is "random"; without it FID is off
    with a warning, as in the JAX package): scalars metric/fid and
    metric/fid_ext2, snapshots best_fid.pt, best_fid_ext2.pt and, past
    iteration 600,000, best_fid_ext2_<it>.pt beside the checkpoints, the
    best values in ckpt/best.json (read back on resume);
  * baseline transfer: an InfinityGAN baseline checkpoint's generator
    weights are loaded before the first step (compat/baseline.py); with
    train_params.freeze they and the whole discriminator stay fixed;
  * --debug: one full iteration, nothing written to disk;
  * an exception is appended to <log_dir>/<exp_name>/error-log.txt and
    re-raised.

Iteration i's step draws from a generator seeded with (seed, i) only, so
a resumed run's steps draw as an uninterrupted run's would (the JAX
package folds the step into its key).  The data pipeline, however, is
rebuilt from `seed` on resume and reads the data order from its start
again, as in the JAX package: a resumed run sees other batches than an
uninterrupted one.  The FID ticks draw from streams of their own, (seed
+ 2, i) and (seed + 3, i); the plain FID's real images come from the
training pipeline (its first call takes n_fid_sample / batch_size
batches of the stream, as in the JAX package), EXT2's from a second
pipeline seeded seed + 7 with the full images.

Data-parallel (a mesh of N ranks, one process each; the JAX loop's batch
sharding over its mesh): the state is initialised, transferred and
resumed as above, then broadcast from rank 0; every rank builds the same
global batch from the same seeded pipeline and steps on its block of rows
(with steps_per_call, each of the call's batches: JAX's dim-1 sharding of
the stacked batches), so N ranks train on what one process trains on.
Only rank 0 writes (checkpoints, logs, grids, the FID ticks and
best.json) and only it profiles; the other ranks skip the training
batches a FID tick drew and wait at a barrier after each writing tick.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from spgan_tpu_torch.config import COMPUTE_DTYPES, Config
from spgan_tpu_torch.data.pipeline import make_train_pipeline
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.models.latents import LatentSampler
from spgan_tpu_torch.parallel.mesh import (Mesh, barrier, broadcast_int,
                                           make_mesh, replicate, shard_batch)
from spgan_tpu_torch.train.checkpoint import CheckpointManager, save_best
from spgan_tpu_torch.train.state import TrainState, create_train_state
from spgan_tpu_torch.train.step import make_train_step, refuse_baseline
from spgan_tpu_torch.tree import tree_leaves, tree_map
from spgan_tpu_torch.utils import trace
from spgan_tpu_torch.utils.misc import backup_files, import_func

# tensorboard event files are closed and reopened every this many
# iterations (reference train.py:35), so a long run's logs sync in chunks
TB_PARTITION_STEPS = 100_000


def crossed_tick(it: int, adv: int, n: int) -> bool:
    """Whether the span (it - adv, it] of iterations holds a multiple of
    n."""
    return (it // n) > ((it - adv) // n)


def ext_mult_list(cfg: Config) -> List[int]:
    """Latent widening factors of the extrapolated image grids: none above
    patch 512, [2] above 256, none with no_ext, else [2, 4]."""
    tp = cfg.train_params
    if tp.patch_size > 512:
        return []
    if tp.patch_size > 256:
        return [2]
    return [] if tp.no_ext else [2, 4]


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of iteration `it`'s draws: a function of (seed, it)
    only."""
    s = np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def _to_grid(imgs: np.ndarray, ncol: int = 8) -> np.ndarray:
    """(B,H,W,3) in [-1,1] -> one (H*rows, W*ncol, 3) uint8 grid."""
    b, h, w, c = imgs.shape
    ncol = min(ncol, b)
    nrow = (b + ncol - 1) // ncol
    canvas = np.zeros((nrow * h, ncol * w, c), np.float32)
    for i in range(b):
        r, cidx = divmod(i, ncol)
        canvas[r * h:(r + 1) * h, cidx * w:(cidx + 1) * w] = imgs[i]
    canvas = np.clip((canvas + 1) / 2, 0, 1)
    return (canvas * 255).astype(np.uint8)


def make_image_grids(cfg: Config, g: Generator, seed: int, device
                     ) -> Callable[[dict, int], Dict[str, np.ndarray]]:
    """grids(params_ema, it) -> {"samples/ema", "samples/ema_ext<m>" for m
    in ext_mult_list, "samples/style_diversity",
    "samples/structure_diversity"}: uint8 grids of the EMA generator on
    random training crops (reference train.py:463-622).  "ema" renders
    min(n_save_sample, 16) fixed latents; "ema_ext<m>" the same global
    latents over fixed local latents m times wider, on extrapolated
    coordinate grids; style diversity one fixed local latent under min(n,
    8) fresh global ones; structure diversity one fixed global latent
    under fresh local ones.  The crops, noises and fresh latents of
    iteration `it` come from (seed + 1, it)."""
    tp = cfg.train_params
    dev = resolve(device)
    cdt = COMPUTE_DTYPES[tp.compute_dtype]
    sampler = LatentSampler(global_dim=tp.global_latent_dim,
                            local_dim=tp.local_latent_dim,
                            ts_input_size=tp.ts_input_size,
                            ss_unfold_size=tp.ss_unfold_size,
                            mixing=tp.mixing)
    margins = g.training_skip_margins()
    n_vis = min(cfg.log_params.n_save_sample, 16)
    n_div = min(n_vis, 8)

    def unmixed(gen, n):
        z = torch.randn((n, tp.global_latent_dim), generator=gen, device=dev)
        return torch.stack([z, z], dim=1)

    fixed = torch.Generator(device=dev).manual_seed(seed + 1)
    vis_gl, vis_ll = unmixed(fixed, n_vis), sampler.sample_local(fixed, n_vis)
    vis_ext = {m: sampler.sample_local(fixed, n_vis, spatial_size_enlarge=m)
               for m in ext_mult_list(cfg)}

    def forward(params, gl, ll, gen):
        """One grid's images: on training crops through the training
        step's sample-mode convs; a local latent wider than the training
        one on extrapolated crops, through the convs on the patch grids
        (as in the JAX package: the row-offset tables do not describe
        those windows)."""
        n, size = gl.shape[0], ll.shape[1]
        grid = g.ss.coord_grid
        if size == grid.ss_spatial_size:
            coords, _, cp = grid.sample_training(gen, n)
            mode, skip_margins = "sample", margins
        else:
            coords, _, cp = grid.sample_training_extrap(gen, n, size)
            mode, skip_margins = "grid", None
        in_ts = g.ss.noise_sizes(size)[-1]
        noises = [torch.randn((n, s, s, 1), generator=gen,
                              device=dev).to(cdt)
                  for s in g.ts.noise_sizes(in_ts)]
        ss_noises = None if g.ss.disable_noise else [
            torch.randn((n, s, s, 1), generator=gen, device=dev).to(cdt)
            for s in g.ss.noise_sizes(size)]
        out = g.apply(params, global_latent=gl.to(cdt),
                      local_latent=ll.to(cdt), coords=coords, cp=cp,
                      noises=noises, ss_noises=ss_noises,
                      ss_tables_mode=mode,
                      ts_skip_margins=skip_margins)["gen"]
        return out.float().cpu().numpy()

    @torch.no_grad()
    def grids(params_ema: dict, it: int) -> Dict[str, np.ndarray]:
        gen = iteration_generator(seed + 1, it, dev)
        jobs = [("samples/ema", 8, lambda: forward(params_ema, vis_gl,
                                                    vis_ll, gen))]
        jobs += [(f"samples/ema_ext{m}", max(1, 8 // m),
                  lambda ll=ll: forward(params_ema, vis_gl, ll, gen))
                 for m, ll in vis_ext.items()]
        jobs += [
            ("samples/style_diversity", 8, lambda: forward(
                params_ema, unmixed(gen, n_div),
                vis_ll[:1].repeat(n_div, 1, 1, 1), gen)),
            ("samples/structure_diversity", 8, lambda: forward(
                params_ema, vis_gl[:1].repeat(n_div, 1, 1),
                sampler.sample_local(gen, n_div), gen))]
        return {tag: _to_grid(run(), ncol) for tag, ncol, run in jobs}

    return grids


def _open_writer(exp_root: str):
    """A tensorboardX SummaryWriter, or None when tensorboardX does not
    import (it is optional, as in the JAX package)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(exp_root, "tb"))


def _log_tick(writer, it: int, total: int, scalars: dict, dt: float,
              state: TrainState, dev: torch.device) -> None:
    vals = {k: float(v) for k, v in scalars.items()}
    print(f"[train] iter {it}/{total} ({dt * 1e3:.1f} ms/iter on {dev}): "
          f"{ {k: round(v, 4) for k, v in vals.items()} }", flush=True)
    if writer is None:
        return
    for k, v in vals.items():
        writer.add_scalar(f"losses/{k}", v, it)
    writer.add_scalar("utils/iters_per_sec", 1.0 / max(dt, 1e-9), it)
    # one representative weight per module (reference train.py:454-458)
    pg = state.params_g
    for name, w in (("ts_conv0_w", pg["ts"]["convs"][0]["conv"]["weight"]),
                    ("ss_sphere0_w",
                     pg["ss"]["blocks"][0]["sphere"]["conv"]["weight"])):
        writer.add_histogram(f"params/{name}",
                             w.detach().float().cpu().numpy().ravel(), it)
    if dev.type == "cuda":
        writer.add_scalar("memory/bytes_in_use",
                          torch.cuda.memory_allocated(dev) / 2 ** 20, it)
        writer.add_scalar("memory/peak_bytes_in_use",
                          torch.cuda.max_memory_allocated(dev) / 2 ** 20, it)


def _log_metric(writer, tag: str, value: float, it: int,
                ms: Dict[str, float]) -> None:
    print(f"[train] iter {it}: {tag} {value:.6g} (ms: "
          f"{ {k: round(v, 1) for k, v in ms.items()} })", flush=True)
    if writer is not None:
        writer.add_scalar(tag, value, it)


def load_baseline(cfg: Config, g: Generator, state: TrainState,
                  path: str):
    """(state with the baseline's generator weights in params_g and
    params_g_ema, freeze mask or None) from an InfinityGAN baseline
    checkpoint: its g_ema (or g) entry, or a bare state dict.  The mask
    (True on the loaded leaves) is returned with train_params.freeze."""
    from spgan_tpu_torch.compat.baseline import import_torch_baseline_generator

    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("g_ema", raw.get("g", raw))
    params_g, mask = import_torch_baseline_generator(sd, g, state.params_g)
    state.params_g = params_g
    state.params_g_ema = tree_map(torch.clone, params_g)
    freeze = cfg.train_params.freeze
    print(f" [*] Baseline transfer: {sum(tree_leaves(mask))} tensors "
          f"loaded{' (frozen)' if freeze else ''}")
    return state, (mask if freeze else None)


BEST_KEYS = ("best_fid", "best_ext2_fid", "best_ext2_fid_later")


def read_best(path: str) -> Dict[str, float]:
    """The best FID values of ckpt/best.json, inf where absent; a missing
    or truncated file (a kill mid-write) reads as none."""
    best = dict.fromkeys(BEST_KEYS, float("inf"))
    try:
        with open(path) as f:
            saved = json.load(f)
    except (OSError, json.JSONDecodeError):
        saved = {}
    best.update({k: float(saved[k]) for k in BEST_KEYS if k in saved})
    return best


def write_best(path: str, best: Dict[str, float]) -> None:
    """best.json written to a temporary file and renamed into place."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(best, f)
    os.replace(tmp, path)


def make_fid_evals(cfg: Config, g: Generator, pipeline, seed: int, device):
    """(TrainFID on the training pipeline, TrainFID ext2 on a second
    pipeline of full images seeded seed + 7, or None) with
    test_params.calc_fid (ext2 with calc_fid_ext2), or (None, None) when
    calc_fid is off or there are no inception weights (said loudly)."""
    tp = cfg.test_params
    if not tp.calc_fid:
        return None, None
    from spgan_tpu_torch.train.evals import TrainFID

    fid = TrainFID(cfg, g, pipeline, device=device)
    if not fid.available:
        print(" [!] Inception weights not found (SPGAN_TPU_INCEPTION); "
              "FID evaluation disabled.")
        return None, None
    if not tp.calc_fid_ext2:
        return fid, None
    return fid, TrainFID(cfg, g, make_train_pipeline(cfg, seed=seed + 7,
                                                     include_full=True),
                         inception_params=fid.inception_params, ext2=True,
                         device=device)


def train(cfg: Config, debug: bool = False, seed: int = 0,
          max_iters: Optional[int] = None, device=None,
          baseline_ckpt: Optional[str] = None,
          profile_dir: Optional[str] = None, profile_start: int = 3,
          profile_iters: int = 5, mesh: Optional[Mesh] = None
          ) -> TrainState:
    """Train for min(iter, max_iters) iterations (resuming from the newest
    checkpoint under <log_dir>/<exp_name>/ckpt) on `device` (default
    cuda); returns the final state.  baseline_ckpt: transfer from an
    InfinityGAN baseline checkpoint (load_baseline) before resuming.
    profile_dir: a torch.profiler Chrome trace of iterations
    [profile_start, profile_start + profile_iters), counted from the
    loop's start, is written there with the training step's spans
    (utils/trace.py: spgan.train.*) in its host timeline (with
    steps_per_call K the window opens and closes at the first call
    boundary at or past its ends).

    With compute_dtype float32, TF32 is turned off for cuDNN convolutions
    and cuBLAS matmuls (PyTorch enables it for cuDNN by default), so the
    step computes in float32 as the reference's float32 config does.
    mesh: the data-parallel world (default: the initialised process
    group's, else a world of one); device is this rank's."""
    refuse_baseline(cfg)
    tp, lp = cfg.train_params, cfg.log_params
    if tp.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve(device)
    mesh = mesh if mesh is not None else make_mesh(dev)
    multi = mesh.world_size > 1
    exp_root = os.path.join(cfg.log_dir, cfg.exp_name)

    writer = ckpt_mgr = None
    if not debug and mesh.is_root:
        os.makedirs(exp_root, exist_ok=True)
        writer = _open_writer(exp_root)
        ckpt_mgr = CheckpointManager(os.path.join(exp_root, "ckpt"))
        backup_files(os.getcwd(), os.path.join(exp_root, "codes"))

    g = import_func(tp.g_arch).from_config(cfg)
    d = import_func(tp.d_arch).from_config(cfg)
    state = create_train_state(cfg, g, d,
                               torch.Generator().manual_seed(seed),
                               device=dev)
    freeze_g_mask = None
    if baseline_ckpt is not None:
        state, freeze_g_mask = load_baseline(cfg, g, state, baseline_ckpt)
    start_iter = 0
    if ckpt_mgr is not None and ckpt_mgr.latest_step() is not None:
        state = ckpt_mgr.restore(state)
        start_iter = state.step
        print(f" [*] Resumed from iter {start_iter}")
    if multi:  # rank 0's state, initialised, transferred or resumed
        state = replicate(state, mesh)
        state.step = start_iter = broadcast_int(start_iter, mesh)
    k_steps = max(1, tp.steps_per_call)
    step_fn = make_train_step(cfg, g, d, freeze_g_mask=freeze_g_mask,
                              mesh=mesh)
    grids = (make_image_grids(cfg, g, seed, dev) if writer is not None
             else None)
    pipeline = make_train_pipeline(cfg, seed=seed)
    fid_eval = fid_ext2_eval = None
    best_path = (None if ckpt_mgr is None
                 else os.path.join(ckpt_mgr.ckpt_dir, "best.json"))
    best = None if ckpt_mgr is None else read_best(best_path)

    def snapshot(name, key, value):
        """A better FID: the snapshot `name` and best.json."""
        best[key] = value
        save_best(ckpt_mgr.ckpt_dir, name, state)
        write_best(best_path, best)

    total = tp.iter if max_iters is None else min(tp.iter, max_iters)
    reg_carry: Dict[str, torch.Tensor] = {}
    prof = prof_start = None
    it = start_iter
    t_last, it_last = time.perf_counter(), it

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def on_dev(batch, key):
        """This rank's rows of the global batch, on the device."""
        return shard_batch(torch.as_tensor(batch[key]), mesh).to(dev)

    try:
        if not debug and mesh.is_root:
            fid_eval, fid_ext2_eval = make_fid_evals(cfg, g, pipeline, seed,
                                                     dev)
        # which ticks run, known on every rank (rank 0 runs them)
        fid_on = broadcast_int(fid_eval is not None, mesh)
        ext2_on = broadcast_int(fid_ext2_eval is not None, mesh)
        while it < total:
            if (profile_dir is not None and mesh.is_root and prof is None
                    and prof_start is None
                    and it - start_iter >= profile_start):
                from torch.profiler import ProfilerActivity, profile

                sync()
                acts = [ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
                trace.enable()
                prof_start = it
            k = min(k_steps, total - it)
            for j in range(k):
                batch = next(pipeline)
                do_r1 = (it + j) % tp.d_reg_every == 0
                do_ppl = ((it + j) % tp.g_reg_every == 0
                          and it + j >= tp.g_path_start)
                state, metrics = step_fn(
                    state, on_dev(batch, "patch"), on_dev(batch, "ac_coords"),
                    iteration_generator(seed, it + j, dev), do_r1=do_r1,
                    do_ppl=do_ppl)
                if do_r1:
                    reg_carry["r1"] = metrics["r1"]
                if do_ppl:
                    reg_carry["path"] = metrics["path"]
                    reg_carry["path_lengths"] = metrics["path_lengths"]
            it += k
            if prof is not None and it - prof_start >= profile_iters:
                sync()
                trace.disable()
                prof.__exit__(None, None, None)
                done, prof = prof, None
                os.makedirs(profile_dir, exist_ok=True)
                path = os.path.join(profile_dir, "train_trace.json")
                done.export_chrome_trace(path)
                print(f" [*] Profiler trace of iterations [{prof_start}, "
                      f"{it}) written to {path}")

            if debug:
                if mesh.is_root:
                    print(" [debug] one iteration OK —",
                          {k: round(float(v), 4)
                           for k, v in metrics.items()}, flush=True)
                break

            def tick(n):
                return crossed_tick(it, k, n)

            def sync_ticks():
                """After rank 0's ticks: the other ranks skip the training
                batches its FID tick drew, and every rank meets at a
                barrier after a writing tick."""
                if fid_on and tick(lp.eval_tick):
                    drawn = broadcast_int(fid_eval.drawn if mesh.is_root
                                          else 0, mesh)
                    for _ in range(0 if mesh.is_root else drawn):
                        next(pipeline)
                if (tick(lp.img_tick) or tick(lp.save_tick)
                        or (ext2_on and tick(lp.fid_ext2_tick))):
                    barrier(mesh)

            if not mesh.is_root:
                sync_ticks()
                continue
            if tick(lp.log_tick):
                now = time.perf_counter()
                _log_tick(writer, it, total, {**metrics, **reg_carry},
                          (now - t_last) / (it - it_last), state, dev)
                t_last, it_last = now, it
            if tick(lp.img_tick) and writer is not None:
                for tag, grid in grids(state.params_g_ema, it).items():
                    writer.add_image(tag, grid, it, dataformats="HWC")
            if tick(lp.save_tick) and ckpt_mgr is not None:
                ckpt_mgr.save(it, state)
            if fid_eval is not None and tick(lp.eval_tick):
                fid = fid_eval(state.params_g_ema,
                               iteration_generator(seed + 2, it, dev))
                _log_metric(writer, "metric/fid", fid, it, fid_eval.ms)
                if fid < best["best_fid"]:
                    snapshot("best_fid", "best_fid", fid)
            if fid_ext2_eval is not None and tick(lp.fid_ext2_tick):
                fid2 = fid_ext2_eval(state.params_g_ema,
                                     iteration_generator(seed + 3, it, dev))
                _log_metric(writer, "metric/fid_ext2", fid2, it,
                            fid_ext2_eval.ms)
                if fid2 < best["best_ext2_fid"]:
                    snapshot("best_fid_ext2", "best_ext2_fid", fid2)
                # the late-training per-iteration snapshot (reference
                # train.py:690-717)
                if it > 600_000 and fid2 < best["best_ext2_fid_later"]:
                    snapshot(f"best_fid_ext2_{it}", "best_ext2_fid_later",
                             fid2)
            if (writer is not None and it > start_iter
                    and tick(TB_PARTITION_STEPS)):
                writer.close()
                writer = _open_writer(exp_root)
            if multi:
                sync_ticks()
    except Exception:
        if not debug and mesh.is_root:
            os.makedirs(exp_root, exist_ok=True)
            with open(os.path.join(exp_root, "error-log.txt"), "a") as f:
                f.write(traceback.format_exc() + "\n")
        raise
    finally:
        if prof is not None:  # the loop left inside the window
            trace.disable()
            prof.__exit__(None, None, None)
            print(f" [!] Profiler window cut at iteration {it}; no trace "
                  "written")
        elif profile_dir is not None and prof_start is None and mesh.is_root:
            print(f" [!] Profiler window never opened: the loop ended at "
                  f"iteration {it}, before profile_start={profile_start} "
                  f"(counted from iteration {start_iter}); no trace written")
        pipeline.close()
        if fid_ext2_eval is not None:
            fid_ext2_eval.pipeline.close()
        if writer is not None:
            writer.close()
    return state
