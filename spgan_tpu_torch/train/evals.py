"""FID during training (counterpart of spgan_tpu/train/evals.py; the
reference's train.py:641-668, and its EXT2 variant :676-719: FID of
generations on 2x-wider local latents, centre-cropped to full_size,
against the full training images)."""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.evalkit.fid import (FIDEvaluator, compute_stats,
                                         frechet_distance)
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.models.latents import LatentSampler
from spgan_tpu_torch.ops.spatial import out_size_chain

INCEPTION_ENV = "SPGAN_TPU_INCEPTION"


def _inception_params(device=None):
    """The inception network of $SPGAN_TPU_INCEPTION: a pytorch-fid
    checkpoint's weights, or None (FID off) when the variable is unset or
    names no file.  "random" is the explicit plumbing-only escape: seeded
    random weights, so the whole FID tick runs without the checkpoint,
    with a loud warning that its values mean nothing."""
    from spgan_tpu_torch.evalkit.inception import (load_torch_inception,
                                                   random_inception)

    path = os.environ.get(INCEPTION_ENV)
    if not path:
        return None
    if path == "random":
        print(" [!] SPGAN_TPU_INCEPTION=random: FID plumbing runs with "
              "RANDOM inception weights — values are meaningless.")
        return random_inception(device=device)
    if not os.path.exists(path):
        return None
    return load_torch_inception(path, device=device)


class TrainFID:
    """FID of the EMA generator's patches against the training set (the
    reference's is_fid_eval: training crops, no dual latents), on `device`
    (default cuda).  The generator runs on the float32 EMA weights with
    float32 inputs, as the JAX package's does whatever compute_dtype
    trains (under the caller's TF32 flags: the loop turns TF32 off for
    float32 training); inception runs in float32 with TF32 off.

    ext2: the EXT2-FID variant, generations on local latents twice as wide
    on extrapolated windows (the SS and skip convs on the patch grids, as
    the image grids' extrapolated forwards), centre-cropped to full_size,
    against the pipeline's full images.  The real images are
    next(pipeline)["patch"] (["full"] for ext2); their statistics are
    cached under .fid-cache/<dataset>-<size>[-ext2]_spgan_tpu.pkl, so
    only the first call draws from the pipeline.  After a call, .ms holds
    the ms of its parts on the host clock: real_stats (cached or drawn
    and featurised), generate, features (the fakes'), frechet (their
    statistics and the distance)."""

    def __init__(self, cfg: Config, g: Generator, pipeline,
                 inception_params=None, ext2: bool = False, device=None):
        self.cfg, self.g, self.pipeline, self.ext2 = cfg, g, pipeline, ext2
        self.dev = resolve(device)
        self.inception_params = (inception_params
                                 if inception_params is not None
                                 else _inception_params(self.dev))
        tp = cfg.train_params
        self.sampler = LatentSampler(
            global_dim=tp.global_latent_dim, local_dim=tp.local_latent_dim,
            ts_input_size=tp.ts_input_size, ss_unfold_size=tp.ss_unfold_size,
            mixing=tp.mixing)
        self.enlarge = 2 if ext2 else 1
        self.margins = None if ext2 else g.training_skip_margins()
        self.ms: Dict[str, float] = {}

    @property
    def available(self) -> bool:
        return self.inception_params is not None

    def draw(self, gen: torch.Generator, n: int) -> dict:
        """The random inputs of one batch of n generations, from `gen`:
        global and local latents, the crops and the noise maps."""
        g = self.g
        gl = self.sampler.sample_global(gen, n)
        ll = self.sampler.sample_local(gen, n,
                                       spatial_size_enlarge=self.enlarge)
        size = ll.shape[1]
        grid = g.ss.coord_grid
        if self.ext2:
            coords, _, cp = grid.sample_training_extrap(gen, n, size)
        else:
            coords, _, cp = grid.sample_training(gen, n)
        dev = gen.device
        noises = [torch.randn((n, s, s, 1), generator=gen, device=dev)
                  for s in out_size_chain(g.ts.conv_specs_spatial(),
                                          g.ss.noise_sizes(size)[-1])]
        ss_noises = None if g.ss.disable_noise else [
            torch.randn((n, s, s, 1), generator=gen, device=dev)
            for s in g.ss.noise_sizes(size)]
        return dict(global_latent=gl, local_latent=ll, coords=coords, cp=cp,
                    noises=noises, ss_noises=ss_noises)

    @torch.no_grad()
    def forward(self, params_ema: dict, fields: dict) -> torch.Tensor:
        """(B, H, W, 3) float32 images of `fields` (draw's dict) from the
        float32 EMA weights: training crops on the sample-mode convs, the
        ext2 windows on the patch grids, centre-cropped to full_size."""
        mode = "grid" if self.ext2 else "sample"
        img = self.g.apply(params_ema, ss_tables_mode=mode,
                           ts_skip_margins=self.margins, **fields)["gen"]
        full = self.cfg.train_params.full_size
        if self.ext2 and img.shape[1] > full:
            p = (img.shape[1] - full) // 2
            img = img[:, p:p + full, p:p + full]
        return img.float()

    def __call__(self, params_ema: dict, gen: torch.Generator,
                 n_sample: Optional[int] = None) -> float:
        """FID over n_sample (default test_params.n_fid_sample) generations
        drawn from `gen`, in batches of batch_size."""
        if not self.available:
            raise RuntimeError(f"no inception weights (set {INCEPTION_ENV})")
        tp = self.cfg.train_params
        n = n_sample or self.cfg.test_params.n_fid_sample
        n_batches = max(1, n // tp.batch_size)
        ev = FIDEvaluator(self.inception_params, device=self.dev)
        modality = "full" if self.ext2 else "patch"

        def real_batches():
            for _ in range(n_batches):
                yield next(self.pipeline)[modality]

        size_key = tp.full_size if self.ext2 else tp.patch_size
        key = (f"{self.cfg.data_params.dataset}-{size_key}"
               f"{'-ext2' if self.ext2 else ''}_spgan_tpu")
        ms = self.ms = {"real_stats": 0.0, "generate": 0.0, "features": 0.0,
                        "frechet": 0.0}
        t0 = time.perf_counter()
        real = ev.real_stats(key, real_batches)
        t1 = time.perf_counter()
        ms["real_stats"] = (t1 - t0) * 1e3
        feats = []
        for _ in range(n_batches):
            img = self.forward(params_ema, self.draw(gen, tp.batch_size))
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            t2 = time.perf_counter()
            feats.append(ev.features(img))
            t3 = time.perf_counter()
            ms["generate"] += (t2 - t1) * 1e3
            ms["features"] += (t3 - t2) * 1e3
            t1 = t3
        fid = frechet_distance(real, compute_stats(feats))
        ms["frechet"] = (time.perf_counter() - t1) * 1e3
        return fid
