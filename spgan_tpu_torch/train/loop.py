"""Training loop (counterpart of spgan_tpu/train/loop.py: the step
cadence).  Lazy R1 every d_reg_every iterations, lazy PPL every
g_reg_every iterations from g_path_start on.  Checkpoints, tensorboard,
image grids and FID are not ported yet.

    python -m spgan_tpu_torch.train [--debug] [--max-iters N]
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.data.pipeline import TrainPipeline
from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.train.state import TrainState, create_train_state
from spgan_tpu_torch.train.step import make_train_step


def train(cfg: Config, max_iters: Optional[int] = None, seed: int = 0,
          device=None, debug: bool = False,
          log_every: int = 100) -> TrainState:
    """Train from random weights (seed) on the synthetic source for
    min(iter, max_iters) iterations, on `device` (default cuda).  debug:
    one iteration, then print its metrics.  Returns the final state.

    With compute_dtype float32, TF32 is turned off for cuDNN convolutions
    and cuBLAS matmuls (PyTorch enables it for cuDNN by default), so the
    step computes in float32 as the reference's float32 config does."""
    tp = cfg.train_params
    if tp.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve(device)
    g = Generator.from_config(cfg)
    d = Discriminator.from_config(cfg)
    state = create_train_state(cfg, g, d, torch.Generator().manual_seed(seed),
                               device=dev)
    step = make_train_step(cfg, g, d)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pipeline = TrainPipeline(cfg, seed=seed)
    total = tp.iter if max_iters is None else min(tp.iter, max_iters)
    if debug:
        total = min(total, 1)
    t0 = time.perf_counter()
    for it in range(total):
        batch = next(pipeline)
        real_patch = torch.as_tensor(batch["patch"]).to(dev)
        real_ac = torch.as_tensor(batch["ac_coords"]).to(dev)
        do_r1 = it % tp.d_reg_every == 0
        do_ppl = it % tp.g_reg_every == 0 and it >= tp.g_path_start
        state, metrics = step(state, real_patch, real_ac, gen,
                              do_r1=do_r1, do_ppl=do_ppl)
        if debug or (it + 1) % log_every == 0 or it + 1 == total:
            vals = {k: round(float(v), 4) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / (it + 1)
            print(f"[train] iter {it + 1}/{total} ({dt * 1e3:.1f} ms/iter "
                  f"on {dev}): {vals}", flush=True)
    return state
