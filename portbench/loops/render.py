"""Offline panorama rendering, closed loop: batch after batch of
`task.batch_size` panoramas, each from new fields drawn from the seed,
through the program's timed path

    PanoramaEngine.generate -> crop_to_target -> host copy -> to_uint8

(one image is one target crop on the host as uint8, ready for the PNG
writer).  The traffic file gives the task (`task`: height, width, batch,
patch_chunk), the lattice (`lattice`: close_loop or planar, and whether
close-loop wrap columns are rendered once), the traced units and the
size of the correctness sample.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import build, flops, harness, peaks, trace
from portbench.reference import render as ref_render


def _program(ctx):
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.managers import to_uint8
    from spgan_tpu_torch.infer.stitcher import (build_close_loop_plan,
                                                build_infinite_plan)
    from spgan_tpu_torch.models import generator as gen_mod
    return (Config, PanoramaEngine, to_uint8, build_close_loop_plan,
            build_infinite_plan, gen_mod)


def prebuild_kernels() -> None:
    """Build (or find in the build cache) the program's CUDA kernels, so
    the build is a set-up phase of its own."""
    from spgan_tpu_torch.ops.kernels import sphere_kernel, sphere_sample
    for fn in (getattr(sphere_kernel, "_kernel", None),
               getattr(sphere_sample, "_lib", None)):
        if fn is not None:
            fn()


def sample_images(seed: int, n_batches: int, batch: int, n_images: int):
    """The checked sample, drawn from the seed once the window closed:
    {batch index: [panorama indices]}, the first and the last batch
    always in it."""
    rng = np.random.default_rng(build.derive(seed, 99))
    picks = {0, n_batches - 1}
    while len(picks) < min(n_batches, max(2, n_images // 2)):
        picks.add(int(rng.integers(n_batches)))
    per = max(1, n_images // len(picks))
    return {k: sorted(rng.choice(batch, size=min(per, batch),
                                 replace=False).tolist())
            for k in sorted(picks)}


def run(ctx: harness.Context) -> harness.Outcome:
    (Config, PanoramaEngine, to_uint8, close_plan, planar_plan,
     gen_mod) = _program(ctx)
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
    tr = ctx.traffic
    cfg = build.make_config(Config, ctx.config, tr["task"])
    tp = cfg.train_params
    if tp.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx.setup.mark("imports and CUDA context")
    if cuda:
        prebuild_kernels()
    ctx.setup.mark("kernel build")
    scale = ref_render.calibrate(ctx.config, ctx.seed, dev)
    ctx.setup.mark("the reference's ToRGB calibration", counted=False)
    g = build.make_generator(gen_mod, cfg, ctx.config)
    params = build.generator_params(ctx.config, ctx.seed, dev, scale)
    if cuda:
        torch.cuda.synchronize()
    ctx.setup.mark("weights")
    close_loop = tr["lattice"]["close_loop"]
    plan = (close_plan if close_loop else planar_plan)(
        g, cfg.task.height, cfg.task.width)
    engine = PanoramaEngine(
        g=g, plan=plan, batch=cfg.task.batch_size,
        patch_chunk=cfg.task.patch_chunk, grid_partial=tp.partial,
        compute_dtype=tp.compute_dtype,
        dedup_wrap=tr["lattice"]["dedup_wrap"], device=dev)
    ctx.setup.mark("engine tables")
    B = cfg.task.batch_size
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def unit(gen, spans=False):
        if not spans:
            meta = engine.generate(params, gen)
            return to_uint8(engine.crop_to_target(meta).cpu().numpy())
        with trace.span("generate"):
            meta = engine.generate(params, gen)
        with trace.span("crop_host_copy"):
            crop = engine.crop_to_target(meta).cpu().numpy()
        with trace.span("to_uint8"):
            return to_uint8(crop)

    unit(build.generator(ctx.seed, build.TAG_WARM, device=dev))
    sync()
    ctx.setup.mark("warm-up")
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = ctx.setup.total()

    outputs = []
    t0 = time.perf_counter()
    while True:
        outputs.append(unit(build.generator(ctx.seed, build.TAG_BATCH,
                                            len(outputs), device=dev)))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    n_batches = len(outputs)
    images = n_batches * B
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"images_per_s": images / window_s,
           "peak_mem_gib": window_peak / 2 ** 30,
           "setup_s": setup_s}
    harness.log(f"[window] {n_batches} batches, {images} images in "
                f"{window_s:.3f} s")

    patches = ref_render.rendered_patches(ctx.config, tr)
    records = {"untraced_images": images, "untraced_s": window_s,
               "images_per_unit": B,
               "flops_per_image": flops.image_flops(ctx.config, patches),
               "peak_flops": peaks.PEAK_FLOPS[tp.compute_dtype],
               "power_limit_w": peaks.power_limit_w() if cuda else None}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)
              if cuda else 0}
    breakdown = None
    if ctx.trace:
        n = tr["traced_units"]

        def traced():
            for i in range(n):
                unit(build.generator(ctx.seed, build.TAG_WARM, 1 + i,
                                     device=dev), spans=True)

        breakdown = trace.profile(traced, records, sync)
        records["traced_images"] = n * B
        device["busy_s"] = records["busy_s"]
        device["window_s"] = records["wall_s"]
        if cuda:
            device["memory_peak_bytes"] = max(
                device["memory_peak_bytes"], torch.cuda.max_memory_allocated())
        harness.log(f"[trace] {n} batches: wall {records['wall_s']:.4f} s, "
                    f"device busy {records['busy_s']:.4f} s, "
                    f"{records['n_kernels']} device operations; power limit "
                    f"{records['power_limit_w']} W")

    # the program's state goes before the reference runs
    sample = sample_images(ctx.seed, n_batches, B, tr["check_images"])
    got = {k: outputs[k][bs] for k, bs in sample.items()}
    del outputs, engine, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = ref_render.render_sample(ctx.config, tr, ctx.seed, scale, sample,
                                   dev)
    harness.log(f"[reference] {sum(len(v) for v in sample.values())} images "
                f"in {time.perf_counter() - t_ref:.3f} s")
    checks = ref_render.checks(got, want, ctx.limits)
    return harness.Outcome(end_to_end=e2e, records=records,
                           attempted=images, failed=0, checks=checks,
                           device=device, breakdown=breakdown)
