"""Training, from a resumed iteration: the program's training step
(`make_train_step` -> `TrainStep.__call__`) driven iteration after
iteration on real patches made on the device from the seed, with the
training loop's schedule on absolute iterations (R1 every d_reg_every,
PPL every g_reg_every from g_path_start on) and its per-iteration
generator of draws.

Set-up builds one training state and one step, runs the first three
iterations from `start_iteration` (the reference follows them), then the
rest of that cycle as warm-up.  The window is whole cycles of
d_reg_every iterations, from a cycle boundary to the first boundary at or
after `--seconds`, so the ratio of regularised iterations is exact.
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import build, flops, harness, peaks, trace
from portbench.loops.render import prebuild_kernels
from portbench.reference import render as ref_render
from portbench.reference import train as ref_train


def run(ctx: harness.Context) -> harness.Outcome:
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.models import discriminator as d_mod
    from spgan_tpu_torch.models import generator as gen_mod
    from spgan_tpu_torch.train.loop import iteration_generator
    from spgan_tpu_torch.train.state import TrainState, make_optimizers
    from spgan_tpu_torch.train.step import make_train_step

    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tr = ctx.traffic
    cfg = build.make_config(Config, ctx.config, {})
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
    d = d_mod.Discriminator.from_config(cfg)
    params_g = build.generator_params(ctx.config, ctx.seed, dev, scale)
    params_d = build.discriminator_params(ctx.config, ctx.seed, dev)
    opt_g, opt_d = make_optimizers(cfg)
    start = tr["start_iteration"]
    state = TrainState(
        step=start, params_g=params_g, params_d=params_d,
        params_g_ema=build.clone_tree(params_g),
        opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
        mean_path_length=torch.zeros((), device=dev))
    del params_g, params_d
    step = make_train_step(cfg, g, d)
    sync()
    ctx.setup.mark("weights and training state")
    B, n = tp.batch_size, tp.d_reg_every

    def iterate(state, it):
        real, ac = build.real_batch(ctx.seed, it, B, cfg, dev)
        return step(state, real, ac, iteration_generator(ctx.seed, it, dev),
                    *ref_train.schedule(cfg, it))

    # the first three iterations, which the reference follows
    states, metrics = [state], []
    for it in range(start, start + 3):
        state, m = iterate(state, it)
        states.append(state)
        metrics.append(m)
    got = ref_train.summarize(states, metrics)
    del states, metrics
    ctx.setup.mark("first three iterations")
    it = start + 3
    while it % n:
        state, _ = iterate(state, it)
        it += 1
    sync()
    ctx.setup.mark("warm-up (the rest of the first cycle)")
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = ctx.setup.total()

    cycles = 0
    t0 = time.perf_counter()
    while True:
        for _ in range(n):
            state, _ = iterate(state, it)
            it += 1
        cycles += 1
        sync()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    iters = cycles * n
    e2e = {"train_iter_ms": 1e3 * window_s / iters,
           "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s}
    harness.log(f"[window] {cycles} cycles, {iters} iterations in "
                f"{window_s:.3f} s")
    records = {"untraced_cycles": cycles, "untraced_s": window_s,
               "flops_per_cycle": flops.train_cycle_flops(ctx.config)["total"],
               "peak_flops": peaks.PEAK_FLOPS[tp.compute_dtype],
               "power_limit_w": peaks.power_limit_w() if cuda else None}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)
              if cuda else 0}
    breakdown = None
    if ctx.trace:
        reg = []
        for _ in range(n):
            r1, ppl = ref_train.schedule(cfg, it)
            t = time.perf_counter()
            state, _ = iterate(state, it)
            sync()
            if r1 or ppl:
                reg.append(time.perf_counter() - t)
            it += 1
        records["reg_iter_s"] = reg
        box = [state, it]

        def traced():
            for _ in range(n * tr["traced_cycles"]):
                with trace.span("train_step"):
                    box[0], _ = iterate(box[0], box[1])
                box[1] += 1

        breakdown = trace.profile(traced, records, sync)
        state = box[0]
        records["traced_cycles"] = tr["traced_cycles"]
        device["busy_s"] = records["busy_s"]
        device["window_s"] = records["wall_s"]
        if cuda:
            device["memory_peak_bytes"] = max(
                device["memory_peak_bytes"], torch.cuda.max_memory_allocated())
        harness.log(f"[trace] {tr['traced_cycles']} cycle(s): wall "
                    f"{records['wall_s']:.4f} s, device busy "
                    f"{records['busy_s']:.4f} s, {records['n_kernels']} "
                    f"device operations; regularised iterations "
                    f"{[round(x, 4) for x in reg]} s; power limit "
                    f"{records['power_limit_w']} W")

    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = ref_train.first_steps(ctx.config, tr, ctx.seed, scale, dev)
    harness.log(f"[reference] three iterations in "
                f"{time.perf_counter() - t_ref:.3f} s")
    harness.log("[reference] not compared: " + " ".join(
        f"{k}={v:.3e}" for k, v in ref_train.detail(got, want).items()))
    checks = ref_train.checks(got, want, ctx.limits)
    return harness.Outcome(end_to_end=e2e, records=records,
                           attempted=iters, failed=0, checks=checks,
                           device=device, breakdown=breakdown)
