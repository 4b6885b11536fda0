"""Whole-image rendering, closed loop: batch after batch of
`task.batch_size` images of a generator without a patch lattice
(StyleGAN3), each from a new latent drawn from the seed, through the
program's timed path

    ImageEngine.generate -> host copy -> to_uint8

(one image is one whole image on the host as uint8, ready for the PNG
writer), as loops/render.py times the panorama engine.  The program's
tracer is on over the traced stretch only, its spans joined with the
device timeline (`spans.with_spans`, as in loops/render_spans.py).

The program's StyleGAN3 modules are imported before any CUDA work, so a
program without them fails at once.

Set-up, besides the render loop's phases: the weights are the
reference's init drawn on the device from the seed
(reference.stylegan3.init), and each layer's magnitude_ema is the mean
square of its input over a calibration batch of `calibration_images`
latents rendered by the reference in float32 (a phase not counted in
setup_s, like the ToRGB calibration of the panorama cells).

`correct` compares the uint8 images of a sample (loops.render.
sample_images) with the reference's, rendered one image at a time in
float32 with TF32 off (reference.render.checks: mean_lsb,
worst_image_lsb).

Records besides the render loop's: flops_per_image (flops_sg3.py),
filtered_lrelu_bytes (the op's byte bound an image, flops_sg3.py), and
over the traced stretch spans and counters (the join).
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import build, flops_sg3, harness, peaks, spans, trace
from portbench.loops.render import sample_images
from portbench.reference import render as ref_render
from portbench.reference import stylegan3 as ref


def _program():
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.image_engine import ImageEngine
    from spgan_tpu_torch.infer.managers import to_uint8
    from spgan_tpu_torch.models import stylegan3 as sg3
    return Config, ImageEngine, to_uint8, sg3


def latents(seed: int, k: int, batch: int, z_dim: int, device):
    """Batch k's latents: (batch, z_dim) standard normal from the batch's
    generator, as the program's engine draws them."""
    gen = build.generator(seed, build.TAG_BATCH, k, device=device)
    return torch.randn((batch, z_dim), generator=gen, device=device)


def weights(cfg_json: dict, seed: int, n_cal: int, device) -> dict:
    """The reference's init from the seed (NVlabs' state-dict keys), each
    magnitude_ema calibrated on `n_cal` latents of the seed's calibration
    stream."""
    sg = cfg_json["stylegan3"]
    params = ref.init(sg, build.generator(seed, build.TAG_G, device=device),
                      device)
    z = torch.randn((n_cal, sg["z_dim"]), device=device,
                    generator=build.generator(seed, build.TAG_CAL,
                                              device=device))
    with ref_render.float32_exact():
        ref.calibrate_magnitudes(sg, params, z)
    return params


def reference_sample(cfg_json: dict, seed: int, params: dict, sample: dict,
                     batch: int, device, dtypes=(torch.float32,) * 2
                     ) -> dict:
    """{batch index: uint8 images (n, R, R, 3)} of the sampled images by
    the reference, one image at a time, float32 with TF32 off (for a
    control, `dtypes` are those of the layers NVlabs runs in float16 and
    in float32)."""
    sg = cfg_json["stylegan3"]
    out = {}
    with ref_render.float32_exact(), torch.no_grad():
        for k, idx in sample.items():
            z = latents(seed, k, batch, sg["z_dim"], device)[idx]
            img = ref.generate(sg, params, z, *dtypes).cpu().numpy()
            out[k] = ref_render.to_uint8(img)
    return out


# the controls: the reference in a lower precision than the configuration
# states, in the program's place
CONTROLS = {"bf16": (torch.bfloat16, torch.float32),
            "fp16_head": (torch.float32, torch.float16)}


def control_reading(workload: str, seed: int, control: str, device,
                    n_batches: int = 10) -> dict:
    """The checks' numbers of a control on one seed, at the cell's sample
    size: the layers NVlabs runs in float16 computed in bfloat16 ("bf16"),
    or those it runs in float32 computed in float16 ("fp16_head"),
    against the reference."""
    cell = harness.find_cell(harness.load_manifest(), workload)
    cfg_json = harness.load_data("configs", cell["config"])
    tr = harness.load_data("traffic", cell["traffic"])
    b = tr["task"]["batch_size"]
    params = weights(cfg_json, seed, tr["calibration_images"], device)
    sample = sample_images(seed, n_batches, b, tr["check_images"])
    want = reference_sample(cfg_json, seed, params, sample, b, device)
    got = reference_sample(cfg_json, seed, params, sample, b, device,
                           CONTROLS[control])
    mean, worst = ref_render.gaps(got, want)
    return {"mean_lsb": mean, "worst_image_lsb": worst}


def main(argv=None) -> int:
    """python3 -m portbench.loops.render_image --workload <cell> --control
    bf16|fp16_head --seeds <n> ...: one JSON line a seed."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python3 -m portbench.loops."
                                      "render_image")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_reading(args.workload, seed, args.control,
                            torch.device(args.device))
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "seed": seed, "seconds": time.perf_counter() - t,
                          **r}), flush=True)
    return 0


def run(ctx: harness.Context) -> harness.Outcome:
    Config, ImageEngine, to_uint8, sg3 = _program()
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
    tr = ctx.traffic
    cfg = build.make_config(Config, ctx.config, tr["task"])
    build._overlay(cfg.stylegan3, ctx.config["stylegan3"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx.setup.mark("imports and CUDA context")
    params_sd = weights(ctx.config, ctx.seed, tr["calibration_images"], dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.setup.mark("the reference's init and magnitude calibration",
                   counted=False)
    g = sg3.Generator.from_config(cfg)
    params = g.params_from_state_dict(params_sd, device=dev)
    engine = ImageEngine(g=g, batch=cfg.task.batch_size, device=dev)
    if cuda:
        torch.cuda.synchronize()
    ctx.setup.mark("weights and engine")
    B = cfg.task.batch_size
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def unit(gen, spans_on=False):
        if not spans_on:
            return to_uint8(engine.generate(params, gen).cpu().numpy())
        with trace.span("generate"):
            images = engine.generate(params, gen)
        with trace.span("host_copy"):
            images = images.cpu().numpy()
        with trace.span("to_uint8"):
            return to_uint8(images)

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

    sg = ctx.config["stylegan3"]
    records = {"untraced_images": images, "untraced_s": window_s,
               "images_per_unit": B,
               "flops_per_image": flops_sg3.image_flops(sg),
               "filtered_lrelu_bytes": flops_sg3.filtered_lrelu_bytes(sg),
               # float16's tensor-core peak is bfloat16's
               "peak_flops": peaks.PEAK_FLOPS["bfloat16"],
               "power_limit_w": peaks.power_limit_w() if cuda else None}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)
              if cuda else 0}
    breakdown = None
    if ctx.trace:
        n, joined = tr["traced_units"], {}

        def traced():
            for i in range(n):
                unit(build.generator(ctx.seed, build.TAG_WARM, 1 + i,
                                     device=dev), spans_on=True)

        breakdown = spans.with_spans(trace.profile, joined)(traced, records,
                                                            sync)
        records["traced_images"] = n * B
        if "table" in joined:
            records["spans"] = joined["table"]
            records["counters"] = joined["counters"]
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
    want = reference_sample(ctx.config, ctx.seed, params_sd, sample, B, dev)
    harness.log(f"[reference] {sum(len(v) for v in sample.values())} images "
                f"in {time.perf_counter() - t_ref:.3f} s")
    checks = ref_render.checks(got, want, ctx.limits)
    return harness.Outcome(end_to_end=e2e, records=records,
                           attempted=images, failed=0, checks=checks,
                           device=device, breakdown=breakdown)


if __name__ == "__main__":
    import sys

    sys.exit(main())
