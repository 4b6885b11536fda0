"""Readings that set a cell's limits, made once when the cell is
defined (the benchmark's own runs do not make them):

    python3 -m portbench.probe --workload <name> [--seeds 11 12 ...] \\
        [--control-seeds 21 22 23] [--self-seeds 31] [--std-seeds 41] \\
        [--fault g_half --fault-seeds 51 52 53]

  --seeds          one run of the cell each, with a window of one unit:
                   the program's numbers compared (its sound readings)
  --control-seeds  the control: the reference in the next lower precision
                   than the configuration states put in the program's
                   place (fp8 operands for bfloat16, TF32 for float32),
                   against the reference, at the cell's sample size
  --self-seeds     the training reference against itself (its own
                   nondeterminism: cuDNN's float32 kernels do not fix their
                   summation order)
  --std-seeds      the spread of two calibrated reference panoramas of a
                   seed (the ToRGB calibration at work)
  --fault-seeds    a training fault (--fault) planted in the reference put
                   in the program's place, against the reference: half of
                   the batch left out of the G loss (g_half) or of the D
                   loss (d_half), the mean taken over the rest

Prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
FAULTS = {"g_half": "g_nonsaturating_loss", "d_half": "d_logistic_loss"}


@contextlib.contextmanager
def half_batch(fault: str, losses=None):
    """The loss FAULTS[fault] of a losses module (default the reference's)
    taken over the first half of the batch alone while inside."""
    if losses is None:
        from portbench.reference.spgan.models import losses
    name = FAULTS[fault]
    loss = getattr(losses, name)

    def half(*preds):
        n = preds[0].shape[0] // 2
        return loss(*(p[:n] for p in preds))

    setattr(losses, name, half)
    try:
        yield
    finally:
        setattr(losses, name, loss)


def _dtype(cfg_json: dict) -> str:
    return cfg_json.get("train_params", {}).get("compute_dtype", "float32")


def control_reading(cell_files, seed: int, device, n_batches: int) -> dict:
    """The control's numbers on one seed, at the cell's own sample size."""
    from portbench.loops.render import sample_images
    from portbench.reference import render, train

    cfg_json, traffic = cell_files
    rounding = CONTROL[_dtype(cfg_json)]
    scale = render.calibrate(cfg_json, seed, device)
    if traffic["loop"] == "render":
        b = traffic["task"]["batch_size"]
        sample = sample_images(seed, n_batches, b, traffic["check_images"])
        want = render.render_sample(cfg_json, traffic, seed, scale, sample,
                                    device)
        got = render.render_sample(cfg_json, traffic, seed, scale, sample,
                                   device, rounding=rounding)
        mean, worst = render.gaps(got, want)
        return {"mean_lsb": mean, "worst_image_lsb": worst}
    want = train.first_steps(cfg_json, traffic, seed, scale, device)
    got = train.first_steps(cfg_json, traffic, seed, scale, device,
                            rounding=rounding)
    return {**train.gaps(got, want), "detail": train.detail(got, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.probe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--self-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--std-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS), default="g_half")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--window-batches", type=int, default=40,
                    help="batches a render window holds (the sample's range)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portbench import harness
    from portbench.reference import render, train

    manifest = harness.load_manifest()
    cell = harness.find_cell(manifest, args.workload)
    files = (harness.load_data("configs", cell["config"]),
             harness.load_data("traffic", cell["traffic"]))
    dev = torch.device(args.device)

    def say(side, **kw):
        print(json.dumps({"workload": args.workload, "side": side, **kw}),
              flush=True)

    for seed in args.seeds:
        r, _ = harness.run_cell(args.workload, seed, 0.0, False,
                                t0=time.perf_counter(), device=args.device,
                                manifest=manifest)
        say("program", seed=seed, correct=r["correct"],
            **{k: v["value"] for k, v in r["checks"].items()})
    for seed in args.control_seeds:
        t = time.perf_counter()
        r = control_reading(files, seed, dev, args.window_batches)
        say("control", rounding=CONTROL[_dtype(files[0])], seed=seed,
            seconds=time.perf_counter() - t, **r)
    for seed in args.self_seeds:
        scale = render.calibrate(files[0], seed, dev)
        a = train.first_steps(*files, seed, scale, dev)
        b = train.first_steps(*files, seed, scale, dev)
        say("self", seed=seed, **train.gaps(a, b), detail=train.detail(a, b))
    for seed in args.std_seeds:
        scale = render.calibrate(files[0], seed, dev)
        imgs = render.render_sample(*files, seed, scale, {0: [0, 1]}, dev,
                                    raw=True)[0]
        say("std", seed=seed, scale=scale, std=float(np.std(imgs)),
            rms=float(np.sqrt(np.mean(np.square(imgs)))),
            beyond_1=float(np.mean(np.abs(imgs) >= 1.0)))
    for seed in args.fault_seeds:
        scale = render.calibrate(files[0], seed, dev)
        want = train.first_steps(*files, seed, scale, dev)
        with half_batch(args.fault):
            got = train.first_steps(*files, seed, scale, dev)
        say("fault", fault=args.fault, seed=seed, **train.gaps(got, want),
            detail=train.detail(got, want))
    found = harness.forbidden_modules()
    if found:
        harness.log(f"forbidden modules loaded: {found}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
