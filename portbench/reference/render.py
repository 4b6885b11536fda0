"""The render cells' reference: the sampled panoramas rendered again by
the plain copy (`spgan/`), in float32 with TF32 off, from the same seed,
and the comparison of their uint8 target crops with the program's.

The reference draws each sampled batch's fields itself, with the
generator of that batch's seed and at the batch's full size (the draws
depend on it), then renders only the sampled panoramas: no panorama of
the generator depends on another, so a sample is rendered as it would be
in its whole batch.  Every lattice position is rendered, the close-loop
wrap columns too (the program renders those once and copies them).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench import build
from portbench.harness import Check
from portbench.reference import precision


def to_uint8(images: np.ndarray) -> np.ndarray:
    """(..., 3) in [-1, 1] -> uint8 as the saved PNGs are quantised."""
    arr = np.clip((images + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)


def _plan(cfg_json: dict, traffic: dict):
    """(config, generator spec, lattice plan) of a cell."""
    from portbench.reference.spgan.config import Config
    from portbench.reference.spgan.infer import stitcher
    from portbench.reference.spgan.models import generator as gen_mod

    cfg = build.make_config(Config, cfg_json, traffic["task"])
    g = build.make_generator(gen_mod, cfg, cfg_json)
    make_plan = (stitcher.build_close_loop_plan
                 if traffic["lattice"]["close_loop"]
                 else stitcher.build_infinite_plan)
    return cfg, g, make_plan(g, cfg.task.height, cfg.task.width)


def _engine(cfg_json: dict, traffic: dict, device):
    from portbench.reference.spgan.infer import engine as eng

    cfg, g, plan = _plan(cfg_json, traffic)
    return eng.PanoramaEngine(
        g=g, plan=plan, batch=cfg.task.batch_size,
        patch_chunk=cfg.task.patch_chunk, grid_partial=cfg.train_params.partial,
        compute_dtype="float32", device=device)


# the calibration render: one 384 x 768 close-loop panorama
CALIBRATION_TASK = {"height": 384, "width": 768, "batch_size": 1,
                    "patch_chunk": 4}


def calibrate(cfg_json: dict, seed: int, device) -> float:
    """The ToRGB weight scale at which the seed's weights render values
    of the configuration's assumed root mean square (`to_rgb_rms`):
    random weights at full width render values in the hundreds, and
    their uint8 pixels saturate, which no pixel comparison can see.  One
    panorama from the seed's calibration fields, by the reference in
    float32; the output is linear in the ToRGB weights but for the sphere
    skip convs' bias and ReLU."""
    traffic = {"task": CALIBRATION_TASK, "lattice": {"close_loop": True}}
    params = build.generator_params(cfg_json, seed, device)
    engine = _engine(cfg_json, traffic, device)
    with float32_exact():
        fields = engine.sample_fields(
            build.generator(seed, build.TAG_CAL, device=device))
        meta = engine.generate_from_fields(params, *fields)
    rms = float(engine.crop_to_target(meta).square().mean().sqrt())
    return cfg_json["assumed"]["to_rgb_rms"] / rms


def rendered_patches(cfg_json: dict, traffic: dict) -> int:
    """Distinct patches a panorama of the cell renders: every lattice
    position, but a close-loop lattice's wrap columns (those past
    num_steps_w_min in a row) not again where the traffic dedups them."""
    _, _, plan = _plan(cfg_json, traffic)
    lat = traffic["lattice"]
    if lat["close_loop"] and lat["dedup_wrap"]:
        return plan.num_steps_h * plan.num_steps_w_min
    return plan.num_patches


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN and matmuls while inside."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def render_sample(cfg_json: dict, traffic: dict, seed: int, scale: float,
                  sample: Dict[int, List[int]], device,
                  rounding: str = "float32", raw: bool = False
                  ) -> Dict[int, np.ndarray]:
    """{batch index: uint8 crops (n, H, W, 3)} of the sampled panoramas
    (raw: the float crops before the rounding).  rounding: "float32" (the
    reference), or a lower precision (precision.ROUNDINGS) for the
    control.  scale: the ToRGB scale of the seed's weights."""
    params = build.generator_params(cfg_json, seed, device, scale)
    engine = _engine(cfg_json, traffic, device)
    full = engine.batch
    out = {}
    with float32_exact(), precision.rounded(rounding, device):
        for k, bs in sample.items():
            engine.batch = full
            gen = build.generator(seed, build.TAG_BATCH, k, device=device)
            gl, z, noises = engine.sample_fields(gen)
            idx = torch.as_tensor(bs, device=gl.device)
            engine.batch = len(bs)
            meta = engine.generate_from_fields(
                params, gl[idx], z[idx], [n[idx] for n in noises])
            crop = engine.crop_to_target(meta).cpu().numpy()
            out[k] = crop if raw else to_uint8(crop)
    return out


def gaps(got: Dict[int, np.ndarray], want: Dict[int, np.ndarray]):
    """(mean |difference| over every sampled pixel, the largest mean
    |difference| of one image), in uint8 steps."""
    per_image = []
    for k in want:
        d = np.abs(got[k].astype(np.int32) - want[k].astype(np.int32))
        per_image += [float(x) for x in d.reshape(d.shape[0], -1).mean(1)]
    return float(np.mean(per_image)), float(np.max(per_image))


def checks(got, want, limits: dict) -> List[Check]:
    mean_lsb, worst = gaps(got, want)
    return [Check("mean_lsb", mean_lsb, limits["mean_lsb"]),
            Check("worst_image_lsb", worst, limits["worst_image_lsb"])]
