"""What both sides of a cell are built from: the configuration file turned
into a config object, the generator and discriminator specs, the weights,
the seeds of every batch and the real patches of the training feed.

The program (`spgan_tpu_torch`) and the reference (`portbench.reference.
spgan`) each pass their own config and model modules; the weights come
from the reference's copy of the init code, run on the device with a
generator seeded from `--seed`, so the two sides get the same tensors and
nothing of the program makes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

SECTIONS = ("train_params", "data_params", "log_params", "test_params")
# tags of the streams drawn from one --seed
TAG_G, TAG_D, TAG_BATCH, TAG_REAL, TAG_WARM, TAG_CAL = 1, 2, 3, 4, 5, 6


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed of (seed, tags): a function of its arguments only."""
    s = np.random.SeedSequence([seed % 2 ** 64, *tags])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *tags: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def make_config(config_cls, cfg_json: dict, task: dict) -> Any:
    """config_cls() with the file's sections and the traffic's task
    overlaid, as the program's yaml loader overlays them."""
    cfg = config_cls()
    for section in SECTIONS:
        _overlay(getattr(cfg, section), cfg_json.get(section, {}))
    _overlay(cfg.task, task)
    return cfg


def _overlay(dc, data: dict) -> None:
    names = {f.name for f in dataclasses.fields(dc)}
    for k, v in data.items():
        if k not in names:
            raise KeyError(f"no config field {k!r} in {type(dc).__name__}")
        if isinstance(getattr(dc, k), tuple) and isinstance(v, list):
            v = tuple(v)
        setattr(dc, k, v)


def make_generator(generator_mod, cfg, cfg_json: dict):
    """Generator.from_config; a test configuration may cut the texture
    synthesizer's channel base (`ts_channel_base`), which no cell sets."""
    g = generator_mod.Generator.from_config(cfg)
    base = cfg_json.get("ts_channel_base")
    if base is not None:
        g = dataclasses.replace(g, ts=dataclasses.replace(g.ts,
                                                          channel_base=base))
    return g


def _ref_models():
    from portbench.reference.spgan.models import discriminator, generator
    return generator, discriminator


def generator_params(cfg_json: dict, seed: int, device,
                     to_rgb_scale: float = 1.0) -> dict:
    """The generator's weights from `seed`: the shipped init drawn on the
    device, the ToRGB weights times `to_rgb_scale` (reference.render.
    calibrate gives the scale at which a panorama's values have the
    configuration's assumed standard deviation, so its uint8 pixels are
    not saturated)."""
    from portbench.reference.spgan.config import Config

    gen_mod, _ = _ref_models()
    cfg = make_config(Config, cfg_json, {})
    g = make_generator(gen_mod, cfg, cfg_json)
    with torch.device(device):
        params = g.init(generator(seed, TAG_G, device=device), device=device)
    for p in params["ts"]["to_rgbs"]:
        p["conv"]["weight"].mul_(to_rgb_scale)
    return params


def discriminator_params(cfg_json: dict, seed: int, device) -> dict:
    from portbench.reference.spgan.config import Config

    _, d_mod = _ref_models()
    cfg = make_config(Config, cfg_json, {})
    d = d_mod.Discriminator.from_config(cfg)
    with torch.device(device):
        return d.init(generator(seed, TAG_D, device=device), device=device)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def real_batch(seed: int, it: int, batch: int, cfg, device):
    """The training feed of iteration `it`: `batch` real patches (B,P,P,3)
    in [-1, 1], smooth noise upsampled from an eighth of full_size and
    cropped at random origins, with the crops' ac coordinates (B,3) as the
    data pipeline's PatchCropper computes them.  Every row differs."""
    tp = cfg.train_params
    full, patch = tp.full_size, tp.patch_size
    gen = generator(seed, TAG_REAL, it, device=device)
    base = torch.rand((batch, 3, full // 8 + 1, full // 8 + 1),
                      generator=gen, device=device)
    img = torch.nn.functional.interpolate(base, size=(full, full),
                                          mode="bilinear",
                                          align_corners=True)
    span = full - patch
    xst = torch.randint(0, span, (batch,), generator=gen, device=device)
    yst = torch.randint(0, span, (batch,), generator=gen, device=device)
    ar = torch.arange(patch, device=device)
    rows = (xst[:, None] + ar)[:, :, None]
    cols = (yst[:, None] + ar)[:, None, :]
    bidx = torch.arange(batch, device=device)[:, None, None]
    out = img.permute(0, 2, 3, 1)[bidx, rows, cols] * 2.0 - 1.0

    def ratio(v):
        return v.float() / (full - patch - 1) * 2.0 - 1.0

    ac = torch.stack([ratio(xst), torch.sin(ratio(yst) * np.pi),
                      torch.cos(ratio(yst) * np.pi)], dim=-1)
    return out.contiguous(), ac.float()
