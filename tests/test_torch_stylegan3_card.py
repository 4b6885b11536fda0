"""StyleGAN3-T at full width on the card (models/stylegan3.py through
infer/image_engine.py): the published float16 / float32 split is what
runs, the spans open where PERF.md says, the filtered LeakyReLU's kernel
is the only hand-written kernel launched, once a layer, and a generate
equals the plain reference
(portbench/reference/stylegan3.py, float32, TF32 off, one image at a
time) within the render-sg3t-1024 cell's limits.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_stylegan3_card.py

Skips without a CUDA device."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from helpers.card import Launches, needs_card, no_tf32, only
from portbench.reference import render as ref_render
from portbench.reference import stylegan3 as ref
from spgan_tpu_torch.config import Config, StyleGAN3Params
from spgan_tpu_torch.infer.image_engine import ImageEngine
from spgan_tpu_torch.infer.managers import to_uint8
from spgan_tpu_torch.models import stylegan3 as sg3
from spgan_tpu_torch.utils import trace

LIMITS = pathlib.Path(__file__).resolve().parent.parent / "portbench" / \
    "limits" / "render-sg3t-1024.json"


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _full(seed, n_cal=2):
    """The generator at the shipped widths (float16 above the head), the
    reference's init from `seed` with its magnitudes calibrated, and the
    program's tree of the same tensors."""
    g = sg3.Generator.from_config(Config())
    sg = dataclasses.asdict(StyleGAN3Params())
    gen = torch.Generator("cuda").manual_seed(seed)
    sd = ref.init(sg, gen, "cuda")
    ref.calibrate_magnitudes(
        sg, sd, torch.randn((n_cal, 512), generator=gen, device="cuda"))
    return g, sg, sd, g.params_from_state_dict(sd, device="cuda")


@pytest.mark.gpu
def test_the_published_split_runs():
    """Ten layers in float16, five in float32 a generate, the filtered
    LeakyReLU span fourteen times (L0-L13), the input span once, and of
    the port's hand-written kernels only the filtered LeakyReLU's, once a
    layer."""
    g, _, _, params = _full(5)
    engine = ImageEngine(g=g, batch=2, device="cuda")
    trace.reset()
    trace.enable()
    try:
        with Launches() as launches:
            out = engine.generate(params,
                                  torch.Generator("cuda").manual_seed(1))
    finally:
        trace.disable()
    assert out.shape == (2, 1024, 1024, 3) and out.dtype == torch.float32
    assert bool(out.isfinite().all())
    c = trace.counters()
    assert (c["spgan.sg3.layers_fp16"], c["spgan.sg3.layers_fp32"]) == (10, 5)
    assert c["spgan.engine.batches"] == 1
    names = [r["name"] for r in trace.records()]
    assert names.count("spgan.sg3.filtered_lrelu") == 14
    assert names.count("spgan.sg3.input") == 1
    assert names.count("spgan.engine.generate") == 1
    assert launches.got == only(filtered_lrelu=14)
    trace.reset()


@pytest.mark.gpu
def test_a_generate_is_the_reference_within_the_cells_limits():
    """Two images by the program (float16 above the head) and by the
    reference (float32), as uint8: the cell's two checks, each within its
    limit (limits/render-sg3t-1024.json)."""
    g, sg, sd, params = _full(7)
    engine = ImageEngine(g=g, batch=2, device="cuda")
    z = torch.randn((2, 512), generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda")
    got = to_uint8(engine.generate_from_latents(params, z).cpu().numpy())
    with torch.no_grad():
        want = ref_render.to_uint8(ref.generate(sg, sd, z).cpu().numpy())
    mean, worst = ref_render.gaps({0: got}, {0: want})
    limits = {k: v["limit"] for k, v in
              json.loads(LIMITS.read_text())["checks"].items()}
    assert mean <= limits["mean_lsb"], mean
    assert worst <= limits["worst_image_lsb"], worst
    assert len(np.unique(got)) > 64       # not saturated
