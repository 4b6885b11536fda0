"""The panorama engine and the inference CLI on the card: the tiny engines
on cuda (the kernels) against the same engines on cpu (the plain
versions), and the launches of the hand-written kernels at the shipped
widths, per generate, per patch forward and per CLI batch.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_engine_card.py

Skips without a CUDA device."""
import math
import os
import struct

import numpy as np
import pytest
import torch

from helpers.card import Launches, assert_close, needs_card, no_tf32, only, \
    tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


@pytest.mark.gpu
@pytest.mark.parametrize("planar", [False, True], ids=["close_loop", "planar"])
def test_tiny_engine_matches_cpu_on_card(planar):
    """Close-loop 128x672 or planar 128x200, batch 2, float32: the same
    weights and fields on both devices; one grouped launch an SS layer a
    chunk."""
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import (build_close_loop_plan,
                                                build_infinite_plan)
    from spgan_tpu_torch.models.generator import Generator

    g = Generator.from_config(tiny_config())
    object.__setattr__(g.ts, "channel_base", 48)
    plan = (build_infinite_plan(g, 128, 200) if planar
            else build_close_loop_plan(g, 128, 672))
    fields = PanoramaEngine(g=g, plan=plan, batch=2, device="cpu") \
        .sample_fields(torch.Generator().manual_seed(3))
    metas = {}
    for dev in ("cpu", "cuda"):
        params = g.init(torch.Generator().manual_seed(0), device=dev)
        eng = PanoramaEngine(g=g, plan=plan, batch=2, patch_chunk=4,
                             grid_partial=0.6667, device=dev)
        gl, z, noises = fields
        with Launches() as n:
            metas[dev] = eng.generate_from_fields(
                params, gl.to(dev), z.to(dev), [t.to(dev) for t in noises])
    assert n.got["sphere_conv.grouped"] == \
        g.ss.n_layers * len(eng._render_idx) // eng.patch_chunk
    # float32: the same math summed in another order
    assert_close(metas["cuda"], metas["cpu"], atol=2e-4)


@pytest.mark.gpu
def test_full_width_generate_launches_on_card():
    """Config() at 384x768, batch 16, bf16, chunk 4: 48 grouped sphere
    convs (4 SS layers x 12 chunks), 84 upfirdn2d (7 a chunk: 4 TS
    blurs, 3 ToRGB skips) and 144 styled conv epilogues (12 a chunk: 8 TS
    convs, 4 SS planar convs) a generate, nothing else."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator

    cfg = Config()
    g = Generator.from_config(cfg)
    params = g.init(torch.Generator().manual_seed(0), device="cuda")
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, 384, 768),
                         batch=16, patch_chunk=4,
                         grid_partial=cfg.train_params.partial,
                         compute_dtype="bfloat16", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        eng.generate(params, gen)
        with Launches() as n:
            meta = eng.generate(params, gen)
    assert n.got == only(grouped=48, upfirdn=84, styled_epilogue=144)
    assert tuple(meta.shape) == (16, 581, 768, 3)
    assert bool(meta.isfinite().all())


@pytest.mark.gpu
@pytest.mark.parametrize("plan,launches", [
    ("p197", dict(grouped=48, upfirdn=108, styled_epilogue=168)),
    ("planar", dict(grouped=60, upfirdn=105, styled_epilogue=180)),
])
def test_full_width_generate_launches_other_plans_on_card(plan, launches):
    """The two other render cells' generates, batch 16, chunk 4: the 197
    plan at 768x1536 in bf16 (12 chunks of 10 TS and 4 SS styled convs, 5
    TS blurs and 4 ToRGB skips) and the planar 384x768 lattice in float32
    (all 60 positions: 15 chunks of 8 TS and 4 SS styled convs)."""
    from spgan_tpu_torch.config import Config, load_config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import (build_close_loop_plan,
                                                build_infinite_plan)
    from spgan_tpu_torch.models.generator import Generator

    if plan == "p197":
        cfg = load_config(os.path.join(REPO, "configs", "model",
                                       "spgan_p197_bf16.yaml"))
        g = Generator.from_config(cfg)
        lattice, dtype, shape = build_close_loop_plan(g, 768, 1536), \
            "bfloat16", (16, 768, 1536)
    else:
        cfg = Config()
        g = Generator.from_config(cfg)
        lattice, dtype, shape = build_infinite_plan(g, 384, 768), \
            "float32", (16, 384, 768)
    params = g.init(torch.Generator().manual_seed(0), device="cuda")
    eng = PanoramaEngine(g=g, plan=lattice, batch=16, patch_chunk=4,
                         grid_partial=cfg.train_params.partial,
                         compute_dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.inference_mode():
        eng.generate(params, gen)
        with Launches() as n:
            meta = eng.generate(params, gen)
        crop = eng.crop_to_target(meta)
    assert n.got == only(**launches)
    assert tuple(crop.shape[:3]) == shape
    assert bool(meta.isfinite().all())


@pytest.mark.gpu
def test_patch_forward_launches_on_card():
    """Generator.apply on 16 per-sample crops of the shipped plan, bf16:
    the per-sample kernel once an SS layer."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.coords import CoordsPartial
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.spatial import out_size_chain

    cfg = Config()
    g = Generator.from_config(cfg)
    params = g.init(torch.Generator().manual_seed(0), device="cuda")
    plan = build_close_loop_plan(g, 384, 768)
    B, win = 16, plan.window
    pos = np.arange(B) * 3
    cp = CoordsPartial.from_scalars(plan.cp_scalars[pos], plan.x_total,
                                    plan.y_total, cfg.train_params.partial)
    field = g.ss.coord_grid.test_field(plan.z_field_h, plan.z_field_w)
    field = np.concatenate([field, field[:, :win]], axis=1)
    coords = np.stack([field[r:r + win, c:c + win]
                       for r, c in plan.z_starts[pos]])
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    gl = torch.randn((B, 2, 512), generator=gen, device="cuda").to(bf)
    z = torch.randn((B, win, win, 256), generator=gen, device="cuda").to(bf)
    noises = [torch.randn((B, s, s, 1), generator=gen, device="cuda").to(bf)
              for s in out_size_chain(g.ts.conv_specs_spatial(), 11)]
    with torch.inference_mode(), Launches() as n:
        img = g.apply(params, global_latent=gl, local_latent=z,
                      coords=torch.as_tensor(coords).cuda(), cp=cp,
                      noises=noises)["gen"]
    assert n.got["sphere_conv"] == g.ss.n_layers
    assert n.got["styled_epilogue"] == g.ss.n_layers + g.ts.num_layers
    assert n.got["sphere_conv.grouped"] == n.got["sphere_sample"] == 0
    assert tuple(img.shape) == (B, 101, 101, 3)
    assert bool(img.isfinite().all())


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return struct.unpack(">II", head[16:24])


def _planar_b1_float32(eng, params):
    """B1's float32 body at the planar engine's own shapes (groups = the
    chunk, Bg = the batch) on each chunk's tables, with the SS layer's
    weights and a random one, against the plain version."""
    from spgan_tpu_torch.geometry.sphere_conv import _taps
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    G, ld = eng.patch_chunk, eng.g.ss.local_dim
    scale = eng.g.ss.sphere_spec().conv_spec().scale
    rng = np.random.RandomState(5)
    for tables, blk in zip(eng._ss_tables, params["ss"]["blocks"]):
        H = tables["y0"].shape[1]
        x = torch.as_tensor(rng.randn(G * eng.batch, H, H, ld)
                            .astype(np.float32)).cuda()
        for w9 in (_taps(blk["sphere"]["conv"]["weight"].float()
                         * scale)[:, :ld].contiguous(),
                   torch.as_tensor((rng.randn(9, ld, ld) / math.sqrt(9 * ld))
                                   .astype(np.float32)).cuda()):
            for ci in range(len(eng._render_idx) // G):
                tg = {k: v[ci * G:(ci + 1) * G].contiguous()
                      for k, v in tables.items()}
                # float32 sums of 9 * C products in another order
                assert_close(sk.fused_sphere_conv_grouped(x, tg, w9, G),
                             sk.fused_sphere_conv_plain(x, tg, w9, G),
                             atol=2e-4 * math.sqrt(ld / 16), rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("model,test,n,per_batch,size", [
    ("spgan_run5k_bf16.yaml", "spgan_384x768.yaml", 16, 48, (768, 384)),
    ("spgan.yaml", "spgan_infinite_256x512.yaml", 8, 40, (512, 256)),
], ids=["close_loop_bf16", "planar_f32"])
def test_infer_cli_launches_per_batch_on_card(model, test, n, per_batch,
                                              size, tmp_path, monkeypatch):
    """`python -m spgan_tpu_torch.infer` in process at the shipped widths
    with random weights: the grouped kernel's launches a batch, no other
    sphere kernel, the PNGs; on the planar run also B1's float32 body at
    that run's shapes."""
    from spgan_tpu_torch.infer.__main__ import main

    monkeypatch.chdir(tmp_path)
    with Launches() as got:
        m = main(["--model-config", os.path.join(REPO, "configs", "model",
                                                 model),
                  "--test-config", os.path.join(REPO, "configs", "test", test),
                  "--random-init", "--num-gen", str(n), "--save-root", "out"])
    batches = m.cur_global_id // m.engine.batch
    assert batches >= 1
    assert got.got["sphere_conv.grouped"] == per_batch * batches
    assert got.got["sphere_conv"] == got.got["sphere_sample"] == 0
    # 12 styled convs a chunk against 4 grouped sphere convs
    assert got.got["styled_epilogue"] == 3 * per_batch * batches
    pngs = [f for f in os.listdir("out") if f.endswith(".png")]
    assert len(pngs) == n
    assert {_png_size(os.path.join("out", f)) for f in pngs} == {size}
    if m.engine.compute_dtype == "float32":
        _planar_b1_float32(m.engine, m.params_ema)
