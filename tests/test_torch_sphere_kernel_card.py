"""csrc/sphere_conv.cu against its plain PyTorch version on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_sphere_kernel_card.py -m gpu

Skips without a CUDA device.  Tolerances: float32 1e-5 (the same lerps,
products summed in another order; TF32 off); bf16 atol 1e-3 / rtol 2^-7
(identical bf16 taps, float32 sums in another order can move the final
bf16 rounding by one ulp).

The bf16 kernel gives each consumer warpgroup a unit of 64 consecutive
pixels and a thread a strip of 4 of them, so the cases below cover units
and strips that cross image rows (W not a multiple of 4 or 64, W = 4, 5),
partial last units, idle warpgroups in the last round, one table per
sample (Bg = 1) and per group (Bg = 5, 16), channel counts below and
between the 64-channel stages (C = 16, 24, 40, 72) and Cout below, at and
above the 256 a block covers."""
import os

import numpy as np
import pytest
import torch

from helpers.card import Launches, needs_card, no_tf32
from spgan_tpu_torch.ops.kernels import sphere_kernel as tk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=1e-3, rtol=2 ** -7)}


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _random_group_tables(rng, G, H, K2):
    tg = {"y0": rng.randint(0, H, (G, H, K2)).astype(np.int32),
          "wy": rng.rand(G, H, K2).astype(np.float32),
          "sx": rng.randint(-7, 7, (G, H, K2)).astype(np.int32),
          "fx": rng.rand(G, H, K2).astype(np.float32)}
    tg["y1"] = np.minimum(tg["y0"] + 1, H - 1).astype(np.int32)
    return {k: torch.tensor(v) for k, v in tg.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    """Both entry points, ragged tiles (M and Cout not multiples of the
    tile, C not a multiple of the channel chunk), shifts beyond the
    margin."""
    rng = np.random.RandomState(2)
    G, Bg, H, W, C, Cout = 3, 5, 13, 11, 40, 136
    x = torch.tensor(rng.randn(G * Bg, H, W, C), dtype=dtype).cuda()
    w9 = torch.tensor(rng.randn(9, C, Cout) / np.sqrt(9 * C),
                      dtype=dtype).cuda()
    tg = {k: v.cuda() for k, v in _random_group_tables(rng, G, H, 9).items()}
    tp = {k: v.repeat_interleave(Bg, dim=0).contiguous() for k, v in tg.items()}
    ref = tk.fused_sphere_conv_plain(x, tg, w9, G).cpu()
    with Launches() as n:
        got_g = tk.fused_sphere_conv_grouped(x, tg, w9, groups=G).cpu()
        got_p = tk.fused_sphere_conv(x, tp, w9).cpu()
    assert n.got["sphere_conv.grouped"] == n.got["sphere_conv"] == 1
    for got in (got_g, got_p):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   **_TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_bad_operands_on_card():
    """The wrapper raises, and launches nothing, on operands the kernel does
    not take."""
    rng = np.random.RandomState(3)
    x = torch.randn(2, 5, 7, 16, device="cuda")
    w9 = torch.randn(9, 16, 8, device="cuda")
    tg = {k: v.cuda() for k, v in _random_group_tables(rng, 2, 5, 9).items()}
    with Launches() as n:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tk.fused_sphere_conv(x.half(), tg, w9.half())
        with pytest.raises(ValueError, match="multiples of 8"):
            tk.fused_sphere_conv(x[..., :12].contiguous(), tg,
                                 w9[:, :12].contiguous())
        with pytest.raises(ValueError, match="contiguous"):
            tk.fused_sphere_conv(x, tg, torch.randn(9, 8, 16, device="cuda")
                                 .transpose(1, 2))
        with pytest.raises(ValueError, match="table y0"):
            tk.fused_sphere_conv(x, {**tg, "y0": tg["y0"].long()}, w9)
        with pytest.raises(ValueError, match="W >= 4"):
            tk.fused_sphere_conv(x[:, :, :3].contiguous().bfloat16(), tg,
                                 w9.bfloat16())
    assert n.got["sphere_conv"] == 0


def _check_both_entry_points(x, tg, w9, G, tol=None):
    """Grouped and per-sample launches against the plain version."""
    Bg = x.shape[0] // G
    tp = {k: v.repeat_interleave(Bg, dim=0).contiguous() for k, v in tg.items()}
    ref = tk.fused_sphere_conv_plain(x, tg, w9, G).cpu()
    with Launches() as n:
        got_g = tk.fused_sphere_conv_grouped(x, tg, w9, groups=G).cpu()
        got_p = tk.fused_sphere_conv(x, tp, w9).cpu()
    assert n.got["sphere_conv.grouped"] == n.got["sphere_conv"] == 1
    for got in (got_g, got_p):
        assert got.dtype == x.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   **(tol or _TOL[x.dtype]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Bg,H,W,C,Cout", [
    (2, 16, 9, 13, 256, 256),   # Bg = 16, W not a multiple of 4
    (6, 1, 11, 13, 64, 64),     # one table per sample
    (2, 4, 17, 17, 16, 16),     # the tiny engine's widths
    (2, 3, 5, 5, 24, 40),       # W = 5: most strips cross an image row
    (1, 4, 6, 4, 8, 8),         # W = 4, the least the bf16 kernel takes
    (1, 2, 6, 7, 72, 264),      # C spans two stages, Cout two blocks
])
def test_kernel_ragged_tiles_on_card(G, Bg, H, W, C, Cout, dtype):
    rng = np.random.RandomState(G * 1000 + H * 10 + C)
    x = torch.tensor(rng.randn(G * Bg, H, W, C), dtype=dtype).cuda()
    w9 = torch.tensor(rng.randn(9, C, Cout) / np.sqrt(9 * C),
                      dtype=dtype).cuda()
    tg = {k: v.cuda() for k, v in _random_group_tables(rng, G, H, 9).items()}
    _check_both_entry_points(x, tg, w9, G)


def _engine_tables(H, G, seed):
    """Offset tables of G lattice positions of the shipped 384x768
    close-loop plan at SS size H."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.coords import CoordsPartial
    from spgan_tpu_torch.geometry.sphere_grid import sphere_offset_tables_batch
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator

    plan = build_close_loop_plan(Generator.from_config(Config()), 384, 768)
    pos = np.random.RandomState(seed).choice(len(plan.cp_scalars), G,
                                             replace=False)
    cp = CoordsPartial.from_scalars(plan.cp_scalars[pos], plan.x_total,
                                    plan.y_total, 0.6667)
    return {k: v.cuda().contiguous()
            for k, v in sphere_offset_tables_batch(cp, H, H).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [35, 29, 23, 17])
def test_kernel_at_engine_shapes_on_card(H, dtype):
    """The engine's own call at each SS size: B=64 in G=4 groups,
    C=Cout=256, the real offset tables of the shipped plan.  float32 sums
    9*C products in another order: atol 2e-4 * sqrt(C/16), rtol 1e-4."""
    B, G, C = 64, 4, 256
    rng = np.random.RandomState(H)
    x = torch.tensor(rng.randn(B, H, H, C), dtype=dtype).cuda()
    w9 = torch.tensor(rng.randn(9, C, C) / np.sqrt(9 * C), dtype=dtype).cuda()
    tol = (dict(atol=2e-4 * np.sqrt(C / 16), rtol=1e-4)
           if dtype == torch.float32 else None)
    _check_both_entry_points(x, _engine_tables(H, G, seed=H), w9, G, tol)


@pytest.mark.gpu
def test_kernel_at_halo_shapes_on_card():
    """The width-sharded (halo) path's own call in float32: spgan.yaml at
    384x1056, batch 4, a chunk of one lattice column (its rows are the
    groups), C=Cout=local_dim, the path's tables of its first column at
    every SS size; the engine-shape limits."""
    from spgan_tpu_torch.config import load_config
    from spgan_tpu_torch.infer.halo import make_width_sharded_generate
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.parallel.mesh import Mesh

    cfg = load_config(os.path.join(REPO, "configs", "model", "spgan.yaml"))
    assert cfg.train_params.compute_dtype == "float32"
    g = Generator.from_config(cfg)
    batch = 4
    fn = make_width_sharded_generate(
        g, build_close_loop_plan(g, 384, 1056), Mesh(device="cuda"), batch,
        cfg.train_params.partial, device="cuda")
    G, C = fn.nh, g.ss.local_dim
    assert G == 6
    rng = np.random.RandomState(9)
    tol = dict(atol=2e-4 * np.sqrt(C / 16), rtol=1e-4)
    for tables in fn.tables[0]:
        H = tables["y0"].shape[1]
        x = torch.tensor(rng.randn(G * batch, H, H, C),
                         dtype=torch.float32).cuda()
        w9 = torch.tensor(rng.randn(9, C, C) / np.sqrt(9 * C),
                          dtype=torch.float32).cuda()
        _check_both_entry_points(x, tables, w9, G, tol)
