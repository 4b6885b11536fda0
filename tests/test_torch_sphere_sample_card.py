"""csrc/sphere_sample.cu against its plain PyTorch version on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_sphere_sample_card.py -m gpu

Skips without a CUDA device.  The kernel and the plain version run the
same float32 lerps op by op (no FMA contraction) and cast once, so the
taps must agree exactly, in float32 and in bf16."""
import numpy as np
import pytest
import torch

from helpers.card import Launches, needs_card
from spgan_tpu_torch.ops.kernels import sphere_sample as ts


def _random_tables(rng, B, H, K2, far=False, shift=9):
    """Random tables in range, shifts in [-shift, shift) (past the
    margin).  `far`: y0 and y1 drawn apart, so a tap row of 3 taps reaches
    up to 6 distinct rows, more than the kernel's 3 row slots hold."""
    t = {"y0": rng.randint(0, H, (B, H, K2)).astype(np.int32),
         "wy": rng.rand(B, H, K2).astype(np.float32),
         "sx": rng.randint(-shift, shift, (B, H, K2)).astype(np.int32),
         "fx": rng.rand(B, H, K2).astype(np.float32)}
    if far:
        t["y1"] = rng.randint(0, H, (B, H, K2)).astype(np.int32)
    else:
        t["y1"] = np.minimum(t["y0"] + 1, H - 1).astype(np.int32)
    return {k: torch.tensor(v).cuda() for k, v in t.items()}


# (B, H, W, C, margin, far rows): C in {3, 4, 256, 259} (below and at one
# 16-byte store of float32 and bf16, aligned and unaligned rows), W in
# {1, 2, 11, 35} with H != W, H = 1, margins 1 and 6.  Odd W*C puts the
# strips' starts at every residue mod 16 bytes (checked below).  The last
# case's rows (103,600 bytes in float32) leave 2 slots, not 3.  The
# extrapolated image grids of the training loop run the first SS layers at
# W = 45 and 65 (rows of 46,620 and 67,340 bytes in float32: 3 slots), with
# column margins near 47 (their crops reach the pole); those cases draw
# shifts past such a margin.
CASES = [
    (3, 13, 11, 259, 6, False),
    (2, 9, 35, 259, 6, True),
    (2, 5, 11, 3, 6, True),
    (2, 7, 1, 4, 1, False),
    (2, 6, 2, 256, 1, True),
    (3, 1, 11, 259, 6, False),
    (2, 4, 35, 256, 6, True),
    (2, 3, 2, 3, 1, False),
    (2, 17, 35, 259, 1, True),
    (1, 6, 100, 259, 6, True),
    (2, 45, 45, 259, 47, False),
    (2, 65, 65, 259, 47, False),
    (1, 65, 65, 259, 47, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}H{}W{}C{}M{}{}".format(
    *c[:5], "far" if c[5] else ""))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype, case):
    """Exact against the plain version: unaligned strips and rows, narrow
    C (a 16-byte store spans pixels), W=1 and 2 (every column clamps),
    H=1, shifts beyond the margin, rows far apart (slot eviction), and the
    extrapolated grids' widths with their wide margins."""
    needs_card()
    B, H, W, C, margin, far = case
    rng = np.random.RandomState(sum(case[:5]))
    x = torch.tensor(rng.randn(B, H, W, C), dtype=dtype).cuda()
    tabs = _random_tables(rng, B, H, 9, far, shift=max(9, margin + 3))
    if W * C % 2 and B * 9 * H >= 8:
        size = x.element_size()
        starts = {(s * W * C * size) % 16 for s in range(B * 9 * H)}
        assert starts == set(range(0, 16, size))
    ref = ts.sphere_sample_taps_plain(x, tabs, margin).cpu()
    with Launches() as n:
        got = ts.sphere_sample_taps(x, tabs, margin)
    assert n.got["sphere_sample"] == 1
    assert got.dtype == dtype and tuple(got.shape) == (B, 9, H, W, C)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_kernel_rejects_bad_operands_on_card():
    """The wrapper raises, and launches nothing, on operands the kernel does
    not take; the size checks are shape arithmetic and allocate nothing."""
    needs_card()
    rng = np.random.RandomState(1)
    x = torch.randn(2, 5, 7, 259, device="cuda")
    tabs = _random_tables(rng, 2, 5, 9)
    with Launches() as n:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ts.sphere_sample_taps(x.half(), tabs)
        with pytest.raises(ValueError, match="contiguous"):
            ts.sphere_sample_taps(x.transpose(1, 2), tabs)
        with pytest.raises(ValueError, match="table wy"):
            ts.sphere_sample_taps(x, {**tabs, "wy": tabs["wy"].double()})
        with pytest.raises(ValueError, match="table y0"):
            ts.sphere_sample_taps(x, {**tabs, "y0": tabs["y0"][:1]})
        # 2^31 output elements: 32768 taps of one 65536-channel pixel
        wide = torch.zeros(1, 1, 1, 65536, device="cuda")
        big = {k: torch.zeros((1, 1, 32768), dtype=dt, device="cuda")
               for k, dt in ts.TABLE_DTYPES.items()}
        before = torch.cuda.memory_allocated()
        with pytest.raises(ValueError, match="2\\^31"):
            ts.sphere_sample_taps(wide, big)
        assert torch.cuda.memory_allocated() == before
        # a row of 65536 float32 (256 KiB) does not fit in shared memory
        # twice
        with pytest.raises(ValueError, match="shared memory"):
            ts.sphere_sample_taps(wide, {k: v[..., :9].contiguous()
                                         for k, v in big.items()})
    assert n.got["sphere_sample"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 8])
@pytest.mark.parametrize("H", [35, 29, 23, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_training_shapes_on_card(dtype, H, B):
    """The training step's own call at each SS size: C=259, the tables of
    random training crops (x_total 45, y_total 140, partial 0.8), the
    step's batch of 16 and a data-parallel rank's 8: exact."""
    needs_card()
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.sphere_grid import sphere_offset_tables_batch
    from spgan_tpu_torch.models.generator import Generator

    grid = Generator.from_config(Config()).ss.coord_grid
    _, _, cp = grid.sample_training(
        torch.Generator(device="cuda").manual_seed(H), B)
    tabs = {k: v.contiguous()
            for k, v in sphere_offset_tables_batch(cp, H, H).items()}
    rng = np.random.RandomState(H + B)
    x = torch.tensor(rng.randn(B, H, H, 259), dtype=dtype).cuda()
    assert torch.equal(ts.sphere_sample_taps(x, tabs),
                       ts.sphere_sample_taps_plain(x, tabs))
