"""The four-rank cell's loop (portbench/loops/render_sharded.py) over NCCL,
one rank a card: rank 0's gathered images equal the folded engine's on
the first card bit for bit, at the portbench tiny widths in bfloat16 (the
cell's dtype: the SS on the sphere-conv kernel, the blurs on upfirdn2d),
on the cell's traffic cut to batch 2.  The ranks run the folded engine's
own chunks with the same kernels on cards of one kind, so nothing may
differ.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_portbench_sharded_card.py

Skips with fewer than four CUDA devices."""
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.loops import render_sharded
from portbench.reference import render as ref_render
from test_portbench_sharded import TINY, _folded, _traffic

BF16 = dict(TINY, train_params=dict(TINY["train_params"],
                                    compute_dtype="bfloat16"))


@pytest.mark.gpu
def test_rank0_images_equal_the_folded_engine_over_nccl():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    seed = 2 ** 33 + 5
    dev = torch.device("cuda", 0)
    scale = ref_render.calibrate(BF16, seed, dev)
    ctx = harness.Context(
        workload="sharded-tiny", seed=seed, seconds=2.0, trace=False,
        device="cuda", cell={}, config=BF16, traffic=_traffic(),
        setup=harness.SetupClock(time.perf_counter(), lambda _: None))
    result, got = render_sharded.gathered(ctx, scale)
    assert result["device"]["count"] == 4
    assert result["images"] >= 2
    sample = {int(k): v for k, v in result["sample"].items()}
    want = _folded(scale, sample, seed, config=BF16, device=dev)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
