"""SP-GAN's 197-pixel patch plan (TextureSynthesizer out_res 197: ten TS
convs, the fourth sphere skip conv, the fifth ToRGB) through the port's
close-loop PanoramaEngine on the CPU, at tiny widths:

  * against the benchmark's plain float32 reference
    (portbench/reference/spgan: plain torch, none of the port's kernels)
    on the same seeded random weights and fields;
  * its lattice at 2H x 2W is the 101 plan's at H x W, on a pixel step
    twice as long;
  * the tracer's counter of sphere skip convs (3 a chunk on the 101
    plan, 4 on the 197 plan) and its span spgan.generator.ts_top, which
    opens on the 197 plan's layers past the 101 plan's and never on the
    101 plan."""
import numpy as np
import pytest
import torch

from portbench import build
from portbench.reference.spgan.config import Config as RefConfig
from portbench.reference.spgan.infer import engine as ref_engine
from portbench.reference.spgan.infer import stitcher as ref_stitcher
from portbench.reference.spgan.models import generator as ref_generator
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models import generator as port_generator
from spgan_tpu_torch.utils import trace

# the portbench tiny widths; channel_base 16 puts 8-16 channels in every
# TS conv, so the 199 x 199 layers stay cheap on a CPU
TINY = {"train_params": {"global_latent_dim": 32, "local_latent_dim": 16,
                         "channel_multiplier": 1, "n_mlp": 2,
                         "ss_n_layers": 2},
        "ts_channel_base": 16}
# the narrowest close-loop panorama at the 197 plan whose latent field is
# as wide as the SS window (4 lattice columns of 6 latents >= 23), on the
# fewest lattice rows (3)
NARROW = (192, 768)
# the cell's width on the fewest lattice rows: NARROW's wrap column spans
# a whole turn with the circular flag off, a one-ulp longitude range that
# the grid's min-max normalisation blows up to rounding noise, so a
# comparison of two implementations there compares their rounding
# (tests/test_torch_p197_jax.py)
WIDE = (192, 1536)


def _cfg_json(patch: int) -> dict:
    return {"train_params": dict(TINY["train_params"], patch_size=patch),
            "ts_channel_base": TINY["ts_channel_base"]}


def _port(patch: int, h: int, w: int, batch: int = 1):
    cfg_json = _cfg_json(patch)
    cfg = build.make_config(Config, cfg_json, {})
    g = build.make_generator(port_generator, cfg, cfg_json)
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, h, w),
                         batch=batch, patch_chunk=4,
                         grid_partial=cfg.train_params.partial, device="cpu")
    return eng, build.generator_params(cfg_json, 0, "cpu")


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def test_engine_p197_matches_the_plain_reference():
    """Float32 on both sides, each with its own plain convolutions,
    resampling and tap tables: the meta images agree to summation-order
    noise, atol 2e-4 (the port's engine parity bound against JAX,
    tests/test_torch_engine.py) on values of order 1 to 10."""
    eng, params = _port(197, *WIDE, batch=2)
    cfg_json = _cfg_json(197)
    rcfg = build.make_config(RefConfig, cfg_json, {})
    rg = build.make_generator(ref_generator, rcfg, cfg_json)
    ref = ref_engine.PanoramaEngine(
        g=rg, plan=ref_stitcher.build_close_loop_plan(rg, *WIDE), batch=2,
        patch_chunk=4, grid_partial=rcfg.train_params.partial,
        compute_dtype="float32", device="cpu")
    fields = ref.sample_fields(torch.Generator().manual_seed(3))
    want = ref.generate_from_fields(params, *fields)
    got = eng.generate_from_fields(params, *fields)
    assert eng.g.ts.num_layers == 10 and len(params["ts"]["sp_convs"]) == 4
    assert tuple(got.shape) == tuple(want.shape) == (2, 581, 1536, 3)
    assert float(want.abs().max()) > 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


@pytest.mark.parametrize("h, w", [(384, 768), (256, 576)])
def test_p197_at_twice_the_size_renders_the_101_lattice(h, w):
    small, _ = _port(101, h, w)
    large, _ = _port(197, 2 * h, 2 * w)
    a, b = small.plan, large.plan
    assert b.geom.pixelspace_step == 2 * a.geom.pixelspace_step == 192
    assert b.geom.latentspace_step == a.geom.latentspace_step == 6
    for k in ("num_steps_h", "num_steps_w", "num_steps_w_min", "window",
              "z_field_w", "x_total", "y_total"):
        assert getattr(b, k) == getattr(a, k), k
    np.testing.assert_array_equal(b.z_starts, a.z_starts)
    np.testing.assert_array_equal(b.img_starts, 2 * a.img_starts)
    np.testing.assert_array_equal(b.cp_scalars, a.cp_scalars)
    np.testing.assert_array_equal(large._render_idx, small._render_idx)
    if (h, w) == (384, 768):
        # the cells render-360-bf16 and render-360-p197-bf16
        assert (b.num_patches, len(large._render_idx)) == (60, 48)


@pytest.mark.parametrize("patch, per_chunk", [(101, 3), (197, 4)])
def test_sphere_skip_counter_per_chunk(patch, per_chunk):
    eng, params = _port(patch, *NARROW)
    chunks = len(eng._render_idx) // eng.patch_chunk
    before = trace.counters().get("spgan.generator.sphere_skip", 0)
    eng.generate(params, torch.Generator().manual_seed(1))
    after = trace.counters()["spgan.generator.sphere_skip"]
    assert after - before == per_chunk * chunks


@pytest.mark.parametrize("patch", [101, 197])
def test_ts_top_span_opens_only_on_the_197_plan(patch):
    eng, params = _port(patch, *NARROW)
    chunks = len(eng._render_idx) // eng.patch_chunk
    off = eng.generate(params, torch.Generator().manual_seed(2))
    trace.enable()
    on = eng.generate(params, torch.Generator().manual_seed(2))
    trace.disable()
    assert torch.equal(off, on)
    recs = trace.records()
    tops = [r for r in recs if r["name"] == "spgan.generator.ts_top"]
    if patch == 101:
        assert tops == []
        return
    assert len(tops) == chunks
    for r in tops:
        assert recs[r["parent"]]["name"] == "spgan.generator.ts"
