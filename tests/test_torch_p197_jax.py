"""SP-GAN's 197-pixel patch plan (TextureSynthesizer out_res 197) through
the port's close-loop PanoramaEngine against the JAX package's, as
tests/test_torch_engine.py holds the 101 plan: the same weights
(compat/from_jax.py), the same injected fields, the JAX engine's plain
(XLA) path with skip tables.  Both are float32, so the meta images agree
to summation-order noise: atol 2e-4, the JAX package's own engine bound.

The panorama is 192x1536 (the cell's width on the fewest lattice rows),
at tiny widths (channel_base 16: 8-16 channels in every TS conv).  The
narrowest close-loop panorama at the 197 plan, 192x768
(tests/test_torch_p197.py's NARROW), is no yardstick here: its wrap
column 5 spans a whole turn (p_y 0.25..1.25) with the circular flag off,
so its longitude range is one float32 ulp wide and the grid's min-max
normalisation turns rounding into the grid.  The two packages round that
differently (by up to 18 in the meta image), at the 101 plan's narrowest
panorama (96x384) as at the 197 plan's; no wider lattice has such a
column."""
import numpy as np
import pytest
import jax
import torch

from spgan_tpu.config import Config as JConfig
from spgan_tpu.infer.engine import PanoramaEngine as JEngine
from spgan_tpu.infer.stitcher import build_close_loop_plan as jplan
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.infer.engine import PanoramaEngine
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models.generator import Generator

WIDE = (192, 1536)
CHANNEL_BASE = 16


def _tiny(cfg, patch):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    tp.patch_size = patch
    return cfg


def _generators(patch):
    jg = JGenerator.from_config(_tiny(JConfig(), patch))
    object.__setattr__(jg.ts, "channel_base", CHANNEL_BASE)
    g = Generator.from_config(_tiny(Config(), patch))
    object.__setattr__(g.ts, "channel_base", CHANNEL_BASE)
    return jg, g


def _fields(seed, eng):
    """Fields made with numpy, in the engine's shapes."""
    rng = np.random.RandomState(seed)
    plan = eng.plan
    gl = rng.randn(eng.batch, 2, eng.g.ts.global_dim).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    z = rng.randn(eng.batch, plan.z_field_h, plan.z_field_w,
                  eng.g.ts.local_dim).astype(np.float32)
    noises = [rng.randn(eng.batch, h, w, 1).astype(np.float32)
              for h, w in plan.noise_sizes]
    return gl, z, noises


@pytest.mark.parametrize("h, w", [(192, 768), WIDE, (768, 1536)])
def test_close_loop_plan_p197_matches_jax(h, w):
    """The 197 plan's lattice, windows, crops and noise sizes, position
    for position, on the narrowest panorama, the engine test's and the
    cell's 768x1536."""
    jg, g = _generators(197)
    want, plan = jplan(jg, h, w), build_close_loop_plan(g, h, w)
    for f in ("num_steps_h", "num_steps_w", "num_steps_w_min", "meta_h",
              "meta_w", "window", "z_field_h", "z_field_w", "x_total",
              "y_total", "noise_sizes"):
        assert getattr(plan, f) == getattr(want, f), f
    assert plan.geom.pixelspace_step == want.geom.pixelspace_step == 192
    for f in ("z_starts", "img_starts", "cp_scalars"):
        np.testing.assert_array_equal(np.asarray(getattr(plan, f)),
                                      np.asarray(getattr(want, f)), f)


def test_close_loop_meta_p197_matches_jax():
    jg, g = _generators(197)
    jparams = jg.init(jax.random.PRNGKey(0))
    jeng = JEngine(g=jg, plan=jplan(jg, *WIDE), batch=2, patch_chunk=4,
                   grid_partial=0.6667, use_pallas=False,
                   use_skip_tables=True)
    gl, z, noises = _fields(3, jeng)
    want = np.asarray(jeng.generate_from_fields(jparams, gl, z, noises))

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, *WIDE),
                         batch=2, patch_chunk=4, grid_partial=0.6667,
                         device="cpu")
    assert g.ts.num_layers == 10 and len(params["ts"]["sp_convs"]) == 4
    assert eng._skip_margins == jeng._skip_margins
    got = eng.generate_from_fields(
        params, torch.tensor(gl), torch.tensor(z),
        [torch.tensor(n) for n in noises])
    assert tuple(got.shape) == want.shape == (2, 581, 1536, 3)
    assert float(np.abs(want).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
