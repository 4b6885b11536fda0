"""The port's close-loop panorama engine (spgan_tpu_torch/infer) against
the JAX package's, on the tiny config of tests/test_engine_pallas.py, the
same weights (compat/from_jax.py) and the same injected fields.

The JAX reference is PanoramaEngine(use_pallas=False,
use_skip_tables=True): the plain (XLA) form of its kernel path.  The port
on the CPU runs the kernel's plain version; both are float32, so the meta
images agree to summation-order noise: atol 2e-4, as the JAX package's own
engine tests use."""
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


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    return cfg


def _port_generator():
    g = Generator.from_config(_tiny(Config()))
    object.__setattr__(g.ts, "channel_base", 48)
    return g


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


def _torch(gl, z, noises):
    return (torch.tensor(gl), torch.tensor(z),
            [torch.tensor(n) for n in noises])


@pytest.mark.heavy
def test_close_loop_meta_matches_jax():
    jg = JGenerator.from_config(_tiny(JConfig()))
    object.__setattr__(jg.ts, "channel_base", 48)
    jparams = jg.init(jax.random.PRNGKey(0))
    jeng = JEngine(g=jg, plan=jplan(jg, 128, 672), batch=2, patch_chunk=4,
                   grid_partial=0.6667, use_pallas=False, use_skip_tables=True)
    gl, z, noises = _fields(3, jeng)
    want = np.asarray(jeng.generate_from_fields(jparams, gl, z, noises))

    g = _port_generator()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, 128, 672),
                         batch=2, patch_chunk=4, grid_partial=0.6667,
                         device="cpu")
    assert eng._skip_margins == jeng._skip_margins
    got = eng.generate_from_fields(params, *_torch(gl, z, noises))
    assert tuple(got.shape) == want.shape == (2, 389, 672, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_wrap_columns_bit_identical():
    """Rendering every lattice column (no dedup), the wrap columns 7, 8 are
    bit-identical to base columns 0, 1 (same windows, same crop
    descriptor), so the dedup engine's meta image equals the full
    render's exactly."""
    g = _port_generator()
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    plan = build_close_loop_plan(g, 128, 672)
    # chunk 4 divides both 28 rendered and 36 full positions: identical
    # folded-batch shapes in both engines
    full = PanoramaEngine(g=g, plan=plan, batch=2, patch_chunk=4,
                          grid_partial=0.6667, dedup_wrap=False, device="cpu")
    dedup = PanoramaEngine(g=g, plan=plan, batch=2, patch_chunk=4,
                           grid_partial=0.6667, device="cpu")
    assert dedup._wrap_cols_dedupable()
    assert len(dedup._render_idx) == 28 and len(full._render_idx) == 36
    fields = _torch(*_fields(7, full))
    patches = full.generate_patches(params, *fields)
    patches = patches.reshape(plan.num_steps_h, plan.num_steps_w,
                              *patches.shape[1:])
    assert torch.equal(patches[:, 7], patches[:, 0])
    assert torch.equal(patches[:, 8], patches[:, 1])
    meta_full = full.generate_from_fields(params, *fields)
    meta_dedup = dedup.generate_from_fields(params, *fields)
    assert torch.equal(meta_full, meta_dedup)
    # the last row's final wrap column writes cols 768..869 % 672
    r = (plan.num_steps_h - 1) * plan.geom.pixelspace_step
    assert torch.equal(meta_dedup[:, r:r + 101, 96:197], patches[-1, 8])


def test_close_loop_plan_matches_jax():
    """The shipped 384x768 task: 6x10 lattice, meta 581x768, z field
    65x48, identical to the JAX plan position for position."""
    plan = build_close_loop_plan(Generator.from_config(Config()), 384, 768)
    want = jplan(JGenerator.from_config(JConfig()), 384, 768)
    assert (plan.num_steps_h, plan.num_steps_w, plan.meta_h, plan.meta_w) == (
        6, 10, 581, 768)
    for f in ("num_steps_w_min", "window", "z_field_h", "z_field_w",
              "x_total", "y_total", "noise_sizes"):
        assert getattr(plan, f) == getattr(want, f), f
    for f in ("z_starts", "img_starts", "cp_scalars"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(want, f))
    for a, b in zip(plan.noise_starts, want.noise_starts):
        np.testing.assert_array_equal(a, b)
