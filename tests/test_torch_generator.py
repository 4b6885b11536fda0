"""The port's generator (spgan_tpu_torch/models/generator.py) against the
JAX package's on the same weights, carried across by compat/from_jax.py
from the flat keys that spgan_tpu's save_params_npz writes.

One 101^2 patch forward of a tiny config at test-time crops of a lattice
plan.  The JAX side runs its default gather path (grid sample + stride-3
conv); the port runs the row-offset tables (the sphere-conv kernel's plain
version and the tap conv) -- the same function, so agreement is float32
noise: atol 2e-4 on O(1) pixels, as the JAX package's own tables-vs-gather
tests use."""
import numpy as np
import pytest
import jax
import torch

from spgan_tpu.compat.load import save_params_npz
from spgan_tpu.config import Config as JConfig
from spgan_tpu.geometry.coords import CoordsPartial as JCP
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu_torch.compat.from_jax import params_from_jax
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.geometry.coords import CoordsPartial
from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.ops.spatial import out_size_chain


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    return cfg


def _generators():
    jg = JGenerator.from_config(_tiny(JConfig()))
    object.__setattr__(jg.ts, "channel_base", 48)
    g = Generator.from_config(_tiny(Config()))
    object.__setattr__(g.ts, "channel_base", 48)
    return jg, g


@pytest.mark.heavy
def test_patch_forward_matches_jax(tmp_path):
    jg, g = _generators()
    jparams = jg.init(jax.random.PRNGKey(0))
    save_params_npz(str(tmp_path / "g.npz"), jparams)
    params = params_from_jax(np.load(tmp_path / "g.npz"), device="cpu")

    plan = build_close_loop_plan(g, 128, 672)
    B, win = 3, plan.window
    pos = np.array([0, 10, 30])        # incl. a wrapping (circular) crop
    cps = plan.cp_scalars[pos]
    field = g.ss.coord_grid.test_field(plan.z_field_h, plan.z_field_w)
    field = np.concatenate([field, field[:, :win]], axis=1)
    coords = np.stack([field[r:r + win, c:c + win]
                       for r, c in plan.z_starts[pos]])
    rng = np.random.RandomState(0)
    gl = rng.randn(B, 2, 32).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    z = rng.randn(B, win, win, 16).astype(np.float32)
    noises = [rng.randn(B, s, s, 1).astype(np.float32)
              for s in out_size_chain(g.ts.conv_specs_spatial(), 11)]

    jcp = JCP(p_x_st=cps[:, 0].astype(np.float32),
              p_x_ed=cps[:, 1].astype(np.float32),
              p_y_st=cps[:, 2].astype(np.float32),
              p_y_ed=cps[:, 3].astype(np.float32),
              circular=cps[:, 4].astype(np.float32),
              x_total=plan.x_total, y_total=plan.y_total,
              grid_partial=0.6667, test_flag=True)
    fwd = jax.jit(lambda p, gl, z, c, cp, n: jg.apply(
        p, global_latent=gl, local_latent=z, coords=c, cp=cp, noises=n)["gen"])
    want = np.asarray(fwd(jparams, gl, z, coords, jcp, noises))
    cp = CoordsPartial.from_scalars(cps, plan.x_total, plan.y_total, 0.6667)
    got = g.apply(params, global_latent=torch.tensor(gl),
                  local_latent=torch.tensor(z), coords=torch.tensor(coords),
                  cp=cp, noises=[torch.tensor(n) for n in noises])["gen"]
    assert tuple(got.shape) == want.shape == (B, 101, 101, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_init_tree_matches_jax_and_nested_equals_flat():
    """The port's random init has exactly the JAX tree (keys, leaves,
    shapes after the layout change), with the JAX init rules that are not
    random: identity sphere weights, modulation bias 1, zero noise."""
    jg, g = _generators()
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jg.init(jax.random.PRNGKey(0)))
    nested = params_from_jax(jparams, device="cpu")
    flat = params_from_jax(
        {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
         for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]},
        device="cpu")
    own = g.init(torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(own) == _shapes(nested) == _shapes(flat)
    for a, b in zip(jax.tree_util.tree_leaves(nested),
                    jax.tree_util.tree_leaves(flat)):
        assert torch.equal(a, b)
    sphere = own["ss"]["blocks"][0]["sphere"]["conv"]
    w = sphere["weight"]
    assert torch.equal(w[:, :, 1, 1], torch.ones_like(w[:, :, 1, 1]))
    assert float(w.abs().sum()) == w.shape[0] * w.shape[1]
    assert torch.equal(sphere["modulation"]["bias"],
                       torch.ones_like(sphere["modulation"]["bias"]))
    assert float(own["ts"]["convs"][0]["noise"]["weight"]) == 0.0
