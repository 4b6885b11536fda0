"""The port's training slice against the JAX package on the CPU: the
discriminator and R1, the torch-Adam semantics, EMA, training crops, the
patch cropper, the state carried across by compat/from_jax.py, the loop's
cadence, and the whole training step (every G forward, loss and update of
one D + R1 + G + PPL + EMA step) against JAX's
real make_train_step (pallas_train_sampler="on", the Pallas sampler in
interpret mode), fed the draws JAX makes from the same key.

Tiny widths (channel_base 16, D channels 16, 1 SS layer, batch 4).
Tolerances: forwards 1e-4 on O(1) values (float32 sums in another order);
R1 and gradients relative to their scale; the whole step as
tests/test_train_step.py holds JAX's own sampler against its gather path:
losses rtol 2e-4, the PPL penalty rtol 5e-2 (quadratic in tiny path
lengths), params after the step max |d| < 0.01 and < 0.5% of elements
beyond 5e-4 (Adam's first step normalizes g/|g|, so float noise on
near-zero gradients flips single updates by 2*lr)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.config import Config as JConfig
from spgan_tpu.data.pipeline import PatchCropper as JCropper
from spgan_tpu.models import losses as jlosses
from spgan_tpu.models.discriminator import Discriminator as JD
from spgan_tpu.models.generator import Generator as JG
from spgan_tpu.models.latents import LatentSampler as JSampler
from spgan_tpu.ops.spatial import out_size_chain
from spgan_tpu.train import state as jstate
from spgan_tpu.train.step import make_train_step as jmake_step
from spgan_tpu.train.step import training_sampler_plan
from spgan_tpu_torch.compat.from_jax import params_from_jax, train_state_from_jax
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.data.pipeline import PatchCropper, TrainPipeline
from spgan_tpu_torch.models import losses
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.train import state as tstate
from spgan_tpu_torch.train.step import GDraws, StepDraws, make_train_step
from spgan_tpu_torch.tree import tree_leaves

B = 4
_SMALL = {k: 16 for k in (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)}


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.batch_size = B
    tp.n_mlp = 1
    tp.ss_n_layers = 1
    tp.path_batch_shrink = 2
    return cfg


def _models():
    """(JAX cfg, G, D) and (port cfg, G, D) at the same tiny widths."""
    jcfg = _tiny(JConfig())
    jcfg.train_params.pallas_train_sampler = "on"
    cfg = _tiny(Config())
    jg, g = JG.from_config(jcfg), Generator.from_config(cfg)
    jd = JD(patch_size=101, channel_multiplier=1, batch_size=B,
            use_coord_ac=True, coord_num_dir=3, linear_ch=16)
    d = Discriminator(patch_size=101, channel_multiplier=1, batch_size=B,
                      use_coord_ac=True, coord_num_dir=3, linear_ch=16)
    for m in (jg.ts, g.ts):
        object.__setattr__(m, "channel_base", 16)
    for m in (jd, d):
        object.__setattr__(m, "channels", lambda: _SMALL)
    return (jcfg, jg, jd), (cfg, g, d)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_to_scale(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-12)


# ----------------------------------------------------------------------
# JAX's draws, rebuilt from the step key in _build_step's order
# ----------------------------------------------------------------------

def _jax_g_draws(jg, jcfg, key, bsz):
    """sample_g_inputs(key, bsz) of spgan_tpu/train/step.py, taken apart:
    the same splits and the same jax.random calls."""
    tp = jcfg.train_params
    sampler = JSampler(global_dim=tp.global_latent_dim,
                       local_dim=tp.local_latent_dim,
                       ts_input_size=tp.ts_input_size,
                       ss_unfold_size=tp.ss_unfold_size, mixing=tp.mixing)
    grid = jg.ss.coord_grid
    kgl, kll, kc, kidx, kn = jax.random.split(key, 5)
    kx, ky, kp = jax.random.split(kc, 3)
    jitter = ((jax.random.uniform(kp, (3,)) * 2.0 - 1.0)
              * jnp.asarray(grid.perturb_ranges()))
    sizes = out_size_chain(jg.ts.conv_specs_spatial(), tp.ts_input_size)
    return dict(
        gl=sampler.sample_global(kgl, bsz), ll=sampler.sample_local(kll, bsz),
        x_st=jax.random.randint(kx, (bsz,), 0, grid.vert_sample_size),
        y_st=jax.random.randint(ky, (bsz,), 0, grid.size_y), jitter=jitter,
        inject=jax.random.randint(kidx, (), 1, jg.ts.n_latent),
        noises=[jax.random.normal(jax.random.fold_in(kn, i), (bsz, s, s, 1))
                for i, s in enumerate(sizes)])


def _to_port(dr):
    t = {k: torch.tensor(np.asarray(v)) for k, v in dr.items()
         if k != "noises"}
    return GDraws(gl=t["gl"], ll=t["ll"], x_st=t["x_st"].long(),
                  y_st=t["y_st"].long(), jitter=t["jitter"],
                  inject=t["inject"].long(),
                  noises=[torch.tensor(np.asarray(n)) for n in dr["noises"]])


def _jax_step_draws(jg, jcfg, base_key, step, do_ppl):
    key = jax.random.fold_in(base_key, step)
    k_dfake, k_gfake, k_ppl = jax.random.split(key, 3)
    dr = StepDraws(d=_to_port(_jax_g_draws(jg, jcfg, k_dfake, B)),
                   g=_to_port(_jax_g_draws(jg, jcfg, k_gfake, B)))
    if do_ppl:
        pb = B // jcfg.train_params.path_batch_shrink
        dr.ppl = _to_port(_jax_g_draws(jg, jcfg, k_ppl, pb))
        dr.ppl_noise = torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(k_ppl, 1), (pb, 101, 101, 3))))
    return dr


@pytest.fixture(scope="module")
def jax_step():
    """One D + R1 + G + PPL + EMA step of JAX's real training step."""
    (jcfg, jg, jd), port = _models()
    state0 = jstate.create_train_state(jcfg, jg, jd, jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    patch = rng.randn(B, 101, 101, 3).astype(np.float32)
    ac = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    s1, m = jmake_step(jcfg, jg, jd)(state0, jnp.asarray(patch),
                                     jnp.asarray(ac), key, do_r1=True,
                                     do_ppl=True)
    return dict(jax=(jcfg, jg, jd), port=port, state0=state0, s1=s1,
                metrics={k: float(v) for k, v in m.items()}, patch=patch,
                ac=ac, key=key)


def test_whole_step_matches_jax(jax_step):
    (jcfg, jg, _), (cfg, g, d) = jax_step["jax"], jax_step["port"]
    draws = _jax_step_draws(jg, jcfg, jax_step["key"], 0, do_ppl=True)
    step = make_train_step(cfg, g, d, draw=lambda gen, do_ppl: draws)
    s0 = train_state_from_jax(jax_step["state0"], device="cpu")
    s1, m = step(s0, torch.tensor(jax_step["patch"]),
                 torch.tensor(jax_step["ac"]), None, do_r1=True, do_ppl=True)
    want = jax_step["metrics"]
    assert set(m) == set(want)
    for k, v in want.items():
        got = float(m[k])
        if k in ("path", "path_lengths", "mean_path_length"):
            np.testing.assert_allclose(got, v, rtol=5e-2, atol=1e-6, err_msg=k)
        elif not k.startswith("grad_norm"):
            np.testing.assert_allclose(got, v, rtol=2e-4, err_msg=k)
        else:   # sums of squares of every gradient element
            np.testing.assert_allclose(got, v, rtol=2e-3, err_msg=k)
    assert s1.step == 1
    want_s1 = train_state_from_jax(jax_step["s1"], device="cpu")
    for name in ("params_g", "params_d", "params_g_ema"):
        tot = bad = 0
        for a, b in zip(tree_leaves(getattr(s1, name)),
                        tree_leaves(getattr(want_s1, name))):
            diff = (a - b).abs()
            tot += diff.numel()
            bad += int((diff > 5e-4).sum())
            assert float(diff.max()) < 0.01, name
        assert bad / tot < 0.005, f"{name}: {bad}/{tot} params diverged"
    # the Adam counts: every G leaf stepped twice (G + PPL) unless its PPL
    # gradient is identically zero; D: 2 (D + R1) except the AC head (1)
    for (k, v), (_, w) in zip(s1.opt_d.count.items(),
                              want_s1.opt_d.count.items()):
        assert [int(c) for c in tree_leaves(v)] == \
            [int(c) for c in tree_leaves(w)], k
    assert ([int(c) for c in tree_leaves(s1.opt_g.count)]
            == [int(c) for c in tree_leaves(want_s1.opt_g.count)])


def test_train_state_from_jax(jax_step):
    """A JAX TrainState after one step (non-zero moments, per-leaf counts)
    carried across: the port's tree shapes, HWIO -> OIHW and (in,out) ->
    (out,in) on params and moments alike, counts as int32."""
    (_, jg, jd), (cfg, g, d) = jax_step["jax"], jax_step["port"]
    js1 = jax_step["s1"]
    s = train_state_from_jax(js1, device="cpu")
    own = tstate.create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                                    device="cpu")

    def shapes(tree):
        return sorted((tuple(t.shape) for t in tree_leaves(tree)))

    for name in ("params_g", "params_d", "params_g_ema"):
        assert shapes(getattr(s, name)) == shapes(getattr(own, name))
    for opt in ("opt_g", "opt_d"):
        st, jst = getattr(s, opt), getattr(js1, opt)
        params = s.params_g if opt == "opt_g" else s.params_d
        assert shapes(st.mu) == shapes(st.nu) == shapes(params)
        assert all(c.dtype == torch.int32 and c.ndim == 0
                   for c in tree_leaves(st.count))
        assert sorted(int(c) for c in tree_leaves(st.count)) == sorted(
            int(c) for c in jax.tree_util.tree_leaves(jst.count))
    w = np.asarray(js1.opt_d.mu["final_conv"]["conv"]["weight"])   # HWIO
    np.testing.assert_array_equal(
        s.opt_d.mu["final_conv"]["conv"]["weight"].numpy(),
        w.transpose(3, 2, 0, 1))
    lin = np.asarray(js1.params_d["coord_linear"][0]["weight"])   # (in,out)
    np.testing.assert_array_equal(
        s.params_d["coord_linear"][0]["weight"].numpy(), lin.T)
    assert s.step == 1
    np.testing.assert_allclose(float(s.mean_path_length),
                               float(js1.mean_path_length))


# ----------------------------------------------------------------------
# Pieces
# ----------------------------------------------------------------------

def test_discriminator_and_r1_match_jax():
    """Every D layer kind (stem, ResBlocks with blur-downsample, stddev,
    final conv, NCHW flatten, both heads) at a 37^2 patch (3 ResBlocks),
    and R1's value and double-grad gradients."""
    (_, _, jd), (_, _, d) = _models()
    jd, d = (type(m)(patch_size=37, channel_multiplier=1, batch_size=B,
                     use_coord_ac=True, coord_num_dir=3, linear_ch=16)
             for m in (jd, d))
    for m in (jd, d):
        object.__setattr__(m, "channels", lambda: _SMALL)
    jp = jd.init(jax.random.PRNGKey(1))
    p = params_from_jax(_np(jp), device="cpu")
    rng = np.random.RandomState(4)
    img = rng.randn(B, 37, 37, 3).astype(np.float32)
    want = jax.jit(lambda q, x: jd.apply(q, x, train=True))(
        jp, jnp.asarray(img))
    got = d.apply(p, torch.tensor(img))
    for k in ("d_patch", "ac_coords_pred"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4, rtol=1e-4)
    r1_j, g_j = jax.jit(jax.value_and_grad(
        lambda q: jlosses.d_r1_penalty(jd.apply, q, jnp.asarray(img),
                                       train=True)))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
    r1_t = losses.d_r1_penalty(d.apply, p, torch.tensor(img))
    np.testing.assert_allclose(float(r1_t.detach()), float(r1_j), rtol=1e-4)
    g_t = torch.autograd.grad(r1_t, leaves, allow_unused=True)
    g_j = params_from_jax(_np(g_j), device="cpu")
    for a, b in zip(g_t, tree_leaves(g_j)):
        if a is None:   # the AC head is outside the d_patch graph
            assert float(b.abs().max()) == 0.0
        else:
            assert _rel_to_scale(a.numpy(), b.numpy()) < 1e-3
    assert d.r1_graph_mask(p)["coord_linear"] == [
        {"weight": False, "bias": False}] * 2


def test_torch_adam_matches_jax():
    """Per-leaf lazy state: an active leaf, a leaf without gradient
    (skipped), a zero gradient stepped by the mask, a leaf masked off."""
    rng = np.random.RandomState(5)
    shapes = {"w": (7, 5), "b": (5,), "head": (3,)}
    lr, b1, b2 = 0.002 * 4 / 5, 0.0 ** 0.8, 0.99 ** 0.8
    jopt = jstate.torch_adam(lr, b1, b2)
    topt = tstate.TorchAdam(lr, b1, b2)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jp, jst = {k: jnp.asarray(v) for k, v in p0.items()}, None
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        tg = {k: torch.tensor(v) for k, v in g.items()}
        active = None
        if step == 1:           # head outside the graph: None in torch
            g["head"] = np.zeros_like(g["head"])
            tg["head"] = None
        if step == 2:           # in the graph with a zero grad, head masked
            g["b"] = np.zeros_like(g["b"])
            tg["b"] = torch.zeros(5)
            active = {"w": True, "b": True, "head": False}
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp, active=active)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        tp, tst = topt.step(tp, tg, tst, active=active)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} leaf {k}")
            assert int(tst.count[k]) == int(jst.count[k])


def test_ema_matches_jax():
    rng = np.random.RandomState(6)
    e = {"a": [rng.randn(3, 4).astype(np.float32)], "b": rng.randn(2)
         .astype(np.float32)}
    p = {"a": [rng.randn(3, 4).astype(np.float32)], "b": rng.randn(2)
         .astype(np.float32)}
    want = jstate.ema_update(e, p)
    got = tstate.ema_update(
        {"a": [torch.tensor(e["a"][0])], "b": torch.tensor(e["b"])},
        {"a": [torch.tensor(p["a"][0])], "b": torch.tensor(p["b"])})
    assert tstate.EMA_ACCUM == jstate.EMA_ACCUM
    np.testing.assert_allclose(got["a"][0].numpy(), np.asarray(want["a"][0]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                               rtol=1e-6)


def test_sample_training_matches_jax():
    """JAX's crops, jitter, ac labels and crop descriptors from the origins
    and jitter JAX draws; the port's own draws are in range."""
    (jcfg, jg, _), (_, g, _) = _models()
    key = jax.random.PRNGKey(11)
    coords_j, ac_j, cp_j = jg.ss.coord_grid.sample_training(
        jax.random.split(key, 5)[2], 8)
    dr = _to_port(_jax_g_draws(jg, jcfg, key, 8))
    coords, ac, cp = g.ss.coord_grid.training_crops(dr.x_st, dr.y_st,
                                                    dr.jitter)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(coords_j))
    np.testing.assert_allclose(ac.numpy(), np.asarray(ac_j), atol=1e-6)
    for f in ("p_x_st", "p_x_ed", "p_y_st", "p_y_ed"):
        np.testing.assert_array_equal(getattr(cp, f).numpy(),
                                      np.asarray(getattr(cp_j, f)), err_msg=f)
    np.testing.assert_array_equal(cp.circular.numpy(),
                                  np.asarray(cp_j.circular, np.float32))
    assert (cp.x_total, cp.y_total, cp.grid_partial) == (
        cp_j.x_total, cp_j.y_total, 0.8)
    np.testing.assert_array_equal(g.ss.coord_grid.perturb_ranges(),
                                  jg.ss.coord_grid.perturb_ranges())
    c2, ac2, _ = g.ss.coord_grid.sample_training(
        torch.Generator().manual_seed(0), 16)
    size = g.ss.coord_grid.ss_spatial_size
    assert tuple(c2.shape) == (16, size, size, 3)
    assert tuple(ac2.shape) == (16, 3)
    assert g.training_skip_margins() == training_sampler_plan(jcfg, jg)[2]


def test_patch_cropper_and_pipeline():
    img = np.random.RandomState(7).randint(0, 255, (197, 197, 3), np.uint8)
    for seed in range(3):
        p_t, a_t = PatchCropper(197, 101)(img, np.random.RandomState(seed))
        p_j, a_j = JCropper(197, 101)(img, np.random.RandomState(seed))
        np.testing.assert_array_equal(p_t, p_j)
        np.testing.assert_array_equal(a_t, a_j)
    cfg = Config()
    cfg.train_params.batch_size = 2
    batch = next(TrainPipeline(cfg, seed=0))
    assert batch["patch"].shape == (2, 101, 101, 3)
    assert batch["patch"].dtype == np.float32
    assert -1.0 <= batch["patch"].min() and batch["patch"].max() <= 1.0
    assert batch["ac_coords"].shape == (2, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_sets_tf32_for_compute_dtype(monkeypatch, tmp_path, dtype):
    """train() turns TF32 off for cuDNN and cuBLAS when it computes in
    float32, and leaves the flags as they were for bfloat16."""
    from spgan_tpu_torch.train import loop

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.chdir(tmp_path)
    _, (cfg, g, d) = _models()
    cfg.train_params.compute_dtype = dtype
    monkeypatch.setattr(Generator, "from_config", lambda c: g)
    monkeypatch.setattr(Discriminator, "from_config", lambda c: d)
    state = loop.train(cfg, max_iters=0, device="cpu")
    assert state.step == 0
    want = dtype != "float32"
    assert torch.backends.cudnn.allow_tf32 is want
    assert torch.backends.cuda.matmul.allow_tf32 is want


def test_training_after_inference_in_one_process():
    """A G forward under inference_mode (the panorama engine) and then a
    training step in the same process: nothing cached by the first (the
    upfirdn FIR weights) may be an inference tensor."""
    _, (cfg, g, d) = _models()
    state = tstate.create_train_state(cfg, g, d,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
    step = make_train_step(cfg, g, d)
    with torch.inference_mode():
        step.g_forward(state.params_g, step.draw_g(
            torch.Generator().manual_seed(1), B), False)
    grads, m = step.g_grads(state.params_g, state.params_d, step.draw_g(
        torch.Generator().manual_seed(2), B))
    assert torch.isfinite(m["g_total_loss"])
    assert all(t is None or bool(torch.isfinite(t).all()) for t in grads)


def test_train_loop_cadence_on_cpu(monkeypatch, tmp_path, capsys):
    """train(): iterations with the JAX cadence (R1 at it % d_reg_every ==
    0, PPL at it % g_reg_every == 0 from g_path_start) on the CPU."""
    from spgan_tpu_torch.train import loop

    monkeypatch.chdir(tmp_path)
    _, (cfg, g, d) = _models()
    tp = cfg.train_params
    tp.d_reg_every, tp.g_reg_every, tp.g_path_start = 2, 3, 1
    cfg.log_params.log_tick = 2
    monkeypatch.setattr(Generator, "from_config", lambda c: g)
    monkeypatch.setattr(Discriminator, "from_config", lambda c: d)
    calls = []
    real_step = loop.make_train_step

    def spy(*a, **kw):
        step = real_step(*a, **kw)
        inner = step.__call__

        def call(*args, **kwargs):
            calls.append((kwargs["do_r1"], kwargs["do_ppl"]))
            return inner(*args, **kwargs)

        return call

    monkeypatch.setattr(loop, "make_train_step", spy)
    state = loop.train(cfg, max_iters=4, device="cpu")
    assert state.step == 4
    assert calls == [(True, False), (False, False), (True, False),
                     (False, True)]
    out = capsys.readouterr().out
    assert "[train] iter 4/4" in out and "nan" not in out
