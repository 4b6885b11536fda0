"""The training options of the port against the JAX package on the CPU:
the train_params fields, SGD and the lr schedule, the baseline transfer
and its freeze mask, the discriminator heads (coordinate AC, projection,
categorical), the extrapolated training grids, and steps_per_call.

The update rules are held at the level of the JAX functions the JAX step
composes (make_optimizers, lr_schedule_factor, and its mask_g / freeze_d
zeroing of the update after the optimizer, restated here as the step
writes them), so no second JAX training step is compiled; the port's
whole TrainStep with every option on runs a D + R1 + G step.

Tiny widths (channel_base 16, D channels 16, 1-2 SS layers, batch 4).
Tolerances: updates, lr factors and moments 1e-7 (float32 ops in the same
order), D heads 1e-5, extrapolated grids 1e-6; the baseline import, the
freeze and steps_per_call bit for bit."""
import dataclasses

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.compat.baseline import \
    import_torch_baseline_generator as jax_import_baseline
from spgan_tpu.compat.torch_import import export_torch_style_state_dict
from spgan_tpu.config import Config as JConfig
from spgan_tpu.config import load_config as jax_load_config
from spgan_tpu.geometry.coords import CoordGrid as JGrid
from spgan_tpu.models.discriminator import Discriminator as JD
from spgan_tpu.models.generator import Generator as JG
from spgan_tpu.train import state as jstate
from spgan_tpu_torch.compat.baseline import import_torch_baseline_generator
from spgan_tpu_torch.compat.from_jax import params_from_jax, params_to_jax
from spgan_tpu_torch.config import (UNPORTED_TRAIN_DEFAULTS, Config,
                                    TrainParams, load_config)
from spgan_tpu_torch.geometry.coords import CoordGrid
from spgan_tpu_torch.models.discriminator import Discriminator
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.train import loop
from spgan_tpu_torch.train import state as tstate
from spgan_tpu_torch.train.step import make_train_step
from spgan_tpu_torch.tree import flatten, tree_leaves, tree_map

B = 4
_SMALL = {k: 16 for k in (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)}
OPTION_FIELDS = ("optimizer", "lr_sch", "freeze", "coord_use_pd",
                 "coord_pd_w", "coord_pd_hori_only", "coord_ac_categorical",
                 "no_ext", "steps_per_call")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads (several test processes run side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, **train):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.batch_size = B
    tp.n_mlp = 1
    tp.ss_n_layers = 2
    for k, v in train.items():
        setattr(tp, k, v)
    return cfg


def _narrow(g=None, d=None):
    if g is not None:
        object.__setattr__(g.ts, "channel_base", 16)
    if d is not None:
        object.__setattr__(d, "channels", lambda: _SMALL)
        object.__setattr__(d, "linear_ch", 16)
    return g or d


# ----------------------------------------------------------------------
# config
# ----------------------------------------------------------------------

def test_option_fields_and_the_unported_table():
    jt, t = JConfig().train_params, TrainParams()
    for f in OPTION_FIELDS:
        assert getattr(t, f) == getattr(jt, f), f
    assert UNPORTED_TRAIN_DEFAULTS == {"pallas_train_sampler": "auto"}


def test_options_yaml_loads_as_jax_loads_it(tmp_path):
    p = tmp_path / "m.yaml"
    p.write_text("train_params:\n  optimizer: sgd\n  lr_sch: [8, 16]\n"
                 "  freeze: true\n  coord_use_pd: true\n  coord_pd_w: 0.5\n"
                 "  coord_pd_hori_only: true\n  coord_ac_categorical: true\n"
                 "  no_ext: false\n  steps_per_call: 4\n")
    got, want = load_config(str(p)), jax_load_config(str(p))
    for f in OPTION_FIELDS:
        assert getattr(got.train_params, f) == \
            getattr(want.train_params, f), f
    p.write_text("train_params:\n  pallas_train_sampler: 'on'\n")
    with pytest.raises(NotImplementedError, match="TPU"):
        load_config(str(p))


# ----------------------------------------------------------------------
# optimizers, the lr schedule, the freeze zeroing
# ----------------------------------------------------------------------

def _trees(seed):
    """(params, [grads of 2 steps]) as numpy trees; one leaf's second
    gradient is zero (a torch-Adam 'skipped' leaf)."""
    rng = np.random.RandomState(seed)

    def tree():
        return {"a": {"weight": rng.randn(3, 4).astype(np.float32)},
                "b": [rng.randn(5).astype(np.float32),
                      rng.randn(2, 2).astype(np.float32)]}

    params, g1, g2 = tree(), tree(), tree()
    g2["b"][0][:] = 0
    return params, [g1, g2]


_FROZEN = {"a": {"weight": True}, "b": [False, True]}


def _jax_update(opt, params, grads, state, frozen, factor):
    """The JAX step's update of one phase: the optimizer's update, zeroed on
    frozen leaves (mask_g / freeze_d), times the lr factor
    (scale_updates), applied with optax."""
    upd, state = opt.update(grads, state, params)
    if frozen is not None:
        upd = jax.tree_util.tree_map(
            lambda u, f: jnp.zeros_like(u) if f else u, upd, frozen)
    if factor is not None:
        upd = jax.tree_util.tree_map(lambda u: u * factor, upd)
    return optax.apply_updates(params, upd), state


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("frozen", [None, _FROZEN])
def test_updates_match_jax(optimizer, frozen):
    """Two G updates at steps 7 and 8 of lr_sch [8] (the factor 1, then
    0.5): the port's optimizer + apply_updates against JAX's; frozen leaves
    keep their value while Adam's moments still advance."""
    jcfg = _tiny(JConfig(), optimizer=optimizer, lr_sch=[8])
    cfg = _tiny(Config(), optimizer=optimizer, lr_sch=[8])
    jopt, opt = jstate.make_optimizers(jcfg)[0], \
        tstate.make_optimizers(cfg)[0]
    params, grads = _trees(0)
    jp, js = params, jopt.init(params)
    tp = tree_map(torch.tensor, params)
    ts = opt.init(tp)
    for step, g in zip((7, 8), grads):
        jp, js = _jax_update(jopt, jp, g, js, frozen,
                             jstate.lr_schedule_factor(jcfg, step))
        tp, ts = opt.step(tp, tree_map(torch.tensor, g), ts, frozen=frozen,
                          factor=tstate.lr_schedule_factor(cfg, step))
    for (k, a), (_, b) in zip(flatten(tp), flatten(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7, err_msg=k)
    if frozen is not None:
        for (k, a), (_, f), (_, p0) in zip(flatten(tp), flatten(frozen),
                                           flatten(params)):
            assert np.array_equal(a.numpy(), p0) == f, k
    if optimizer == "adam":
        for name in ("mu", "nu"):
            for a, b in zip(tree_leaves(getattr(ts, name)),
                            jax.tree_util.tree_leaves(getattr(js, name))):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=1e-7)
        assert [int(c) for c in tree_leaves(ts.count)] == \
            [int(c) for c in jax.tree_util.tree_leaves(js.count)] == \
            [2, 1, 2]
    else:
        assert dataclasses.fields(ts) == ()


def test_lr_schedule_factor_matches_jax():
    jcfg = _tiny(JConfig(), lr_sch=[3, 7])
    cfg = _tiny(Config(), lr_sch=[3, 7])
    got = [tstate.lr_schedule_factor(cfg, s) for s in (0, 2, 3, 4, 6, 7, 8)]
    want = [float(jstate.lr_schedule_factor(jcfg, s))
            for s in (0, 2, 3, 4, 6, 7, 8)]
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert got == [1.0, 1.0, 0.5, 0.5, 0.5, 0.25, 0.25]
    assert tstate.lr_schedule_factor(_tiny(Config()), 5) is None
    assert jstate.lr_schedule_factor(_tiny(JConfig()), 5) is None


# ----------------------------------------------------------------------
# baseline transfer
# ----------------------------------------------------------------------

def _baseline_state_dict(jg, params):
    """An InfinityGAN-baseline-shaped state dict: the SP-GAN export of
    `params` without the sphere convs, sphere skip convs and the first
    ToRGB, its planar convs moved from conv_stack.{2i+1} to .{i}, under
    DataParallel's "module." prefix."""
    sd = {}
    stack = "structure_synthesizer.implicit_model.conv_stack."
    for k, v in export_torch_style_state_dict(params_to_jax(params),
                                              jg).items():
        if "sp_convs" in k or "to_rgbs.0." in k:
            continue
        if k.startswith(stack):
            i, rest = k[len(stack):].split(".", 1)
            if int(i) % 2 == 0:
                continue
            k = f"{stack}{int(i) // 2}.{rest}"
        sd["module." + k] = v
    return sd


def _baseline_models():
    jg = _narrow(g=JG.from_config(_tiny(JConfig())))
    g = _narrow(g=Generator.from_config(_tiny(Config())))
    return jg, g


def test_baseline_import_matches_jax():
    jg, g = _baseline_models()
    template = g.init(torch.Generator().manual_seed(0), device="cpu")
    source = g.init(torch.Generator().manual_seed(1), device="cpu")
    sd = _baseline_state_dict(jg, source)
    params, mask = import_torch_baseline_generator(sd, g, template)
    jparams, jmask = jax_import_baseline(
        sd, jg, jax.tree_util.tree_map(jnp.asarray, params_to_jax(template)))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")
    assert [k for k, _ in flatten(params)] == [k for k, _ in flatten(want)]
    for (k, a), (_, b) in zip(flatten(params), flatten(want)):
        assert torch.equal(a, b), k
    assert dict(flatten(mask)) == dict(flatten(jmask))
    # loaded: the TS (but the first ToRGB) and the SS planar convs; kept:
    # the sphere convs, their 1x1 shortcuts, the skip convs, ToRGB 0
    m = dict(flatten(mask))
    assert m["ss/blocks/1/planar/conv/weight"] and m["ts/convs/0/act_bias"]
    assert not any(m[k] for k in m if "sphere" in k or "/sc/" in k
                   or "sp_convs" in k or k.startswith("ts/to_rgbs/0/"))
    for (k, a), (_, s), (_, t) in zip(flatten(params), flatten(source),
                                      flatten(template)):
        assert torch.equal(a, s if m[k] else t), k


# ----------------------------------------------------------------------
# discriminator heads
# ----------------------------------------------------------------------

@pytest.mark.parametrize("head", ["ac", "pd", "pd_hori", "categorical"])
def test_discriminator_heads_match_jax(head):
    """d_patch and ac_coords_pred at training time with labels, at a 37^2
    patch, and the R1 graph mask (the projection head is stepped)."""
    kw = dict(patch_size=37, channel_multiplier=1, batch_size=B,
              use_coord_ac=True, coord_num_dir=3, linear_ch=16)
    kw.update({"ac": {}, "pd": dict(use_coord_pd=True, coord_pd_w=0.7),
               "pd_hori": dict(use_coord_pd=True, coord_pd_w=0.7,
                               coord_pd_hori_only=True),
               "categorical": dict(coord_ac_categorical=True)}[head])
    jd, d = JD(**kw), Discriminator(**kw)
    for m in (jd, d):
        object.__setattr__(m, "channels", lambda: _SMALL)
    p = d.init(torch.Generator().manual_seed(2), device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_jax(p))
    rng = np.random.RandomState(5)
    img = rng.uniform(-1, 1, (B, 37, 37, 3)).astype(np.float32)
    ac = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    want = jd.apply(jp, jnp.asarray(img), ac_coords=jnp.asarray(ac),
                    train=True)
    got = d.apply(p, torch.tensor(img), ac_coords=torch.tensor(ac),
                  train=True)
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-5, err_msg=k)
    if head == "categorical":
        assert tuple(got["ac_coords_pred"].shape) == (B, 30)
    if head.startswith("pd"):
        plain = d.apply(p, torch.tensor(img))          # no head at test
        assert float((plain["d_patch"] - got["d_patch"]).abs().max()) > 1e-6
    assert dict(flatten(d.r1_graph_mask(p))) == \
        dict(flatten(jd.r1_graph_mask(jp)))


# ----------------------------------------------------------------------
# extrapolated grids
# ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [45, 65])
def test_sample_training_extrap_matches_jax(size):
    """The JAX draws taken apart (its splits and jax.random calls) and fed
    to the port's deterministic part."""
    jgrid, grid = JGrid(), CoordGrid()
    key = jax.random.PRNGKey(size)
    jc, jac, jcp = jgrid.sample_training_extrap(key, B, size)
    kx, ky, kp = jax.random.split(key, 3)
    x_st = jax.random.randint(kx, (B,), 0, jgrid.vert_sample_size)
    y_st = jax.random.randint(ky, (B,), 0, jgrid.size_y)
    jitter = ((jax.random.uniform(kp, (3,)) * 2.0 - 1.0)
              * jnp.asarray(jgrid.perturb_ranges()))
    c, ac, cp = grid.training_extrap_crops(
        torch.tensor(np.asarray(x_st)).long(),
        torch.tensor(np.asarray(y_st)).long(), torch.tensor(np.asarray(jitter)),
        size)
    assert tuple(c.shape) == jc.shape == (B, size, size, 3)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ac.numpy(), np.asarray(jac), atol=1e-6)
    for f in ("p_x_st", "p_x_ed", "p_y_st", "p_y_ed", "circular"):
        np.testing.assert_allclose(getattr(cp, f).float().numpy(),
                                   np.asarray(getattr(jcp, f), np.float32),
                                   atol=1e-7, err_msg=f)
    assert (cp.x_total, cp.y_total, cp.grid_partial) == \
        (jcp.x_total, jcp.y_total, jcp.grid_partial)


@pytest.mark.parametrize("patch, no_ext, want", [
    (101, True, []), (101, False, [2, 4]), (300, True, [2]),
    (300, False, [2]), (600, False, [])])
def test_ext_mult_list(patch, no_ext, want):
    """JAX loop.py's rule: [] above patch 512, [2] above 256, [] with
    no_ext, else [2, 4]; and the widened latents it asks for."""
    cfg = Config()
    cfg.train_params.patch_size, cfg.train_params.no_ext = patch, no_ext
    assert loop.ext_mult_list(cfg) == want
    from spgan_tpu.models.latents import LatentSampler as JSampler
    from spgan_tpu_torch.models.latents import LatentSampler
    for m in want:
        assert LatentSampler().local_shape(m) == JSampler().local_shape(m)
    assert LatentSampler().local_shape(2) == (45, 45)
    assert LatentSampler().local_shape(4) == (65, 65)


# ----------------------------------------------------------------------
# the whole step with every option; steps_per_call
# ----------------------------------------------------------------------

def _step_models(**train):
    cfg = _tiny(Config(), **train)
    g = _narrow(g=Generator.from_config(cfg))
    d = _narrow(d=Discriminator.from_config(cfg))
    state = tstate.create_train_state(cfg, g, d,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
    rng = np.random.RandomState(3)
    batches = [(torch.tensor(rng.uniform(-1, 1, (B, 101, 101, 3))
                             .astype(np.float32)),
                torch.tensor(rng.uniform(-1, 1, (B, 3)).astype(np.float32)))
               for _ in range(4)]
    return cfg, g, d, state, batches


def test_step_with_every_option_freezes():
    """SGD, lr_sch, the projection head, SS noise, ss_mapping and a
    baseline freeze mask in one D + R1 + G step: finite losses, the frozen
    G leaves and the whole D unchanged bit for bit, the others moved."""
    cfg, g, d, state, batches = _step_models(
        optimizer="sgd", lr_sch=[1], freeze=True, coord_use_pd=True,
        coord_pd_w=1.0, ss_disable_noise=False, ss_mapping=True)
    jg = _narrow(g=JG.from_config(_tiny(JConfig())))
    src = Generator.from_config(_tiny(Config()))
    object.__setattr__(src.ts, "channel_base", 16)
    sd = _baseline_state_dict(jg, src.init(torch.Generator().manual_seed(1),
                                           device="cpu"))
    state.params_g, mask = import_torch_baseline_generator(sd, g,
                                                           state.params_g)
    assert "coord_proj" in state.params_d
    assert "mapping" in state.params_g["ss"]
    step = make_train_step(cfg, g, d, freeze_g_mask=mask)
    s1, m = step(state, *batches[0], torch.Generator().manual_seed(4),
                 do_r1=True, do_ppl=False)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["r1"]) > 0
    for (k, a), (_, b) in zip(flatten(s1.params_d), flatten(state.params_d)):
        assert torch.equal(a, b), k
    moved = 0
    for (k, a), (_, b), (_, f) in zip(flatten(s1.params_g),
                                      flatten(state.params_g),
                                      flatten(mask)):
        if f:
            assert torch.equal(a, b), k
        moved += not torch.equal(a, b)
    assert moved > 0 and s1.step == 1


def test_steps_per_call_equals_single_steps(tmp_path, monkeypatch):
    """The loop over iterations 0-3 (R1 at 0 and 2, PPL at 0 only) with
    steps_per_call 4 ends in the state steps_per_call 1 ends in, bit for
    bit; its one log line (at 4) reports the last step's metrics with r1
    carried from step 2 and path / path_lengths from step 0, as
    steps_per_call 1's does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(loop, "_open_writer", lambda root: None)
    runs = {}
    for k in (1, 4):
        cfg, g, d, state, batches = _step_models(
            d_reg_every=2, g_reg_every=4, g_path_start=0, steps_per_call=k,
            iter=4)
        cfg.exp_name = f"k{k}"
        cfg.log_params.log_tick = 4
        cfg.log_params.save_tick = cfg.log_params.img_tick = 1000
        cfg.test_params.calc_fid = False
        per_step, logged = [], []
        feed = iter([{"patch": p.numpy(), "ac_coords": a.numpy()}
                     for p, a in batches])

        def recording(*a, g=g, d=d, cfg=cfg, per_step=per_step, **kw):
            step = make_train_step(cfg, g, d)

            def one(*args, **kwargs):
                s, m = step(*args, **kwargs)
                per_step.append(m)
                return s, m
            return one

        class Pipe:
            def __next__(self, feed=feed):
                return next(feed)

            def close(self):
                pass

        monkeypatch.setattr(loop, "create_train_state",
                            lambda *a, state=state, **kw: state)
        monkeypatch.setattr(loop, "make_train_step", recording)
        monkeypatch.setattr(loop, "make_train_pipeline",
                            lambda c, seed=0, pipe=Pipe(): pipe)
        monkeypatch.setattr(
            loop, "_log_tick",
            lambda w, it, total, scalars, *a, logged=logged:
            logged.append((it, scalars)))
        runs[k] = loop.train(cfg, device="cpu"), per_step, logged
    (s1, _, log1), (s4, per_step, log4) = runs[1], runs[4]
    assert s4.step == s1.step == 4 and len(per_step) == 4
    for name in ("params_g", "params_d", "params_g_ema"):
        for (key, a), (_, b) in zip(flatten(getattr(s4, name)),
                                    flatten(getattr(s1, name))):
            assert torch.equal(a, b), (name, key)
    for name in ("mu", "nu", "count"):
        for a, b in zip(tree_leaves(getattr(s4.opt_g, name)),
                        tree_leaves(getattr(s1.opt_g, name))):
            assert torch.equal(a, b)
    assert torch.equal(s4.mean_path_length, s1.mean_path_length)
    assert [it for it, _ in log1] == [it for it, _ in log4] == [4]
    m1, m4 = log1[0][1], log4[0][1]
    assert m4.keys() == m1.keys()
    src = {"r1": 2, "path": 0, "path_lengths": 0}
    for key in m4:
        assert torch.equal(m4[key], per_step[src.get(key, 3)][key]), key
        assert torch.equal(m4[key], m1[key]), key
    assert float(m4["path"]) > 0 and float(per_step[3]["path"]) == 0
    assert float(m4["r1"]) > 0 and float(per_step[3]["r1"]) == 0


def test_loop_ticks_with_steps_per_call(tmp_path, monkeypatch, capsys):
    """steps_per_call 4 over 10 iterations: calls end at 4, 8 and 10 (the
    last takes 2); the log (every 3) and save (every 5) ticks fire where a
    call crosses their multiple, as crossed_tick says."""
    monkeypatch.chdir(tmp_path)
    cfg = _tiny(Config(), steps_per_call=4, iter=10)
    cfg.log_params.log_tick, cfg.log_params.save_tick = 3, 5
    cfg.log_params.img_tick = 1000
    cfg.test_params.calc_fid = False
    calls = []

    def fake_state(*a, **k):
        t = torch.zeros(2)
        return tstate.TrainState(
            step=0, params_g={"w": t}, params_d={"w": t},
            params_g_ema={"w": t}, opt_g=tstate.SGDState(),
            opt_d=tstate.SGDState(), mean_path_length=torch.zeros(()))

    def metrics():
        return {k: torch.zeros(()) for k in ("loss", "r1", "path",
                                             "path_lengths")}

    def fake_one(*a, **k):
        def one(state, patch, ac, gen, do_r1, do_ppl):
            calls.append(1)
            return dataclasses.replace(state, step=state.step + 1), metrics()
        return one

    batch = {"patch": np.zeros((B, 101, 101, 3), np.float32),
             "ac_coords": np.zeros((B, 3), np.float32)}

    class Pipe:
        def __next__(self):
            return batch

        def close(self):
            pass

    monkeypatch.setattr(loop, "_open_writer", lambda root: None)
    monkeypatch.setattr(loop, "create_train_state", fake_state)
    monkeypatch.setattr(loop, "make_train_step", fake_one)
    monkeypatch.setattr(loop, "make_train_pipeline", lambda c, seed=0: Pipe())
    state = loop.train(cfg, device="cpu")
    assert state.step == 10 and calls == [1] * 10
    logged = [int(line.split()[2].split("/")[0])
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("[train] iter")]
    want = [it for it, adv in ((4, 4), (8, 4), (10, 2))
            if loop.crossed_tick(it, adv, 3)]
    assert logged == want == [4, 8, 10]
    from spgan_tpu_torch.train.checkpoint import CheckpointManager
    assert CheckpointManager("logs/spgan/ckpt").steps() == [8, 10]
