"""The training step on the card: the phases of a tiny step on cuda (the
kernels) against the same phases on cpu (the plain versions), the
launches of the hand-written kernels per plain and R1+PPL step at the
shipped widths, no per-channel convolution loop in the double backward,
and the data-parallel step over NCCL in a world of one.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_train_card.py

Skips without a CUDA device."""
import dataclasses

import numpy as np
import pytest
import torch

from helpers.card import Launches, needs_card, no_tf32, only, tiny_config

# upfirdn2d launches: a plain step's D phase 47 and G phase 34, the R1
# phase 40, the PPL phase 26 (the Function's calls, whatever the widths)
UPFIRDN_PLAIN, UPFIRDN_REG = 81, 81 + 40 + 26
# styled conv epilogues: the D phase's fake batch, made without a graph (8
# TS and 4 SS styled convs); the G, R1 and PPL phases run under autograd
# and compose the ops
EPILOGUES = 12


@pytest.fixture(autouse=True)
def _float32():
    needs_card()
    with no_tf32():
        yield


def _tiny_models(batch=4):
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator

    cfg = tiny_config()
    tp = cfg.train_params
    tp.batch_size, tp.n_mlp = batch, 1
    g = Generator.from_config(cfg)
    object.__setattr__(g.ts, "channel_base", 16)
    d = Discriminator(patch_size=101, channel_multiplier=1, batch_size=batch,
                      linear_ch=16)
    small = {k: 16 for k in d.channels()}
    object.__setattr__(d, "channels", lambda: small)
    return cfg, g, d


def _moved(obj, dev):
    """A TrainState or draws dataclass with every tensor on dev."""
    from spgan_tpu_torch.tree import tree_map

    def mv(v):
        if dataclasses.is_dataclass(v):
            return _moved(v, dev)
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, (dict, list)):
            return tree_map(lambda t: t.to(dev), v)
        return v

    return dataclasses.replace(obj, **{f.name: mv(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


def _real(batch, seed=2):
    rng = np.random.RandomState(seed)
    return (torch.as_tensor(rng.randn(batch, 101, 101, 3).astype(np.float32)),
            torch.as_tensor(rng.uniform(-1, 1, (batch, 3)).astype(np.float32)))


@pytest.mark.gpu
def test_tiny_step_phases_match_cpu_on_card():
    """D, R1, G and PPL from the same weights and draws: losses within
    1e-5 relative (the PPL penalty 1e-4: quadratic in tiny path lengths),
    every phase's gradients within 1e-5 of their scale; the tap sampler
    once an SS layer a forward (D's fakes, G, PPL)."""
    from spgan_tpu_torch.train.state import create_train_state
    from spgan_tpu_torch.train.step import make_train_step

    cfg, g, d = _tiny_models()
    step = make_train_step(cfg, g, d)
    state = create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                               device="cpu")
    draws = step.draw(torch.Generator().manual_seed(1), do_ppl=True)
    real, real_ac = _real(4)
    out = {}
    for dev in ("cpu", "cuda"):
        st, dr = _moved(state, dev), _moved(draws, dev)
        with Launches() as n:
            gd, md = step.d_grads(st.params_g, st.params_d, real.to(dev),
                                  real_ac.to(dev), dr.d)
            gr, r1 = step.r1_grads(st.params_d, real.to(dev), real_ac.to(dev))
            gg, mg = step.g_grads(st.params_g, st.params_d, dr.g)
            gp, pen, _, plen = step.ppl_grads(st.params_g, dr,
                                              st.mean_path_length)
        out[dev] = ({**md, **mg, "r1": r1, "path": pen, "path_lengths": plen},
                    {"d": gd, "r1": gr, "g": gg, "ppl": gp})
    assert n.got["sphere_sample"] == 3 * g.ss.n_layers
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    for k, v in lc.items():
        rel = abs(float(lg[k]) - float(v)) / max(abs(float(v)), 1e-12)
        assert rel <= (1e-4 if k == "path" else 1e-5), (k, rel)
    for phase in gc:
        a = [t for t in gc[phase] if t is not None]
        b = [t.cpu() for t in gg[phase] if t is not None]
        scale = max(float(t.abs().max()) for t in a)
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        assert err <= 1e-5 * scale, (phase, err / scale)


@pytest.mark.gpu
def test_full_width_step_launches_on_card():
    """Config() (batch 16, float32, synthetic batches): the tap sampler 8
    times a plain step and 12 an R1+PPL step, upfirdn2d 81 and 147, the
    styled conv epilogue 12 (the D phase's fake batch), no sphere conv; fewer than 256 convolutions on the R1+PPL step (a
    per-channel loop over the blurs' 256 or 512 channels would add 256
    alone; the step has 186 on the H100); every metric finite and G, D
    and the EMA moved."""
    from torch.profiler import ProfilerActivity, profile

    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.data.pipeline import TrainPipeline
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.train.state import create_train_state
    from spgan_tpu_torch.train.step import make_train_step
    from spgan_tpu_torch.tree import tree_leaves

    cfg = Config()
    g, d = Generator.from_config(cfg), Discriminator.from_config(cfg)
    state = create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                               device="cuda")
    step = make_train_step(cfg, g, d)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pipe = TrainPipeline(cfg, seed=0)
    try:
        batches = [{k: torch.as_tensor(v).cuda() for k, v in next(pipe).items()}
                   for _ in range(3)]
    finally:
        pipe.close()

    def run(s, b, reg):
        s, m = step(s, b["patch"], b["ac_coords"], gen, do_r1=reg,
                    do_ppl=reg)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
        return s

    s0 = run(state, batches[0], True)  # warm-up
    with Launches() as plain:
        s1 = run(s0, batches[1], False)
    assert plain.got == only(sphere_sample=2 * g.ss.n_layers,
                             upfirdn=UPFIRDN_PLAIN, styled_epilogue=EPILOGUES)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            Launches() as reg:
        s2 = run(s1, batches[2], True)
    assert reg.got == only(sphere_sample=3 * g.ss.n_layers,
                           upfirdn=UPFIRDN_REG, styled_epilogue=EPILOGUES)
    convs = sum(e.count for e in prof.key_averages()
                if e.key == "aten::convolution")
    assert 0 < convs < 256

    def moved(name):
        return max(float((x - y).abs().max()) for x, y in
                   zip(tree_leaves(getattr(s2, name)),
                       tree_leaves(getattr(s0, name))))

    assert moved("params_g") > 0 and moved("params_d") > 0
    assert 0 < moved("params_g_ema") < moved("params_g")


@pytest.mark.gpu
def test_data_parallel_step_over_nccl_matches_the_plain_step_on_card():
    """A world of one over NCCL runs the data-parallel step (its flat
    gradient all-reduce and the metrics' mean) at the tiny widths.  A
    world of one reduces nothing, so on deterministic kernels a plain and
    an R1+PPL step give the plain TrainStep's parameters (G, D and G's
    EMA) and metrics bit for bit."""
    from spgan_tpu_torch.parallel.mesh import close, init_distributed
    from spgan_tpu_torch.train.state import create_train_state
    from spgan_tpu_torch.train.step import make_train_step
    from spgan_tpu_torch.tree import tree_leaves

    cfg, g, d = _tiny_models()
    real, real_ac = (t.cuda() for t in _real(4))
    was = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    # scatter-adds (the gathers' gradients) in a fixed order; an op with
    # no deterministic kernel warns
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = init_distributed(None, 1, 0, backend="nccl", device="cuda:0")
    try:
        assert mesh.backend == "nccl"
        got = {}
        for name, m in (("dp", mesh), ("plain", None)):
            step = make_train_step(cfg, g, d, mesh=m)
            state = create_train_state(cfg, g, d,
                                       torch.Generator().manual_seed(0),
                                       device="cuda")
            for reg in (False, True):
                got[name, reg] = step(
                    state, real, real_ac,
                    torch.Generator(device="cuda").manual_seed(1),
                    do_r1=reg, do_ppl=reg)
    finally:
        close(mesh)
        torch.backends.cudnn.deterministic = was[0]
        torch.use_deterministic_algorithms(was[1], warn_only=was[2])
    for reg in (False, True):
        (want_state, want), (have_state, have) = got["plain", reg], \
            got["dp", reg]
        for tree in ("params_g", "params_d", "params_g_ema"):
            a = tree_leaves(getattr(have_state, tree))
            b = tree_leaves(getattr(want_state, tree))
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (tree, reg)
        assert set(want) == set(have)
        for k, v in want.items():
            assert float(have[k]) == float(v), (k, reg)
