"""The port's latent inversion (spgan_tpu_torch/infer/inversion.py) and its
noise regulariser against the JAX package's on the CPU, at the tiny config
of tests/test_inversion.py (channel_base 24, 1 SS layer), the same weights,
the same target and JAX's initial draws injected: the regulariser
(rtol 1e-5), the first step's gradients (atol 1e-4 of each leaf's largest),
the losses of 5 Adam steps (rtol 1e-3), the LPIPS term on random weights
(rtol 1e-4), and the record file read back by both packages' readers."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgan_tpu.config import Config as JConfig
from spgan_tpu.evalkit.lpips import LPIPS as JLPIPS
from spgan_tpu.geometry.coords import CoordsPartial as JCoordsPartial
from spgan_tpu.infer.inversion import InversionResult as JResult
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.models.losses import noise_regularize as jax_noise_reg
from spgan_tpu_torch.config import Config
from spgan_tpu_torch.evalkit.lpips import random_lpips
from spgan_tpu_torch.infer.__main__ import _inv_records
from spgan_tpu_torch.infer.inversion import (InversionResult, inversion_loss,
                                             invert_patch)
from spgan_tpu_torch.models.generator import Generator
from spgan_tpu_torch.models.losses import noise_regularize
from helpers.port_tiny import cpu_budget, jax_layout


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    with cpu_budget():
        yield


def _tiny(cfg):
    tp = cfg.train_params
    tp.global_latent_dim = 16
    tp.local_latent_dim = 8
    tp.channel_multiplier = 1
    tp.n_mlp = 1
    tp.ss_n_layers = 1
    return cfg


def _narrow(g):
    object.__setattr__(g.ts, "channel_base", 24)
    return g


@pytest.mark.parametrize("shapes", [
    [(1, s, s, 1) for s in (11, 19, 17, 31, 29, 55, 53, 103, 101)],
    [(2, 19, 17, 1), (1, 31, 29, 2), (1, 9, 40, 1), (1, 64, 64, 1)]],
    ids=["ts_sizes", "mixed"])
def test_noise_regularize_matches_jax(shapes):
    """Odd sides drop their last row / column before each 2x2 mean; the
    rolls are along H and W of NHWC."""
    rng = np.random.RandomState(len(shapes))
    ns = [rng.randn(*s).astype(np.float32) for s in shapes]
    want = float(jax.jit(jax_noise_reg)([jnp.asarray(n) for n in ns]))
    got = float(noise_regularize([torch.tensor(n) for n in ns]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0


@pytest.fixture(scope="module")
def setup():
    """Both generators on the port's random weights, one training crop, a
    target the port renders from numpy fields, and JAX's initial
    inversion draws from PRNGKey(0) (as invert_patch makes them)."""
    g = _narrow(Generator.from_config(_tiny(Config())))
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    jg = _narrow(JGenerator.from_config(_tiny(JConfig())))
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_layout(params))

    coords, _, cp = g.ss.coord_grid.sample_training(
        torch.Generator().manual_seed(1), 1)
    jcp = JCoordsPartial(*(jnp.asarray(getattr(cp, f).numpy()) for f in (
        "p_x_st", "p_x_ed", "p_y_st", "p_y_ed", "circular")),
        x_total=cp.x_total, y_total=cp.y_total, grid_partial=cp.grid_partial)
    rng = np.random.RandomState(3)
    zs = g.ss.coord_grid.ss_spatial_size
    sizes = g.ts.stitch_geometry().outfeat_sizes
    gl = torch.tensor(rng.randn(1, 2, 16).astype(np.float32))
    ll = torch.tensor(rng.randn(1, zs, zs, 8).astype(np.float32))
    tnoise = [torch.tensor(rng.randn(1, s, s, 1).astype(np.float32))
              for s in sizes]
    with torch.no_grad():
        target = g.ts_on_grids(
            params, g.ss_on_grids(params, gl[:, 0], ll, coords, cp),
            g.build_styles(params, gl), cp, noises=tnoise)

    @jax.jit
    def draws(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {
            "w_mean": jg.ts.mean_latent(jparams["ts"], k1, 1024)[0],
            "z": jax.random.normal(k2, (1, zs, zs, 8)),
            "gz": jax.random.normal(jax.random.fold_in(k2, 1), (1, 16)),
            "noises": [jax.random.normal(jax.random.fold_in(k3, i),
                                         (1, s, s, 1))
                       for i, s in enumerate(sizes)]}

    init = jax.tree_util.tree_map(np.asarray, draws(jax.random.PRNGKey(0)))
    return {"g": g, "params": params, "jg": jg, "jparams": jparams,
            "coords": coords, "jcoords": jnp.asarray(coords.numpy()),
            "cp": cp, "jcp": jcp, "target": target, "init": init}


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's invert_patch from PRNGKey(0), 5 steps: its jitted step
    (spgan_tpu/infer/inversion.py:92-110, its loss_fn, optax.adam and the
    noise renormalisation) written out here on JAX's own functions, so
    that the first step's gradients come out too and the step compiles
    once (invert_patch builds a new jitted step per call and runs its
    draws op by op, ~10 s more on this CPU)."""
    import optax

    s = setup
    jg, jparams, jcp = s["jg"], s["jparams"], s["jcp"]
    target = jnp.asarray(s["target"].numpy())
    init = s["init"]
    v = {"z": jnp.asarray(init["z"]), "gz": jnp.asarray(init["gz"]),
         "wplus": jnp.tile(jnp.asarray(init["w_mean"])[None, None],
                           (1, jg.ts.n_latent, 1)),
         "noises": [jnp.asarray(n) for n in init["noises"]]}

    def loss_fn(v):
        structure = jg.ss.apply(jparams["ss"], v["gz"], v["z"],
                                s["jcoords"], jcp)
        img = jg.ts.synthesize(jparams["ts"], structure, v["wplus"], jcp,
                               noises=v["noises"])
        rec = jnp.mean(jnp.square(img - target))
        return rec + 1e3 * jax_noise_reg(v["noises"]), rec

    opt = optax.adam(0.05)

    @jax.jit
    def step(v, st):
        (_, rec), grads = jax.value_and_grad(loss_fn, has_aux=True)(v)
        upd, st = opt.update(grads, st, v)
        v = optax.apply_updates(v, upd)
        v["noises"] = [n / (jnp.std(n) + 1e-8) for n in v["noises"]]
        return v, st, rec, grads

    st, losses, first = opt.init(v), [], None
    for _ in range(5):
        v, st, rec, grads = step(v, st)
        losses.append(float(rec))
        first = grads if first is None else first
    res = JResult(local_latent=np.asarray(v["z"][0]),
                  noises=[np.asarray(n[0]) for n in v["noises"]],
                  wplus=np.asarray(v["wplus"][0]), losses=np.asarray(losses))
    return res, first


def _start(s):
    """The port's inversion variables at the injected starting point."""
    init = s["init"]
    v = {"z": init["z"], "gz": init["gz"],
         "wplus": np.tile(init["w_mean"][None, None],
                          (1, s["g"].ts.n_latent, 1))}
    v = {k: torch.tensor(x).requires_grad_(True) for k, x in v.items()}
    v["noises"] = [torch.tensor(n).requires_grad_(True)
                   for n in init["noises"]]
    return v


def test_first_step_gradients_match_jax(setup, jax_run):
    """jax.grad of JAX's inversion loss against the port's autograd of
    inversion_loss, at the same starting point."""
    s, (_, want) = setup, jax_run
    v = _start(s)
    loss, rec = inversion_loss(s["g"], s["params"], v, s["target"], s["cp"],
                               s["coords"])
    loss.backward()
    assert float(rec.detach()) > 0
    pairs = [(v[k].grad, want[k]) for k in ("z", "gz", "wplus")]
    pairs += list(zip((n.grad for n in v["noises"]), want["noises"]))
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_five_step_losses_match_jax(setup, jax_run):
    """JAX's inversion from PRNGKey(0) and the port's invert_patch from
    the same draws: the reconstruction losses of 5 steps, and the
    variables after them (noise maps renormalised to a population std of
    1)."""
    s, (want, _) = setup, jax_run
    got = invert_patch(s["g"], s["params"], s["target"], s["cp"],
                       s["coords"], steps=5, init=s["init"])
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert got.losses[-1] < got.losses[0]
    np.testing.assert_allclose(got.local_latent, want.local_latent,
                               atol=1e-3)
    np.testing.assert_allclose(got.wplus, want.wplus, atol=1e-3)
    for a, b in zip(got.noises, want.noises):
        np.testing.assert_allclose(a, b, atol=1e-3)
        np.testing.assert_allclose(a.std(), 1.0, rtol=1e-5)


def test_lpips_term_matches_jax(setup):
    """With an LPIPS net (random_lpips weights, carried to JAX's layout)
    the loss gains lpips_weight times JAX's LPIPS of the render and the
    target; invert_patch runs with it."""
    s = setup
    lp = random_lpips(seed=3, device="cpu")
    jparams = {"convs": [{"w": c.weight.numpy().transpose(2, 3, 1, 0),
                          "b": c.bias.numpy()} for c in lp.convs],
               "lins": [{"w": lin.detach().numpy()[:, None]}
                        for lin in lp.lins]}
    v = _start(s)
    args = (s["g"], s["params"], v, s["target"], s["cp"], s["coords"], 1e3)
    base, _ = inversion_loss(*args)
    with_lp, _ = inversion_loss(*args, lpips=lp, lpips_weight=0.5)
    with torch.no_grad():
        img = s["g"].ts_on_grids(
            s["params"], s["g"].ss_on_grids(s["params"], v["gz"], v["z"],
                                            s["coords"], s["cp"]),
            v["wplus"], s["cp"], noises=v["noises"])
    want = np.asarray(jax.jit(JLPIPS().apply)(
        jparams, jnp.asarray(img.numpy()), jnp.asarray(s["target"].numpy())))
    with torch.no_grad():
        np.testing.assert_allclose(lp(img, s["target"]).numpy(), want,
                                   rtol=1e-5)
    # the term is the difference of two float32 losses near 1
    term = float((with_lp - base).detach()) / 0.5
    np.testing.assert_allclose(term, float(want.mean()), rtol=1e-3)
    assert term > 0
    res = invert_patch(s["g"], s["params"], s["target"], s["cp"],
                       s["coords"], steps=2, lpips=lp, init=s["init"])
    assert np.isfinite(res.losses).all()


def test_invert_from_own_draws(setup):
    """From the port's own draws (the default generator), 10 steps at the
    default lr halve the reconstruction loss."""
    s = setup
    res = invert_patch(s["g"], s["params"], s["target"], s["cp"],
                       s["coords"], steps=10)
    assert np.isfinite(res.losses).all()
    assert res.losses[-1] < 0.5 * res.losses[0], res.losses
    rec = res.record()
    zs = s["g"].ss.coord_grid.ss_spatial_size
    assert rec["local_latent"].shape == (zs, zs, 8)
    assert len(rec["noises"]) == s["g"].ts.n_latent - 1


def test_record_file_read_by_both_readers(tmp_path):
    """The port's InversionResult.save writes JAX's file byte layout: the
    port's --inv-records reader and test.py's read it back, equal to
    JAX's InversionResult.save of the same arrays."""
    rng = np.random.RandomState(0)
    fields = dict(
        local_latent=rng.randn(35, 35, 8).astype(np.float32),
        noises=[rng.randn(s, s, 1).astype(np.float32) + i
                for i, s in enumerate((19, 17, 31, 29, 55, 53, 103, 101,
                                       199, 197, 391))],
        wplus=rng.randn(9, 16).astype(np.float32),
        losses=np.linspace(1.0, 0.1, 5))
    InversionResult(**fields).save(str(tmp_path / "port.npz"))
    JResult(**fields).save(str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # test.py's reader (test.py:162-169)
    jrec = {"local_latent": a["z"][0],
            "noises": [a[k][0] for k in sorted(a.files)
                       if k.startswith("noise")]}
    (rec,), places = _inv_records(argparse.Namespace(
        inv_records=str(tmp_path / "port.npz"), inv_placements=None))
    assert places == [0.5]
    np.testing.assert_array_equal(rec["local_latent"], fields["local_latent"])
    np.testing.assert_array_equal(jrec["local_latent"], rec["local_latent"])
    assert len(rec["noises"]) == len(jrec["noises"]) == 11
    for x, y, z in zip(rec["noises"], jrec["noises"], fields["noises"]):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)
