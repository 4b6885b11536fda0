"""The port's eval networks and statistics (spgan_tpu_torch/evalkit/)
against the JAX package's on the CPU, on the same numpy weights and
inputs.

Inception: He-scale numpy weights with random batchnorm statistics, in
pytorch-fid's state-dict layout, saved to a .pth that both packages'
load_torch_inception read (JAX's N(0, 0.02) init would shrink the
activations towards zero through the dozens of stacked convolutions,
and a parity test on it would compare near-zeros).  Each block kind at
full channel width on a 9x9 input: max abs error <= 2e-5 of the largest
reference value; the whole network at 101^2 through the resize (JAX
jitted once): <= 1e-4 of it.  The resize to 299 against
jax.image.resize at four sizes, two of which shrink an axis: <= 5e-5.
Statistics and the Frechet distance: rel 1e-10 (the same float64 numpy
code); the Inception Score on the same logits: rel 1e-6, its std
1e-5 (float32 softmax in each framework).  LPIPS: rel 1e-5.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from threadpoolctl import threadpool_limits

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.inception_sd import pt_inception_state_dict  # noqa: E402

from spgan_tpu.evalkit import fid as jfid  # noqa: E402
from spgan_tpu.evalkit import inception as jinc  # noqa: E402
from spgan_tpu.evalkit import is_score as jis  # noqa: E402
from spgan_tpu.evalkit import lpips as jlp  # noqa: E402
from spgan_tpu_torch.compat.from_jax import \
    inception_from_jax  # noqa: E402
from spgan_tpu_torch.evalkit import (fid, inception, is_score,  # noqa
                                     lpips)

BLOCK_TOL = 2e-5
NET_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for torch and one BLAS thread for numpy and
    scipy: several test processes run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """(path of the .pth, JAX params read from it by JAX's loader, the
    input batch at 101^2, JAX's features and logits of it)."""
    rng = np.random.RandomState(0)
    path = str(tmp_path_factory.mktemp("inception") / "pt_inception.pth")
    torch.save(pt_inception_state_dict(rng), path)
    jparams = jinc.load_torch_inception(path, with_logits=True)
    x = rng.uniform(-1, 1, (2, 101, 101, 3)).astype(np.float32)
    trunk = {k: v for k, v in jparams.items() if k != "fc"}
    feats = np.asarray(jax.jit(jinc.InceptionV3FID().apply)(trunk, x))
    logits = (feats @ np.asarray(jparams["fc"]["w"])
              + np.asarray(jparams["fc"]["b"]))
    # the features carry signal: not the near-zeros of a shrinking init
    assert feats.std() > 0.05, feats.std()
    return path, jparams, x, feats, logits


def _close(got, want, tol):
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


_KINDS = {"A": ("Mixed_5b", jinc._block_a), "B": ("Mixed_6a", jinc._block_b),
          "C": ("Mixed_6b", jinc._block_c), "D": ("Mixed_7a", jinc._block_d),
          "E_avg": ("Mixed_7b", lambda p, x: jinc._block_e(p, x, "avg")),
          "E_max": ("Mixed_7c", lambda p, x: jinc._block_e(p, x, "max"))}


@pytest.mark.parametrize("kind", list(_KINDS))
def test_inception_block_matches_jax(net, kind):
    """One block of each kind at full channel width on a 9x9 input."""
    _, jparams, *_ = net
    name, jblock = _KINDS[kind]
    _, cin, extra = inception.BLOCKS[name]
    blk = inception.InceptionBlock(kind, cin, extra)
    blk.load_state_dict({k[len(name) + 1:]: v for k, v in
                         inception_from_jax(jparams).items()
                         if k.startswith(name + ".")})
    x = np.random.RandomState(1).rand(2, 9, 9, cin).astype(np.float32)
    want = np.asarray(jblock(jparams[name], jnp.asarray(x)))
    with torch.no_grad():
        got = blk(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got.numpy(), want, BLOCK_TOL)


def test_inception_network_matches_jax(net):
    """The whole network at 101^2 (resized to 299) from JAX's params
    through inception_from_jax: features and logits."""
    _, jparams, x, feats, logits = net
    for with_logits, want in ((False, feats), (True, logits)):
        model = inception.InceptionV3FID(with_logits=with_logits)
        inception.load_inception_state_dict(model,
                                            inception_from_jax(jparams))
        with torch.no_grad():
            got = model(torch.tensor(x))
        _close(got.numpy(), want, NET_TOL)


def test_load_torch_inception_matches_jax_loader(net):
    """The same .pth through the port's load_torch_inception (its
    num_batches_tracked dropped, the fc kept only with_logits)."""
    path, _, x, feats, logits = net
    for with_logits, want in ((False, feats), (True, logits)):
        model = inception.load_torch_inception(path, with_logits=with_logits,
                                               device="cpu")
        assert hasattr(model, "fc") == with_logits
        with torch.no_grad():
            _close(model(torch.tensor(x)).numpy(), want, NET_TOL)


@pytest.mark.parametrize("h, w", [(101, 101), (197, 197), (256, 768),
                                  (384, 768)])
def test_resize_matches_jax_image_resize(h, w):
    """jax.image.resize antialiases a shrinking axis.  pytorch-fid's plain
    bilinear (the reference's) agrees with it where both axes grow and
    sits far off it where one shrinks (fault C6): the port follows JAX."""
    x = np.random.RandomState(h + w).uniform(-1, 1, (1, h, w, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                       "bilinear"))
    nchw = torch.tensor(x).permute(0, 3, 1, 2)
    got = inception.resize_to_input(nchw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=5e-5)
    plain = torch.nn.functional.interpolate(nchw, size=(299, 299),
                                            mode="bilinear",
                                            align_corners=False)
    gap = np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max()
    print(f"plain bilinear {h}x{w} -> 299: max abs {gap:.3g} off "
          "jax.image.resize")
    assert gap > 0.5 if max(h, w) > 299 else gap < 1e-6


def test_random_inception_is_seeded_and_alive():
    a = inception.random_inception(device="cpu")
    b = inception.random_inception(device="cpu")
    x = torch.tensor(np.random.RandomState(2).uniform(
        -1, 1, (2, 80, 80, 3)).astype(np.float32))
    with torch.no_grad():
        fa, fb = a(x), b(x)
    assert fa.shape == (2, 2048) and torch.equal(fa, fb)
    assert float(fa.std()) > 1e-3


def _feature_batches(seed, n=3, b=40, d=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, d).astype(np.float32) for _ in range(n)]


def _rel(got, want, tol):
    assert abs(got - want) <= tol * abs(want), (got, want)


def test_stats_and_frechet_match_jax():
    a, b = _feature_batches(0), _feature_batches(1)
    sa, sb = fid.compute_stats(a), fid.compute_stats(b)
    ja, jb = jfid.compute_stats(a), jfid.compute_stats(b)
    np.testing.assert_allclose(sa.mu, ja.mu, rtol=1e-10, atol=0)
    np.testing.assert_allclose(sa.sigma, ja.sigma, rtol=1e-10, atol=1e-14)
    assert sa.n == ja.n == 120
    _rel(fid.frechet_distance(sa, sb), jfid.frechet_distance(ja, jb), 1e-10)


def test_frechet_rank_deficient_matches_jax():
    """n < d (production's 2048 features in 2048-d are rank-deficient):
    singular products, no warning, the same value."""
    import warnings

    rng = np.random.RandomState(7)
    a = [rng.randn(50, 256), rng.randn(50, 256)]
    b = [rng.randn(100, 256) * 1.1 + 0.05]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = fid.frechet_distance(fid.compute_stats(a), fid.compute_stats(b))
        same = fid.frechet_distance(fid.compute_stats(a),
                                    fid.compute_stats(a))
    want = jfid.frechet_distance(jfid.compute_stats(a), jfid.compute_stats(b))
    assert np.isfinite(got) and got > 0
    _rel(got, want, 1e-10)
    assert abs(same) < 1e-3


def test_fid_stats_pickles_cross_both_ways(tmp_path):
    s = fid.compute_stats(_feature_batches(3))
    s.save(str(tmp_path / "port.pkl"))
    back = jfid.FIDStats.load(str(tmp_path / "port.pkl"))
    np.testing.assert_array_equal(back.sigma, s.sigma)
    js = jfid.compute_stats(_feature_batches(4))
    js.save(str(tmp_path / "jax.pkl"))
    got = fid.FIDStats.load(str(tmp_path / "jax.pkl"))
    np.testing.assert_array_equal(got.mu, js.mu)
    assert got.n == js.n
    with open(tmp_path / "jax.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"mu", "sigma", "n"}


class _Identity:
    """JAX's inception spec stand-in: logits = the input."""

    def __init__(self, with_logits=True):
        pass

    def apply(self, params, x):
        return x


class _TorchIdentity(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x


def test_inception_score_matches_jax(monkeypatch):
    """The score of the same logit batches, 3 splits."""
    monkeypatch.setattr(jis, "InceptionV3FID", _Identity)
    rng = np.random.RandomState(5)
    batches = [(rng.randn(10, 1008) * 3).astype(np.float32)
               for _ in range(3)]
    want = jis.inception_score(batches, None, splits=3)
    got = is_score.inception_score(batches, _TorchIdentity(), splits=3)
    _rel(got[0], want[0], 1e-6)
    _rel(got[1], want[1], 1e-5)
    assert got[0] > 1


def _jax_lpips_params(rng):
    convs, cin = [], 3
    for cout, k, _, _ in jlp._ALEX:
        convs.append({"w": (rng.randn(k, k, cin, cout)
                            * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
                      "b": (rng.randn(cout) * 0.1).astype(np.float32)})
        cin = cout
    lins = [{"w": (rng.rand(c, 1) * 0.1 - 0.02).astype(np.float32)}
            for c in (64, 192, 384, 256, 256)]     # some < 0: clamped
    return {"convs": convs, "lins": lins}


def _lpips_state_dict(params):
    """The port's LPIPS state dict of JAX LPIPS params ({convs: [{w
    (HWIO), b}], lins: [{w (C, 1)}]})."""
    sd = {}
    for i, c in enumerate(params["convs"]):
        sd[f"convs.{i}.weight"] = torch.tensor(
            c["w"].transpose(3, 2, 0, 1).copy())
        sd[f"convs.{i}.bias"] = torch.tensor(c["b"])
    for i, lin in enumerate(params["lins"]):
        sd[f"lins.{i}"] = torch.tensor(lin["w"].reshape(-1))
    return sd


def _lpips_inputs(rng, n=2, size=64):
    return [rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def test_lpips_matches_jax():
    rng = np.random.RandomState(6)
    params = _jax_lpips_params(rng)
    x, y = _lpips_inputs(rng)
    want = np.asarray(jlp.LPIPS().apply(params, jnp.asarray(x),
                                        jnp.asarray(y)))
    model = lpips.LPIPS()
    model.load_state_dict(_lpips_state_dict(params))
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(y)).numpy()
        same = model(torch.tensor(x), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got > 0).all() and np.abs(same).max() == 0


def test_load_torch_lpips_matches_jax_loader(tmp_path):
    """A torchvision-AlexNet-shaped state dict (features.{0,3,6,8,10} and
    a classifier the loader ignores) and an lpips lin dict, read by both
    packages' loaders."""
    rng = np.random.RandomState(8)
    params = _jax_lpips_params(rng)
    asd = {}
    for fid_, c in zip(lpips.ALEX_FEATURE_IDS, params["convs"]):
        asd[f"features.{fid_}.weight"] = torch.tensor(
            c["w"].transpose(3, 2, 0, 1).copy())
        asd[f"features.{fid_}.bias"] = torch.tensor(c["b"])
    asd["classifier.1.weight"] = torch.zeros(4, 9216)
    lsd = {f"lin{i}.model.1.weight": torch.tensor(
        lin["w"].T[:, :, None, None].copy())
        for i, lin in enumerate(params["lins"])}
    torch.save(asd, str(tmp_path / "alex.pth"))
    torch.save(lsd, str(tmp_path / "lin.pth"))
    x, y = _lpips_inputs(rng)
    jp = jlp.load_torch_lpips(str(tmp_path / "alex.pth"),
                              str(tmp_path / "lin.pth"))
    want = np.asarray(jlp.LPIPS().apply(jp, jnp.asarray(x), jnp.asarray(y)))
    model = lpips.load_torch_lpips(str(tmp_path / "alex.pth"),
                                   str(tmp_path / "lin.pth"), device="cpu")
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        inception.random_inception()
    with pytest.raises(RuntimeError, match="CUDA"):
        fid.FIDEvaluator(inception.InceptionV3FID())
