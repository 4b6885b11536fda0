"""The port's offline eval CLI, python -m spgan_tpu_torch.evalkit (the
counterpart of tools/eval_metrics.py), on the CPU (--device cpu).

Both CLIs read the same pytorch-fid-layout .pth (He-scale numpy weights)
and give the same FID on the same .npy sets within rel 1e-3.  The
identities that hold for any network (FID(X, X) = 0 whether X is an
.npy, an .spr, a PNG folder or a stats .pkl; FID > 0 between distinct
sets; IS >= 1; LPIPS(x, x) = 0) run with --allow-random-weights, the
random inception network replaced by a 16-feature stand-in so that each
Frechet distance takes milliseconds instead of the ~10 s of a 2048-d
matrix square root on a CPU; LPIPS runs its real random AlexNet."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from helpers.fid_span import span_frechet  # noqa: E402
from helpers.inception_sd import pt_inception_state_dict  # noqa: E402

import spgan_tpu.evalkit.fid as jax_fid  # noqa: E402
from tools.eval_metrics import main as jax_main  # noqa: E402
import spgan_tpu_torch.evalkit.fid as port_fid  # noqa: E402
import spgan_tpu_torch.evalkit.inception as port_inception  # noqa: E402
from spgan_tpu_torch.data.native_loader import write_records  # noqa: E402
from spgan_tpu_torch.evalkit.__main__ import main  # noqa: E402
from spgan_tpu_torch.utils.png import write_png  # noqa: E402


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
def image_sets(tmp_path_factory):
    """Two .npy sets of 8 uint8 64x64 images, set a again as an .spr and
    as a folder of PNGs."""
    root = tmp_path_factory.mktemp("sets")
    rng = np.random.RandomState(0)
    a = rng.randint(0, 255, (8, 64, 64, 3), np.uint8)
    b = rng.randint(0, 255, (8, 64, 64, 3), np.uint8)
    pa, pb = str(root / "a.npy"), str(root / "b.npy")
    np.save(pa, a)
    np.save(pb, b)
    write_records(str(root / "a.spr"), a)
    (root / "a_folder").mkdir()
    for i in range(8):
        write_png(str(root / "a_folder" / f"{i:03d}.png"), a[i])
    return pa, pb, str(root / "a.spr"), str(root / "a_folder")


class _StandIn(torch.nn.Module):
    """16 features (or logits) of an image: pooled colours through a
    fixed linear map."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(12, 16)
        with torch.no_grad():
            rng = np.random.RandomState(9)
            self.lin.weight.copy_(torch.tensor(
                rng.randn(16, 12).astype(np.float32)))
            self.lin.bias.copy_(torch.tensor(
                rng.randn(16).astype(np.float32)))

    def forward(self, x):
        pooled = torch.nn.functional.adaptive_avg_pool2d(
            x.float().permute(0, 3, 1, 2), 2).flatten(1)
        return torch.tanh(self.lin(pooled * 4))


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(port_inception, "random_inception",
                        lambda with_logits=False, device=None, **kw:
                        _StandIn().to(device))


def _cli(*argv):
    return main(list(argv) + ["--device", "cpu", "--batch", "4"])


def test_fid_self_is_zero_and_distinct_positive(image_sets, stand_in,
                                                capsys):
    pa, pb, spr, folder = image_sets
    for other in (spr, folder):
        out = _cli("fid", pa, other, "--allow-random-weights")
        assert out["value"] == pytest.approx(0.0, abs=1e-6)
        assert out["n_a"] == out["n_b"] == 8 and not out["real_weights"]
        line = capsys.readouterr().out.strip().splitlines()[-1]
        parsed = json.loads(line)
        assert parsed["metric"] == "fid" and "WARNING" in parsed
    assert _cli("fid", pa, pb, "--allow-random-weights")["value"] > 0.0


def test_stats_pkl_round_trip(image_sets, stand_in, tmp_path, monkeypatch):
    pa, _, _, folder = image_sets
    pkl = str(tmp_path / "a_stats.pkl")
    out = _cli("stats", pa, "--out", pkl, "--allow-random-weights")
    assert out["n"] == 8 and os.path.isfile(pkl)
    out = _cli("fid", pkl, folder, "--allow-random-weights")
    assert out["value"] == pytest.approx(0.0, abs=1e-6) and out["n_a"] == 8
    # two .pkl sides build no network: no weights needed
    monkeypatch.delenv("SPGAN_TPU_INCEPTION", raising=False)
    out = _cli("fid", pkl, pkl)
    assert out["value"] == pytest.approx(0.0, abs=1e-6)
    assert out["real_weights"]


def test_is_cli(image_sets, stand_in):
    out = _cli("is", image_sets[0], "--splits", "2",
               "--allow-random-weights")
    assert out["metric"] == "inception_score" and out["n"] == 8
    assert out["value"] >= 1.0 - 1e-5 and np.isfinite(out["std"])


def test_lpips_cli(image_sets):
    pa, pb, _, _ = image_sets
    out = _cli("lpips", pa, pa, "--allow-random-weights")
    assert out["value"] == 0.0 and out["n"] == 8
    assert _cli("lpips", pa, pb, "--allow-random-weights")["value"] > 0.0


def test_missing_weights_name_the_flags(image_sets, monkeypatch):
    pa, pb, _, _ = image_sets
    monkeypatch.delenv("SPGAN_TPU_INCEPTION", raising=False)
    with pytest.raises(SystemExit, match="--inception"):
        _cli("fid", pa, pb)
    with pytest.raises(SystemExit, match="--alex"):
        _cli("lpips", pa, pb)
    with pytest.raises(SystemExit, match="--inception"):
        _cli("fid", pa, pb, "--inception", str(pa) + ".missing.pth")


def test_default_device_is_the_card(image_sets):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["fid", image_sets[0], image_sets[1],
              "--allow-random-weights"])


def test_both_clis_read_the_same_pth(image_sets, tmp_path, monkeypatch):
    """tools/eval_metrics.py and the port's CLI with --inception on one
    synthetic pytorch-fid checkpoint: the same FID within rel 1e-3 (each
    package's frechet_distance taken in the span of the statistics,
    tests/helpers/fid_span.py: the same value without a 2048^2 square
    root)."""
    monkeypatch.setattr(jax_fid, "frechet_distance",
                        span_frechet(jax_fid.frechet_distance))
    monkeypatch.setattr(port_fid, "frechet_distance",
                        span_frechet(port_fid.frechet_distance))
    pa, pb, _, _ = image_sets
    pth = str(tmp_path / "pt_inception.pth")
    torch.save(pt_inception_state_dict(np.random.RandomState(2)), pth)
    want = jax_main(["fid", pa, pb, "--inception", pth, "--batch", "4"])
    got = _cli("fid", pa, pb, "--inception", pth)
    assert want["real_weights"] and got["real_weights"]
    assert "WARNING" not in got
    assert want["value"] > 0
    assert abs(got["value"] - want["value"]) <= 1e-3 * want["value"], (
        got["value"], want["value"])
