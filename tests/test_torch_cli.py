"""The port's inference CLI, python -m spgan_tpu_torch.infer, as a whole:
against the JAX package's test.py on the same weights and the same
TestingVars, and flag by flag on its own.  Tiny config (the dims of
tests/test_cli_surface.py's yaml; both generators narrowed to
channel_base 48 as tests/test_torch_engine.py narrows them), on the CPU."""
import datetime
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import spgan_tpu_torch.models.generator as port_generator
from spgan_tpu.compat.load import save_params_npz
from spgan_tpu.config import load_config as jax_load_config
from spgan_tpu.models.generator import Generator as JGenerator
from spgan_tpu.utils.flops import generator_flops as jax_flops
from spgan_tpu.utils.flops import pretty as jax_pretty
from spgan_tpu_torch.infer.__main__ import main
from spgan_tpu_torch.infer.testing_vars import TestingVars
from spgan_tpu_torch.utils import trace as tracer
from test_cli_surface import MODEL_YAML, _run_cli


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and a process per core's worth of spinning threads each slows
    them all several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TASKS = {
    "close_loop": ('task_manager: "spgan_tpu.infer.close_loop.'
                   'CloseLoopPanoramaManager"\nheight: 128\nwidth: 672\n'),
    # planar: a 4 x 5 lattice whose last column lies outside the 128 x 200
    # crop (JAX's grid path mirrors that column: ROADMAP C)
    "planar": ('task_manager: "spgan_tpu.infer.infinite.'
               'InfiniteGenerationManager"\nheight: 128\nwidth: 200\n'),
}


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' Generator.from_config give channel_base 48."""
    for cls in (JGenerator, port_generator.Generator):
        def from_config(cfg, orig=cls.from_config):
            g = orig(cfg)
            object.__setattr__(g.ts, "channel_base", 48)
            return g
        monkeypatch.setattr(cls, "from_config", staticmethod(from_config))


def _yamls(root, task, **task_keys):
    model, test = root / "tiny_model.yaml", root / f"tiny_{task}.yaml"
    model.write_text(MODEL_YAML)
    keys = {"seed": 17, "batch_size": 2, "num_gen": 2, **task_keys}
    test.write_text(TASKS[task] + "".join(f"{k}: {v}\n"
                                          for k, v in keys.items()))
    return ["--model-config", str(model), "--test-config", str(test)]


def _png(path):
    return np.asarray(Image.open(path))


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


@pytest.mark.parametrize("task", ["close_loop", "planar"])
def test_cli_renders_jax_vars_within_one_lsb(narrow, tmp_path, monkeypatch,
                                             task):
    """JAX's test.py renders and dumps its TestingVars; the port's CLI
    renders the same vars from the same weights (the .npz export): every
    PNG channel value within 1 of JAX's."""
    monkeypatch.chdir(tmp_path)
    args = _yamls(tmp_path, task)
    jg = JGenerator.from_config(jax_load_config(args[1], args[3]))
    params = str(tmp_path / "params.npz")
    save_params_npz(params, jg.init(jax.random.PRNGKey(5)))
    _run_cli(args + ["--ckpt", params, "--dump-vars",
                     "--save-root", str(tmp_path / "jax")])
    main(args + ["--device", "cpu", "--ckpt", params,
                 "--inter-ckpt", str(tmp_path / "jax"),
                 "--save-root", str(tmp_path / "port")])
    names = _pngs(tmp_path / "jax")
    assert names == _pngs(tmp_path / "port") == ["000000.png", "000001.png"]
    a = np.stack([_png(tmp_path / "jax" / n) for n in names]).astype(int)
    b = np.stack([_png(tmp_path / "port" / n) for n in names]).astype(int)
    assert a.shape == b.shape == (2, 128, 672 if task == "close_loop" else
                                  200, 3)
    assert np.abs(a - b).max() <= 1
    # float32 on both sides, summed in another order (and JAX's test.py on
    # the CPU runs its gather path, the port its tap tables): measured
    # 99.997% of the channel values exact close-loop (14 of 516,096 off by
    # 1) and 99.995% planar (8 of 153,600); the rest sat on a rounding edge
    assert (a == b).mean() > 0.999


def test_cli_imports_no_jax(tmp_path):
    """A process running the CLI (--calc-flops, --device cpu) imports
    neither jax nor the JAX package, and prints the JAX package's FLOPs
    lines."""
    args = _yamls(tmp_path, "close_loop")
    code = (
        "import json, sys\n"
        "from spgan_tpu_torch.infer.__main__ import main\n"
        f"main({args + ['--device', 'cpu', '--calc-flops']!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'spgan_tpu.')) or "
        "m == 'spgan_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, check=True,
                         timeout=300).stdout.splitlines()
    assert json.loads(out[-1]) == []
    fl = jax_flops(JGenerator.from_config(jax_load_config(args[1], args[3])))
    assert out[-3:-1] == [
        " [*] FLOPs per patch: all {} (SS {}, TS {})".format(
            jax_pretty(fl["flops_all"]), jax_pretty(fl["flops_ss"]),
            jax_pretty(fl["flops_ts"])),
        " [*] FLOPs per 384x768 pano (60 patches): {}".format(
            jax_pretty(fl["flops_all"] * 60))]


def test_cli_cuda_without_a_card_raises(tmp_path):
    args = _yamls(tmp_path, "planar")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--random-init"])            # --device cuda by default


def test_cli_speed_benchmark_writes_timings_and_no_images(narrow, tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "bench"
    m = main(_yamls(tmp_path, "planar", num_gen=6)
             + ["--device", "cpu", "--speed-benchmark", "--save-root",
                str(out)])
    assert len(m.accum_exec_times) == 3 and _pngs(out) == []
    day = datetime.date.today().strftime("%d-%m-%Y")
    assert (out / f"speed_benchmark_{day}.txt").is_file()
    (log,) = os.listdir(tmp_path / "logs-quant" / "benchmark_results")
    line = (tmp_path / "logs-quant" / "benchmark_results" / log).read_text()
    assert line.startswith("tiny_model: ") and "sec/image (batch 2, 3 calls)" \
        in line


def test_cli_default_save_root_full_images_and_save_idx(narrow, tmp_path,
                                                        monkeypatch):
    """--exp-suffix names the default save directory; --save_all_space adds
    the uncropped meta image; --override-save-idx starts the ids; --debug
    renders one batch."""
    monkeypatch.chdir(tmp_path)
    main(_yamls(tmp_path, "planar", num_gen=6)
         + ["--device", "cpu", "--exp-suffix", "sfx", "--save_all_space",
            "--override-save-idx", "41", "--debug"])
    out = tmp_path / "logs" / "tiny_model" / "test" / "tiny_planar_sfx"
    assert _pngs(out) == ["000041.png", "000041full.png", "000042.png",
                          "000042full.png"]
    assert _png(out / "000041.png").shape == (128, 200, 3)
    assert _png(out / "000041full.png").shape == (389, 485, 3)
    crop = _png(out / "000042full.png")[130:258, 142:342]
    np.testing.assert_array_equal(crop, _png(out / "000042.png"))


@pytest.mark.parametrize("seeds", [False, True])
def test_cli_batch_draws_and_dump_vars_reproduce(narrow, tmp_path,
                                                 monkeypatch, seeds):
    """Batch i draws its fields from one generator seeded with the seed,
    or, with task.seeds, from a generator seeded with i; --dump-vars saves
    what --inter-ckpt renders again bit for bit."""
    monkeypatch.chdir(tmp_path)
    args = _yamls(tmp_path, "planar", seeds=str(seeds).lower(),
                  num_gen=4) + ["--device", "cpu"]
    m = main(args + ["--dump-vars", "--save-root", "a"])
    main(args + ["--inter-ckpt", "a", "--save-root", "c"])
    stream = torch.Generator().manual_seed(17)
    for i in range(2):
        gl, z, noises = m.engine.sample_fields(
            torch.Generator().manual_seed(i) if seeds else stream)
        tv = TestingVars.load(f"a/{2 * i:06d}_vars.npz")
        np.testing.assert_array_equal(tv.global_latent, gl.numpy())
        np.testing.assert_array_equal(tv.local_latent, z.numpy())
        for a, b in zip(tv.noises, noises, strict=True):
            np.testing.assert_array_equal(a, b.numpy())
    assert _pngs("a") == _pngs("c") == [
        "000000.png", "000001.png", "000002.png", "000003.png"]
    for n in _pngs("a"):
        np.testing.assert_array_equal(_png(f"a/{n}"), _png(f"c/{n}"))
    assert not np.array_equal(_png("a/000000.png"), _png("a/000002.png"))


def test_cli_inv_records_paste_into_the_fields(narrow, tmp_path, monkeypatch):
    """--inv-records pastes a record at --inv-placements: a record cut
    from the very fields the seed draws leaves the images as they were; a
    record of zeros changes them."""
    monkeypatch.chdir(tmp_path)
    args = _yamls(tmp_path, "planar") + ["--device", "cpu"]
    main(args + ["--dump-vars", "--save-root", "plain"])
    tv = TestingVars.load("plain/000000_vars.npz")
    place, zh, zw = 0.4, 11, 13
    zf = tv.local_latent.shape[2]
    z0 = (int(round(place * zf)) % zf - zw // 2) % zf
    zr = (tv.local_latent.shape[1] - zh) // 2
    rec = {"z": tv.local_latent[:1, zr:zr + zh, z0:z0 + zw]}
    for i, n in enumerate(tv.noises[:3]):
        h, w = 9, 7
        c0 = (int(round(place * n.shape[2])) % n.shape[2] - w // 2) % n.shape[2]
        r0 = (n.shape[1] - h) // 2
        rec[f"noise_{i}"] = n[:1, r0:r0 + h, c0:c0 + w]
    np.savez(tmp_path / "same.npz", **rec)
    np.savez(tmp_path / "zeros.npz", **{k: np.zeros_like(v)
                                        for k, v in rec.items()})
    for name in ("same", "zeros"):
        main(args + ["--inv-records", f"{name}.npz", "--inv-placements",
                     str(place), "--save-root", name])
    for n in ("000000.png", "000001.png"):
        np.testing.assert_array_equal(_png(f"same/{n}"), _png(f"plain/{n}"))
    assert not np.array_equal(_png("zeros/000000.png"),
                              _png("plain/000000.png"))
    # the record goes into the first image of the batch only
    np.testing.assert_array_equal(_png("zeros/000001.png"),
                                  _png("plain/000001.png"))


def test_cli_profile_dir_writes_a_chrome_trace(narrow, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main(_yamls(tmp_path, "planar", num_gen=4)
         + ["--device", "cpu", "--profile-dir", "prof", "--save-root", "o"])
    with open(tmp_path / "prof" / "infer_trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    # the window carries the engine's spans, and the tracer is off after it
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"spgan.engine.generate", "spgan.generator.ts",
            "spgan.engine.to_uint8"} <= names
    assert not tracer._on
    assert _pngs("o") == ["000000.png", "000001.png", "000002.png",
                          "000003.png"]
