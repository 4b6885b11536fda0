"""Whole runs of tiny cells on the CPU: the window rules, the controls
and the faults the comparison has to catch (the look for a chip
skipped, the program's timed path broken underneath)."""
from __future__ import annotations

import pytest
import torch

from portbench import probe
from portbench.reference import train as ref_train
from portbench.tests import tiny


@pytest.fixture
def root_f32(tmp_path):
    return tiny.make_root(tmp_path, "float32")


@pytest.fixture
def root_bf16(tmp_path):
    return tiny.make_root(tmp_path, "bfloat16")


# ------------------------------------------------------------ window rules

def test_training_window_is_whole_cycles(root_f32):
    r = tiny.run(root_f32, "train-tiny", seconds=0.0)
    assert r["correct"] is True
    assert r["attempted"] == 16          # one whole cycle, at least


def test_lazy_schedule():
    from portbench.reference.spgan.config import Config
    cfg = Config()
    flags = [ref_train.schedule(cfg, it) for it in range(100000, 100016)]
    assert [i for i, (r1, _) in enumerate(flags) if r1] == [0]
    assert [i for i, (_, ppl) in enumerate(flags) if ppl] == [0, 4, 8, 12]
    assert ref_train.schedule(cfg, 99996) == (False, False)


# ---------------------------------------------------------------- controls

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_render_control_reads_past_the_program(tmp_path, dtype):
    """The reference in the next lower precision in the program's place
    (fp8 operands for bfloat16, TF32 for float32) reads at least three
    times what the program reads on the same seed and sample, which is
    what makes it an upper reading.  (At these widths the numbers are far
    smaller than at the cells' sizes, where the limits were set.)"""
    from portbench import harness
    root = tiny.make_root(tmp_path, dtype)
    files = (harness.load_data("configs", "tiny", root),
             harness.load_data("traffic", "render-tiny", root))
    program = tiny.run(root, "render-tiny", seed=3)["checks"]
    control = probe.control_reading(files, 3, torch.device("cpu"), 1)
    for k in ("mean_lsb", "worst_image_lsb"):
        assert control[k] > 0
        assert control[k] >= 3 * program[k]["value"], (control, program)


def test_train_control_fails(root_f32):
    from portbench import harness
    files = (harness.load_data("configs", "tiny-f32", root_f32),
             harness.load_data("traffic", "train-tiny", root_f32))
    got = probe.control_reading(files, 3, torch.device("cpu"), 4)
    limits = harness.limits_of("train-tiny", root_f32)
    assert any(got[k] > limits[k] for k in limits), (got, limits)


# ------------------------------------------------------------------ faults

def test_sound_runs_are_correct(root_bf16):
    assert tiny.run(root_bf16, "render-tiny", seconds=1.0)["correct"] is True


def test_fault_answer_altered_render(root_f32, monkeypatch):
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    crop = PanoramaEngine.crop_to_target

    def altered(self, meta):
        out = crop(self, meta).clone()
        out[0] += 0.25
        return out

    monkeypatch.setattr(PanoramaEngine, "crop_to_target", altered)
    assert tiny.run(root_f32, "render-tiny")["correct"] is False


def test_fault_half_batch_render(root_f32, monkeypatch):
    from spgan_tpu_torch.infer import engine
    render = engine.render_patches

    def half(*a, **kw):
        out = render(*a, **kw)
        out[:, out.shape[1] // 2:] = 0
        return out

    monkeypatch.setattr(engine, "render_patches", half)
    assert tiny.run(root_f32, "render-tiny")["correct"] is False


def test_fault_state_unchanged(root_f32, monkeypatch):
    from spgan_tpu_torch.train.step import TrainStep
    call = TrainStep.__call__

    def unchanged(self, state, *a, **kw):
        _, metrics = call(self, state, *a, **kw)
        return state, metrics

    monkeypatch.setattr(TrainStep, "__call__", unchanged)
    r = tiny.run(root_f32, "train-tiny")
    assert r["correct"] is False
    assert r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", sorted(probe.FAULTS))
def test_fault_half_batch_train(root_f32, fault):
    """Half of the batch left out of the D or the G loss, the mean taken
    over the rest."""
    from spgan_tpu_torch.models import losses
    with probe.half_batch(fault, losses):
        r = tiny.run(root_f32, "train-tiny")
    assert r["correct"] is False


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the headline cell on a CUDA device."""
    import json
    import subprocess
    import sys

    from portbench import harness
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "render-360-bf16", "--seed", "2147483659",
                        "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.REPO,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.splitlines()[-1])["correct"] is True
