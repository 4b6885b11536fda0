"""The benchmark's frame on the CPU: files found by name, extension by
adding files, the result line's keys, the counts of the work, and the
look for JAX."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import flops, harness
from portbench.tests import tiny


def test_every_manifest_name_has_its_files():
    m = harness.load_manifest()
    for cell in m["workloads"]:
        harness.load_data("configs", cell["config"])
        tr = harness.load_data("traffic", cell["traffic"])
        harness.load_loop(tr["loop"])
        assert set(harness.limits_of(cell["name"]))
    for metric in m["per_layer"]:
        assert callable(harness.load_metric(metric["name"]).read)
    for c in m["configs"]:
        assert (harness.REPO / c["file"]).is_file()


def test_metrics_of_a_cell():
    m = harness.load_manifest()
    e2e = {x["name"] for x in harness.end_to_end_of(m, "train-f32-lazyreg")}
    assert e2e == {"train_iter_ms", "peak_mem_gib", "setup_s"}
    layer = {x["name"] for x in harness.per_layer_of(m, "render-360-bf16")}
    assert "mfu.render" in layer and "mfu.train" not in layer


def test_a_metric_file_added_is_read_without_edits(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "metrics" / "dummy.images.py").write_text(
        "def read(records):\n"
        "    return float(records['untraced_images'])\n")
    (root / "metrics" / "dummy.silent.py").write_text(
        "def read(records):\n    return None\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name in ("dummy.images", "dummy.silent"):
        manifest["per_layer"].append(
            {"name": name, "unit": "images", "better": "higher",
             "source": "host_clock", "layer": "engine",
             "moves": "images_per_s", "workloads": ["render-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = tiny.run(root, "render-tiny", trace=True)
    assert r["metrics"]["dummy.images"]["value"] == r["attempted"]
    assert "dummy.silent" not in r["metrics"]


def test_result_keys(tmp_path):
    root = tiny.make_root(tmp_path)
    r = tiny.run(root, "render-tiny")
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"images_per_s", "peak_mem_gib", "setup_s"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_result_keys(tmp_path):
    root = tiny.make_root(tmp_path)
    r = tiny.run(root, "render-tiny", trace=True)
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"busy_s", "window_s"}
    assert {"mfu.render", "engine.launches_per_image"} <= set(r["metrics"])
    for lst in r["breakdown"].values():
        assert len(lst) <= 10


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "render-360-bf16", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=harness.REPO,
                       timeout=300)
    if p.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert p.stdout == ""


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(
        ["spgan_tpu_torch", "spgan_tpu_torch.ops", "jaxtyping", "flaxen",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "spgan_tpu.ops"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "spgan_tpu.ops"]


def test_a_run_loads_no_jax(tmp_path):
    """Every module a tiny run of each timed loop loads, in a fresh process."""
    code = (
        "import sys, json, pathlib, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        f"root = tiny.make_root(pathlib.Path({str(tmp_path)!r}))\n"
        "tiny.run(root, 'render-tiny', seconds=1.0)\n"
        "tiny.run(root, 'train-tiny')\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=harness.REPO, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


# ---------------------------------------------------------------- counts

def test_ss_macs_by_hand():
    m = flops.ss_macs(local=2, glob=1, coord=1, n_layers=1, radius=1,
                      window=5)
    assert m == {"sphere_latent": 25 * 9 * 2 * 2,
                 "sphere_coords": 25 * 9 * 1 * 2,
                 "sc": 25 * 2 * 2,
                 "planar": 3 * 3 * 9 * 3 * 2,
                 "modulation": 2 * (1 * 3 + 3 * 2)}


def test_ts_chain_and_widths():
    assert [o for _, o in flops._conv_chain(11, [i % 2 == 0
                                                 for i in range(8)])] == [
        19, 17, 31, 29, 55, 53, 103, 101]
    convs = flops.ts_macs(local=256, glob=512, cm=2, ts_input=11)["convs"]
    # transposed convs at their input size: 11, 17, 29, 53
    want = (121 * 9 * 256 * 512 + 289 * 9 * 512 * 512
            + 289 * 9 * 512 * 512 + 841 * 9 * 512 * 512
            + 841 * 9 * 512 * 512 + 2809 * 9 * 512 * 512
            + 2809 * 9 * 512 * 512 + 10201 * 9 * 512 * 512)
    assert convs == want


def test_d_macs_by_hand():
    # patch 8: log size 3, stem 3 -> 512 at 8x8; one block 8 -> 4
    macs = flops.d_macs(8, 1, linear_ch=2, ac_out=3)
    want = (64 * 3 * 512 + 64 * 9 * 512 * 512 + 16 * 9 * 512 * 512
            + 16 * 512 * 512 + 16 * 9 * 513 * 2
            + (2 * 16) * 2 + 2 + (2 * 16) * 2 + 2 * 3)
    assert macs == want


def test_kernel_work_by_hand():
    assert flops.sphere_conv_flops([(1, 2, 3, 4, 5, 9)]) == 2 * 2 * 3 * 9 * 4 * 5
    # input 2*3*4 elements, output 9 times that, bf16; 5 tables of 2x9 int32
    assert flops.sphere_sample_bytes([(1, 2, 3, 4, 9, 2)]) == (
        2 * (24 + 216) + 5 * 4 * 2 * 9)


def test_cycle_parts_add_up():
    parts = flops.train_cycle_flops({})
    assert parts["total"] == parts["plain"] + parts["r1"] + parts["ppl"]
    p = flops.patch_flops({})
    assert abs(p["ts"] / 2 / 42.8e9 - 1) < 2e-3   # 42.8 G by hand
