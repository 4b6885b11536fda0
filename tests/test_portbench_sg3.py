"""The benchmark's additions for StyleGAN3-T and the early training cell,
without a card: the count of the work (portbench/flops_sg3.py) by hand,
the new per-layer readers on records made here, the manifest's new
entries against their files, and the new loop (loops/render_image.py) on a
tiny StyleGAN3 in a fresh process."""
import json
import subprocess
import sys

import pytest

from portbench import flops_sg3, harness
from portbench.reference import stylegan3 as ref

SG = harness.load_data("configs", "stylegan3-t-1024")["stylegan3"]


# L0-L14 of StyleGAN3-T at 1024x1024: input size, output size, widths
IN = [36, 36, 36, 52, 52, 84, 148, 148, 276, 276, 532, 1044, 1044, 1044, 1024]
OUT = IN[1:] + [1024]
CIN = [512] * 8 + [323, 203, 128, 81, 51, 32, 32]
COUT = CIN[1:] + [3]


def test_conv_macs_by_hand():
    """Each layer's conv at its output size in_size + 2 (padding k - 1),
    L0-L13 3x3, the ToRGB 1x1: 285.2 G multiply-accumulates an image."""
    want = sum((IN[i] + 2) ** 2 * 9 * CIN[i] * COUT[i] for i in range(14))
    want += 1024 ** 2 * 32 * 3
    assert flops_sg3.layer_macs(SG)["convs"] == want
    assert abs(flops_sg3.image_flops(SG) / 571.13e9 - 1) < 1e-4


def test_filtered_lrelu_bytes_by_hand():
    """The conv output read once and the layer output written once, 4
    bytes in L0-L4, 2 in L5-L13 (float16), the ToRGB left out."""
    want = sum(((IN[i] + 2) ** 2 + OUT[i] ** 2) * COUT[i]
               * (4 if i < 5 else 2) for i in range(14))
    assert flops_sg3.filtered_lrelu_bytes(SG) == want
    assert flops_sg3.filtered_lrelu_bytes(dict(SG, num_fp16_res=0)) > want


def _att(part, whole):
    return {"names": {"spgan.sg3.filtered_lrelu": {"device_s": part}},
            "roots": {"spgan.engine.generate": {"device_s": whole}}}


def test_new_readers():
    share = harness.load_metric("sg3.filtered_lrelu_share")
    roof = harness.load_metric("filtered_lrelu_roofline")
    rec = {"spans": _att(0.3, 0.5), "filtered_lrelu_bytes": 1.0e9,
           "traced_images": 32}
    assert share.read(rec) == pytest.approx(60.0)
    assert roof.read(rec) == pytest.approx(100 * 32e9 / 3.35e12 / 0.3)
    # silent without the spans, as on a program that lacks them
    for reader in (share, roof):
        assert reader.read({}) is None
        assert reader.read({"spans": _att(0.0, 0.5),
                            "filtered_lrelu_bytes": 1.0,
                            "traced_images": 1}) is None


def test_manifest_entries_of_the_new_cells():
    m = harness.load_manifest()
    cfg = next(c for c in m["configs"] if c["name"] == "stylegan3-t-1024")
    assert cfg["reduced"] == []
    assert cfg["source"].startswith("https://github.com/NVlabs/stylegan3 ")
    assert ref.schedule(SG)["num_ws"] == 16
    cells = {c["name"]: c for c in m["workloads"]}
    assert cells["render-sg3t-1024"]["chips"] == 1
    assert cells["train-f32-early"]["chips"] == 1
    sg3 = {x["name"] for x in harness.per_layer_of(m, "render-sg3t-1024")}
    assert sg3 == {"mfu.render", "device_idle.render",
                   "engine.launches_per_image", "generator.elementwise_share",
                   "sg3.filtered_lrelu_share", "filtered_lrelu_roofline"}
    early = {x["name"] for x in harness.per_layer_of(m, "train-f32-early")}
    assert early == {"device_idle.train", "sphere_sample_roofline",
                     "train.reg_iter_ms"}
    assert {x["name"] for x in harness.end_to_end_of(
        m, "render-sg3t-1024")} == {"images_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert {x["name"] for x in harness.end_to_end_of(
        m, "train-f32-early")} == {"train_iter_ms", "peak_mem_gib",
                                   "setup_s"}
    for name in ("render-sg3t-1024", "train-f32-early"):
        tr = harness.load_data("traffic", cells[name]["traffic"])
        harness.load_loop(tr["loop"])
        assert set(harness.limits_of(name))


def test_the_early_cell_is_plain_and_r1_steps():
    """From iteration 50000 a cycle has R1 on its first iteration and no
    PPL (g_path_start 100000); its loop is the training loop."""
    from portbench.loops import train, train_early
    from portbench.reference import train as ref_train
    from portbench.reference.spgan.config import Config

    tr = harness.load_data("traffic", "train-early")
    assert train_early.run is train.run
    cfg = Config()
    start = tr["start_iteration"]
    flags = [ref_train.schedule(cfg, it) for it in range(start, start + 16)]
    assert [i for i, (r1, _) in enumerate(flags) if r1] == [0]
    assert not any(ppl for _, ppl in flags)


SG3_RUN = """
import json, pathlib, shutil, sys, time, torch
torch.set_num_threads(2)
from portbench import harness
tmp = pathlib.Path(sys.argv[1])
root = tmp / "portbench"
shutil.copytree(harness.HERE / "metrics", root / "metrics")
for d in ("configs", "traffic", "limits"):
    (root / d).mkdir(parents=True)
config = harness.load_data("configs", "stylegan3-t-1024")
config["stylegan3"].update(img_resolution=64, num_layers=6,
                           channel_base=1024, channel_max=32, margin_size=4)
(root / "configs" / "tiny.json").write_text(json.dumps(config))
tr = harness.load_data("traffic", "render-image-1024")
tr["task"] = dict(tr["task"], batch_size=2, height=64, width=64)
tr.update(traced_units=1, check_images=2, calibration_images=2)
(root / "traffic" / "sg3-tiny.json").write_text(json.dumps(tr))
shutil.copy(harness.HERE / "limits" / "render-sg3t-1024.json",
            root / "limits" / "sg3-tiny.json")
m = harness.load_manifest()
m["workloads"] = [{"name": "sg3-tiny", "config": "tiny",
                   "traffic": "sg3-tiny", "chips": 1, "why": "test"}]
for x in m["end_to_end"] + m["per_layer"]:
    if "workloads" in x:
        x["workloads"] = (["sg3-tiny"] if "render-sg3t-1024"
                          in x["workloads"] else [])
r, out = harness.run_cell("sg3-tiny", 2 ** 35 + 3, 0.0, True,
                          t0=time.perf_counter(), device="cpu", manifest=m,
                          root=root)
print(json.dumps({"result": r, "spans": out.records["spans"]["names"],
                  "counters": out.records["counters"],
                  "flops_per_image": out.records["flops_per_image"],
                  "forbidden": harness.forbidden_modules()}))
"""


def test_the_sg3_cell_runs_traced_and_loads_no_jax(tmp_path):
    """The cell's loop on a tiny StyleGAN3 (64x64, 6 layers), traced, in a
    fresh process (the test process holds JAX): `correct` against the
    plain reference in float32, the program's spans joined over the
    traced stretch (the filtered LeakyReLU once a layer but the ToRGB's),
    every layer counted as float32 on the CPU, and no module of JAX or
    the JAX package loaded."""
    p = subprocess.run([sys.executable, "-c", SG3_RUN, str(tmp_path)],
                       capture_output=True, text=True, cwd=harness.REPO,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.splitlines()[-1])
    assert got["forbidden"] == []
    r = got["result"]
    assert r["correct"] is True
    assert r["attempted"] == 2
    assert {"device_idle.render", "mfu.render"} <= set(r["metrics"])
    assert got["spans"]["spgan.sg3.filtered_lrelu"]["count"] == 6
    assert got["spans"]["spgan.sg3.input"]["count"] == 1
    assert got["counters"]["spgan.sg3.layers_fp32"] == 7
    assert got["counters"]["spgan.engine.batches"] == 1
