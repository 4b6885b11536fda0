"""The benchmark's additions for the 197-pixel patch plan and the four-rank
cell, without a card: the plan-aware count of the work
(portbench/flops_plans.py) by hand, the new per-layer readers on records
made here, and the manifest's new entries against their files."""
import pytest

from portbench import flops, flops_plans, harness


def test_ts_plan_macs_by_hand():
    """The 197 plan at the shipped widths, conv by conv: chain 11 -> 19,
    17, 31, 29, 55, 53, 103, 101, 199, 197, the upsampling convs at their
    input size."""
    m = flops_plans.ts_plan_macs(local=256, glob=512, cm=2, ts_input=11,
                                 out_res=197)
    convs = (121 * 9 * 256 * 512 + 289 * 9 * 512 * 512
             + 289 * 9 * 512 * 512 + 841 * 9 * 512 * 512
             + 841 * 9 * 512 * 512 + 2809 * 9 * 512 * 512
             + 2809 * 9 * 512 * 512 + 10201 * 9 * 512 * 512
             + 10201 * 9 * 512 * 256 + 38809 * 9 * 256 * 256)
    to_rgb = 3 * (289 * 512 + 841 * 512 + 2809 * 512 + 10201 * 512
                  + 38809 * 256)
    # the sphere skip convs at the previous ToRGB's size: 17, 29, 53, 101
    skip = 9 * 9 * (289 + 841 + 2809 + 10201)
    # each conv's style (glob x cin) and demodulation (cin x cout), each
    # ToRGB's style (glob x its input width)
    mod = (512 * (256 + 8 * 512 + 256)
           + 256 * 512 + 7 * 512 * 512 + 512 * 256 + 256 * 256
           + 512 * (4 * 512 + 256))
    assert m == {"convs": convs, "to_rgb": to_rgb, "sphere_skip": skip,
                 "modulation": mod}


def test_the_101_plan_count_is_flops_py():
    assert flops_plans.ts_plan_macs(256, 512, 2, 11, 101) == flops.ts_macs(
        256, 512, 2, 11)
    assert flops_plans.patch_flops({}) == flops.patch_flops({})


@pytest.mark.parametrize("out_res, widths", [
    (101, [512] * 6 + [512] * 2), (197, [512] * 8 + [256] * 2),
    (389, [512] * 8 + [256] * 2 + [128] * 2)])
def test_plan_widths(out_res, widths):
    assert flops_plans.ts_plan_channels(out_res, 2) == widths


def test_patches_follow_from_the_render_loops_count():
    """The cell renders the lattice render-360 renders (48 distinct
    patches of 60), and its loop's count of a panorama is the 197 plan's:
    8.21 TFLOP, 1.6-1.8 times the 101 plan's on as many patches."""
    from portbench.reference import render as ref_render

    cfg = harness.load_data("configs", "spgan-p197-bf16")
    tr = harness.load_data("traffic", "render-360-p197")
    assert ref_render.rendered_patches(cfg, tr) == 48
    p197, p101 = flops_plans.image_flops(cfg, 48), flops.image_flops(cfg, 48)
    assert 1.6 < p197 / p101 < 1.8
    assert abs(p197 / 8.2055e12 - 1) < 1e-4     # 8.21 TFLOP a panorama


def test_mfu_render_p197_reads_the_197_count():
    """The reader is mfu.render's, on the count render_spans writes."""
    cfg = harness.load_data("configs", "spgan-p197-bf16")
    rec = {"untraced_images": 160, "untraced_s": 16.0,
           "flops_per_image": flops_plans.image_flops(cfg, 48),
           "peak_flops": 989e12}
    got = harness.load_metric("mfu.render_p197").read(rec)
    assert got == pytest.approx(
        100 * flops_plans.image_flops(cfg, 48) * 10 / 989e12)
    assert got == harness.load_metric("mfu.render").read(rec)
    assert harness.load_metric("mfu.render_p197").read({}) is None


def _att(names, roots):
    return {"names": names, "roots": roots}


def test_span_share_readers():
    top = harness.load_metric("generator.ts_top_share")
    gather = harness.load_metric("engine.all_gather_share")
    att = _att({"spgan.generator.ts_top": {"device_s": 0.2, "idle_s": 0.5},
                "spgan.engine.all_gather": {"device_s": 0.01,
                                            "idle_s": 0.03}},
               {"spgan.engine.generate": {"device_s": 0.4, "idle_s": 0.4}})
    assert top.read({"spans": att}) == pytest.approx(50.0)
    assert gather.read({"spans": att}) == pytest.approx(5.0)
    # silent without the spans, as on a program that lacks them
    empty = _att({}, {"spgan.engine.generate": {"device_s": 0.4}})
    for reader in (top, gather):
        assert reader.read({}) is None
        assert reader.read({"spans": empty}) is None


def test_manifest_entries_of_the_new_cells():
    m = harness.load_manifest()
    cfg = next(c for c in m["configs"] if c["name"] == "spgan-p197-bf16")
    assert cfg["reduced"] == []
    assert cfg["source"].startswith(
        "https://github.com/chronos123/SP-GAN-TIP2025 ")
    new = harness.load_data("configs", "spgan-p197-bf16")
    old = harness.load_data("configs", "spgan-bf16")
    changed = {k for k in old["train_params"]
               if old["train_params"][k] != new["train_params"][k]}
    assert changed == {"patch_size", "full_size"}
    assert new["train_params"]["patch_size"] == 197
    assert new["assumed"]["full_size"] == new["train_params"]["full_size"]
    cells = {c["name"]: c for c in m["workloads"]}
    assert cells["render-360-p197-bf16"]["chips"] == 1
    assert cells["scale-360-bf16-4chip"]["chips"] == 4
    for name in ("render-360-p197-bf16", "scale-360-bf16-4chip"):
        layer = {x["name"] for x in harness.per_layer_of(m, name)}
        e2e = {x["name"] for x in harness.end_to_end_of(m, name)}
        assert e2e == {"images_per_s", "peak_mem_gib", "setup_s"}
        assert "device_idle.render" in layer and "mfu.render" not in layer
        tr = harness.load_data("traffic", cells[name]["traffic"])
        harness.load_loop(tr["loop"])
        assert set(harness.limits_of(name)) == {"mean_lsb",
                                                "worst_image_lsb"}
    assert {x["name"] for x in harness.per_layer_of(
        m, "render-360-p197-bf16")} == {
        "device_idle.render", "mfu.render_p197", "generator.ts_top_share"}
    assert {x["name"] for x in harness.per_layer_of(
        m, "scale-360-bf16-4chip")} == {
        "device_idle.render", "engine.all_gather_share"}


P197_RUN = """
import json, pathlib, shutil, sys, time, torch
torch.set_num_threads(2)
from portbench import harness
tmp = pathlib.Path(sys.argv[1])
root = tmp / "portbench"
shutil.copytree(harness.HERE / "metrics", root / "metrics")
for d in ("configs", "traffic", "limits"):
    (root / d).mkdir(parents=True)
config = {"train_params": {"global_latent_dim": 32, "local_latent_dim": 16,
                           "channel_multiplier": 1, "n_mlp": 2,
                           "ss_n_layers": 2, "patch_size": 197,
                           "compute_dtype": "float32"},
          "ts_channel_base": 16, "assumed": {"to_rgb_rms": 0.02}}
(root / "configs" / "tiny.json").write_text(json.dumps(config))
tr = harness.load_data("traffic", "render-360-p197")
tr["task"] = dict(tr["task"], batch_size=1)
tr.update(traced_units=1, check_images=2)
(root / "traffic" / "p197-tiny.json").write_text(json.dumps(tr))
shutil.copy(harness.HERE / "limits" / "render-planar-f32.json",
            root / "limits" / "p197-tiny.json")
m = harness.load_manifest()
m["workloads"] = [{"name": "p197-tiny", "config": "tiny",
                   "traffic": "p197-tiny", "chips": 1, "why": "test"}]
for x in m["end_to_end"] + m["per_layer"]:
    if "workloads" in x:
        x["workloads"] = (["p197-tiny"] if "render-360-p197-bf16"
                          in x["workloads"] else [])
r, out = harness.run_cell("p197-tiny", 2 ** 35 + 3, 0.0, True,
                          t0=time.perf_counter(), device="cpu", manifest=m,
                          root=root)
print(json.dumps({"result": r, "spans": out.records["spans"]["names"],
                  "counters": out.records["counters"],
                  "flops_per_image": out.records["flops_per_image"],
                  "config": config,
                  "forbidden": harness.forbidden_modules()}))
"""


def test_the_p197_cell_runs_traced_and_loads_no_jax(tmp_path):
    """The cell's loop (loops/render_spans.py) on the tiny widths at the
    cell's 768x1536, traced, in a fresh process (the test process holds
    JAX): `correct` against the plain reference in float32, its ToRGB
    calibration at the cell's own size, the program's spans joined over
    the traced stretch (the ts_top span once a chunk, the counter at 4
    sphere skip convs a chunk) and no module of JAX or the JAX package
    loaded."""
    import json
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "-c", P197_RUN, str(tmp_path)],
                       capture_output=True, text=True, cwd=harness.REPO,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.splitlines()[-1])
    assert got["forbidden"] == []
    r = got["result"]
    assert r["correct"] is True
    assert {"device_idle.render", "mfu.render_p197"} <= set(r["metrics"])
    assert got["flops_per_image"] == flops_plans.image_flops(got["config"],
                                                             48)
    chunks = 48 // 4
    assert got["spans"]["spgan.generator.ts_top"]["count"] == chunks
    assert got["counters"]["spgan.generator.sphere_skip"] == 4 * chunks
