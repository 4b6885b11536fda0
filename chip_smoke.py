#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build   every kernel in spgan_tpu_torch/csrc/ with nvcc (sm_90a)
  2. kernels each kernel against its plain PyTorch version on the card, at
             the SS shapes of the panorama engine (B=64, C=Cout=256,
             H=W in {35,29,23,17}), float32 (TF32 off) and bf16; kernel
             and plain times at the bench shapes (bf16)
  3. parity  a tiny close-loop engine on cuda (kernel) vs the same engine
             on cpu (plain version), same weights and fields, float32
  4. engine  the shipped model at full width (Config() defaults, random
             weights from a fixed seed): close-loop 384x768, batch 16,
             bf16, patch_chunk 4; one warm-up generate, then timed ones;
             the grouped kernel must launch 48 times per generate
  5. patch   Generator.apply at full width on 16 per-sample crops: the
             per-sample kernel must launch once per SS layer
Then prints the kernels JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}.  Imports no JAX.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense bf16, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
SS_SIZES = (35, 29, 23, 17)
TIMED_GENERATES = 5


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance "
            f"(atol {atol}, rtol {rtol}), max abs err {float(err.max()):.3e}")
    return float(err.max())


def tiny_config(Config):
    cfg = Config()
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    return cfg


def phase_build():
    from spgan_tpu_torch.ops.kernels import build

    names = sorted(p.stem for p in build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(names)
    dt = time.perf_counter() - t0
    print(f"[build] {names} in {dt:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def ss_tables(positions, H):
    """Offset tables of the shipped 384x768 plan's lattice positions."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.coords import CoordsPartial
    from spgan_tpu_torch.geometry.sphere_grid import sphere_offset_tables_batch
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator

    g = Generator.from_config(Config())
    plan = build_close_loop_plan(g, 384, 768)
    cp = CoordsPartial.from_scalars(plan.cp_scalars[positions], plan.x_total,
                                    plan.y_total, 0.6667)
    t = sphere_offset_tables_batch(cp, H, H)
    return {k: v.cuda().contiguous() for k, v in t.items()}


def phase_kernels():
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    B, G, C = 64, 4, 256
    rng = np.random.RandomState(0)
    results = {"fused_sphere_conv_grouped": {}, "fused_sphere_conv": {}}
    positions = rng.choice(48, G, replace=False)
    for H in SS_SIZES:
        tg = ss_tables(positions, H)
        tp = {k: v.repeat_interleave(B // G, dim=0).contiguous()
              for k, v in tg.items()}
        x32 = torch.as_tensor(rng.randn(B, H, H, C).astype(np.float32)).cuda()
        w32 = torch.as_tensor((rng.randn(9, C, C) / math.sqrt(9 * C))
                              .astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x, w9 = x32.to(dtype), w32.to(dtype)
            if dtype == torch.float32:
                # float32 sums of 9*C products in another order
                atol, rtol = 2e-4 * math.sqrt(C / 16), 1e-4
            else:
                # identical bf16 taps; f32 accumulation order may move the
                # final bf16 rounding by one ulp (2^-8 relative)
                atol, rtol = 1e-3, 2 ** -7
            ref = sk.fused_sphere_conv_plain(x, tg, w9, G)
            for name, fn in (
                    ("fused_sphere_conv_grouped",
                     lambda: sk.fused_sphere_conv_grouped(x, tg, w9, G)),
                    ("fused_sphere_conv",
                     lambda: sk.fused_sphere_conv(x, tp, w9))):
                got = fn()
                torch.cuda.synchronize()
                err = check_close(f"{name} H={H} {dtype}", got, ref, atol, rtol)
                print(f"[kernels] {name} H={H} {str(dtype)[6:]}: "
                      f"max_abs_err {err:.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
                if dtype == torch.bfloat16:
                    r = results[name].setdefault(H, {})
                    r["err"] = err
        # times at the bench shapes (bf16): the grouped kernel at the
        # engine's B=64, the per-sample kernel at Generator.apply's B=16
        xb, wb = x32.to(torch.bfloat16), w32.to(torch.bfloat16)
        x16 = xb[:16].contiguous()
        tp16 = {k: v[:16].contiguous() for k, v in tp.items()}
        cases = {
            "fused_sphere_conv_grouped": (
                B, lambda: sk.fused_sphere_conv_grouped(xb, tg, wb, G),
                lambda: sk.fused_sphere_conv_plain(xb, tg, wb, G)),
            "fused_sphere_conv": (
                16, lambda: sk.fused_sphere_conv(x16, tp16, wb),
                lambda: sk.fused_sphere_conv_plain(x16, tp16, wb, 16)),
        }
        for name, (b, kern, plain) in cases.items():
            r = results[name][H]
            r["ms"] = time_ms(kern, 20)
            r["plain_ms"] = time_ms(plain, 3, warmup=1)
            flops = 2.0 * b * H * H * 9 * C * C
            nbytes = (b * H * H * C * 2 + 9 * C * C * 2 + b * H * H * C * 2
                      + 5 * (b if name == "fused_sphere_conv" else G) * H * 9 * 4)
            r["bound_ms"] = max(flops / H100_BF16_FLOPS,
                                nbytes / H100_BYTES_PER_S) * 1e3
            r["bound_by"] = ("operations" if flops / H100_BF16_FLOPS
                             >= nbytes / H100_BYTES_PER_S else "bytes")
            r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
            # yardstick only (not the same function): cuDNN's dense 3x3
            # conv of the same B, H, C, Cout, i.e. the same FLOPs
            xc = xb[:b].permute(0, 3, 1, 2)
            wc = wb.reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous()
            r["dense_conv_ms"] = time_ms(
                lambda: torch.nn.functional.conv2d(xc, wc, padding=1), 20)
            print(f"[kernels] {name} H={H} B={b} bf16: {r['ms']:.4f} ms "
                  f"({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"cuDNN dense 3x3 conv {r['dense_conv_ms']:.4f} ms")
    return results


def phase_parity():
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    g = Generator.from_config(tiny_config(Config))
    object.__setattr__(g.ts, "channel_base", 48)
    plan = build_close_loop_plan(g, 128, 672)
    metas = {}
    for dev in ("cpu", "cuda"):
        params = g.init(torch.Generator().manual_seed(0), device=dev)
        eng = PanoramaEngine(g=g, plan=plan, batch=2, patch_chunk=4,
                             grid_partial=0.6667, device=dev)
        gl, z, noises = PanoramaEngine(
            g=g, plan=plan, batch=2, device="cpu").sample_fields(
                torch.Generator().manual_seed(3))
        sk.fused_sphere_conv_grouped.launches = 0
        metas[dev] = eng.generate_from_fields(
            params, gl.to(dev), z.to(dev), [n.to(dev) for n in noises]).cpu()
    launched = sk.fused_sphere_conv_grouped.launches
    want = g.ss.n_layers * len(eng._render_idx) // eng.patch_chunk
    if launched != want:
        raise AssertionError(f"tiny engine on cuda: {launched} grouped-kernel "
                             f"launches, want {want}")
    # float32, TF32 off: the same math in another summation order
    err = check_close("tiny engine cuda vs cpu", metas["cuda"], metas["cpu"],
                      2e-4, 0.0)
    print(f"[parity] tiny close-loop meta {tuple(metas['cuda'].shape)}: "
          f"cuda (kernel, {launched} launches) vs cpu (plain) max_abs_err "
          f"{err:.3e} (atol 2e-4)")


def phase_engine(card_str):
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    cfg = Config()
    g = Generator.from_config(cfg)
    params = g.init(torch.Generator().manual_seed(0), device="cuda")
    plan = build_close_loop_plan(g, cfg.task.height, cfg.task.width)
    eng = PanoramaEngine(g=g, plan=plan, batch=cfg.task.batch_size,
                         patch_chunk=cfg.task.patch_chunk,
                         grid_partial=cfg.train_params.partial,
                         compute_dtype="bfloat16", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    meta = eng.generate(params, gen)
    torch.cuda.synchronize()
    print(f"[engine] warm-up generate {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    sk.fused_sphere_conv_grouped.launches = 0
    sk.fused_sphere_conv.launches = 0
    per_ms = []
    for _ in range(TIMED_GENERATES):
        t0 = time.perf_counter()
        meta = eng.generate(params, gen)
        torch.cuda.synchronize()
        per_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
                "fused_sphere_conv": sk.fused_sphere_conv.launches}
    dt = sum(per_ms) / 1e3
    want = (cfg.task.batch_size, 581, 768, 3)
    if tuple(meta.shape) != want or not bool(meta.isfinite().all()):
        raise AssertionError(f"meta {tuple(meta.shape)} (want {want}), "
                             f"finite={bool(meta.isfinite().all())}")
    per_gen = launches["fused_sphere_conv_grouped"] / TIMED_GENERATES
    if per_gen != 48 or launches["fused_sphere_conv"]:
        raise AssertionError(f"kernel launches per generate {launches} / "
                             f"{TIMED_GENERATES} (want 48 grouped)")
    panos = TIMED_GENERATES * cfg.task.batch_size / dt
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[engine] {card_str}: close-loop 384x768 batch "
          f"{cfg.task.batch_size} bf16: {panos:.4f} panoramas/s "
          f"({dt / TIMED_GENERATES * 1e3:.1f} ms per generate; each "
          f"{', '.join(f'{t:.1f}' for t in per_ms)} ms), peak memory "
          f"{peak:.2f} GiB, meta {tuple(meta.shape)} finite, "
          f"{per_gen:.0f} grouped-kernel launches per generate")
    busy_ms = trace_generate(lambda: eng.generate(params, gen))
    untraced_ms = float(np.median(per_ms))
    print(f"[trace] device busy {busy_ms:.1f} ms of the untraced median "
          f"generate {untraced_ms:.1f} ms: idle share "
          f"{100 * (1 - busy_ms / untraced_ms):.1f}%")
    return {k: v // TIMED_GENERATES for k, v in launches.items()}


def trace_generate(run, top=12):
    """Device time by kernel over one generate (torch.profiler), and the
    device's busy share of the generate's wall time under the profiler.
    Returns the device-busy milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[trace] one generate under the profiler: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"[trace] {ms:9.2f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
              f"x{e.count:<5d} {e.key[:110]}")
    return busy_ms


def phase_patch():
    """Generator.apply on 16 per-sample crops of the shipped plan."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.coords import CoordsPartial
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.spatial import out_size_chain

    cfg = Config()
    g = Generator.from_config(cfg)
    params = g.init(torch.Generator().manual_seed(0), device="cuda")
    plan = build_close_loop_plan(g, 384, 768)
    B, win = 16, plan.window
    pos = np.arange(B) * 3
    cp = CoordsPartial.from_scalars(plan.cp_scalars[pos], plan.x_total,
                                    plan.y_total, cfg.train_params.partial)
    field = g.ss.coord_grid.test_field(plan.z_field_h, plan.z_field_w)
    field = np.concatenate([field, field[:, :win]], axis=1)
    coords = np.stack([field[r:r + win, c:c + win]
                       for r, c in plan.z_starts[pos]])
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    gl = torch.randn((B, 2, 512), generator=gen, device="cuda").to(bf)
    z = torch.randn((B, win, win, 256), generator=gen, device="cuda").to(bf)
    noises = [torch.randn((B, s, s, 1), generator=gen, device="cuda").to(bf)
              for s in out_size_chain(g.ts.conv_specs_spatial(), 11)]
    sk.fused_sphere_conv_grouped.launches = 0
    sk.fused_sphere_conv.launches = 0
    with torch.inference_mode():
        img = g.apply(params, global_latent=gl, local_latent=z,
                      coords=torch.as_tensor(coords).cuda(), cp=cp,
                      noises=noises)
    torch.cuda.synchronize()
    launches = {"fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
                "fused_sphere_conv": sk.fused_sphere_conv.launches}
    if tuple(img.shape) != (B, 101, 101, 3) or not bool(img.isfinite().all()):
        raise AssertionError(f"patch {tuple(img.shape)} finite="
                             f"{bool(img.isfinite().all())}")
    if launches != {"fused_sphere_conv_grouped": 0,
                    "fused_sphere_conv": g.ss.n_layers}:
        raise AssertionError(f"patch-forward launches {launches}")
    print(f"[patch] Generator.apply batch {B} bf16: {tuple(img.shape)} "
          f"finite, launches {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import spgan_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_str = card()
    print(f"[env] {card_str}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    phase_build()
    kern = phase_kernels()
    phase_parity()
    engine_launches = phase_engine(card_str)
    patch_launches = phase_patch()

    replaces = {
        "fused_sphere_conv_grouped": "spgan_tpu/ops/pallas/sphere_kernel.py:120",
        "fused_sphere_conv": "spgan_tpu/ops/pallas/sphere_kernel.py:225"}
    path_launches = {"fused_sphere_conv_grouped": engine_launches,
                     "fused_sphere_conv": patch_launches}
    line = []
    for name, per_h in kern.items():
        line.append({
            "name": name, "route": "cuda",
            "source": "spgan_tpu_torch/csrc/sphere_conv.cu",
            "replaces": replaces[name],
            "launches": path_launches[name][name],
            "max_abs_err": max(r["err"] for r in per_h.values()),
            # one launch at each of the four SS shapes, bf16
            "ms": sum(r["ms"] for r in per_h.values()),
            "plain_ms": sum(r["plain_ms"] for r in per_h.values()),
            "bound_ms": sum(r["bound_ms"] for r in per_h.values()),
            "bound_by": per_h[35]["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": line}))
    print(card_str)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
