#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build   every kernel in spgan_tpu_torch/csrc/ with nvcc (sm_90a), one
             nvcc per source, all started together; registers, spills and
             dynamic shared memory of the sphere conv, and HGMMA (wgmma)
             in its SASS; the tap sampler's memory instructions in its SASS
  2. kernels each kernel against its plain PyTorch version on the card:
             the sphere conv at the SS shapes of the panorama engine
             (B=64, C=Cout=256, H=W in {35,29,23,17}), the tap sampler at
             the SS shapes of the training step (B=16, C=259, the same
             H), float32 (TF32 off) and bf16; kernel, plain, bound and
             library times, TFLOP/s and share of the bound, and cuDNN's
             dense 3x3 conv of the same FLOPs as a yardstick; for the tap
             sampler also its device time (torch.profiler), GB/s, the
             distinct input rows per output row and its row slots
  3. parity  a tiny close-loop engine on cuda (kernel) vs the same engine
             on cpu (plain version), same weights and fields, float32
  3b. infer-parity  the same for a tiny planar (infinite) engine
  4. engine  the shipped model at full width (Config() defaults, random
             weights from a fixed seed): close-loop 384x768, batch 16,
             bf16, patch_chunk 4; one warm-up generate, then timed ones;
             the grouped kernel must launch 48 times per generate; one
             traced generate, with the sphere conv's device time
  4b. cli   the inference CLI (python -m spgan_tpu_torch.infer), called
             in-process at full width with random weights: close-loop
             384x768 bf16 (configs/model/spgan_run5k_bf16.yaml), 16
             batches with --speed-benchmark, 48 grouped-kernel launches a
             batch; planar 256x512 float32 (configs/model/spgan.yaml +
             configs/test/spgan_infinite_256x512.yaml): 8 PNGs of 512x256
             read back, the grouped kernel's float32 body against its
             plain version on that run's tables and weights, then 16
             batches with --speed-benchmark, 40 launches a batch;
             sec/image of each after test.py's 10 warm-up batches, and
             the close-loop manager's run_next against a bare
             engine.generate, in turns
  5. patch   Generator.apply at full width on 16 per-sample crops: the
             per-sample kernel must launch once per SS layer
  6. train-parity  the phases of a tiny training step (D, R1, G, PPL) on
             cuda vs cpu from the same weights and injected draws: losses
             and gradients, float32, TF32 off
  7. train   the shipped training step at full width (Config(): batch 16,
             float32, synthetic data): one warm-up step, timed plain steps
             and one R1+PPL step; the tap sampler must launch 8 times per
             plain step and 12 times on the PPL step; one traced step
  8. train-cli  the training CLI (python -m spgan_tpu_torch.train), called
             in-process at full width on configs/model/spgan_run5k.yaml
             (batch 16, float32, source spr) with an .spr of 64 synthetic
             256x768 panoramas and ticks of 5/10/10: 20 iterations, then
             a resumed call to 30; checkpoints 20 and 30 kept, the tap
             sampler 8 times an iteration; ms per iteration with data and
             ticks beside phase 7's bare step, the loader's ms per batch;
             the image grids once; checkpoint save/restore seconds and
             bytes; the .npz export read back; the inference CLI renders
             16 close-loop 384x768 PNGs from the checkpoint directory (48
             grouped-kernel launches)
  9. train-cli-synthetic  the training CLI on configs/model/spgan.yaml as
             shipped (batch 16, float32, source synthetic):
             TrainPipeline.make_batch timed alone, then four calls of 10
             iterations, ordered thread, premade, premade, thread (the
             pipeline's prefetch thread, or the same batches made
             beforehand); the tap sampler 8 times an iteration; ms per
             iteration of each beside phase 7's bare step and phase 8's
             spr iteration
  10. train-options  the training CLI with every ported option at full
             width (configs/model/spgan.yaml, batch 16, float32): the tap
             sampler against its plain version at the extrapolated
             windows' widths and tables (45, 65; exact; the grids
             themselves run on the patch grids, as the JAX package's do);
             call A on an LMDB of 64 synthetic
             256x768 panoramas (Paeth PNGs decoded in-tree) with the
             projection head, SS noise, ss_mapping, the extrapolated
             grids, steps_per_call 4 and lr_sch, 12 iterations, the grids
             called twice, then the inference CLI renders its checkpoint
             directory in bf16 (16 PNGs, 48 grouped-kernel launches); call
             B on a folder of the same PNGs with SGD and a frozen baseline
             transfer, 8 iterations, the frozen G leaves and the whole D
             unchanged bit for bit; the loaders' ms per batch, ms per
             plain step beside phase 7's, the prefetch queue's waits of
             the first loop call apart from the later ones, the tap
             sampler's launches against the count printed beforehand
  11. fid   inception (features, logits) and LPIPS on cuda against cpu,
             and TF32's effect on the features; the training CLI on
             configs/model/spgan_run30k_bf16.yaml (batch 16, bf16,
             n_fid_sample cut from 2048 to 512, calc_fid and
             calc_fid_ext2) with an .spr of
             64 synthetic panoramas, eval and fid_ext2 ticks of 2 and 4
             iterations, SPGAN_TPU_INCEPTION=random: two FID and two
             EXT2-FID ticks (the second on the cached real statistics),
             each split into real stats / generation / features / host
             Frechet, its tap-sampler launches (4 a batch of the FID
             forward, none in EXT2) and peak memory; best_fid.pt,
             best_fid_ext2.pt and best.json; the inference CLI renders 16
             panoramas from best_fid.pt (48 grouped-kernel launches); the
             offline eval CLI (fid, stats, fid from the .pkl, is, lpips)
             on two .npy sets of 256 synthetic 256x768 panoramas
Then prints the kernels JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}.  Imports no JAX.
"""
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense bf16, H100 SXM data sheet
H100_F32_FLOPS = 67e12     # float32 outside the tensor cores, data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
SS_SIZES = (35, 29, 23, 17)
TIMED_GENERATES = 5
TIMED_TRAIN_STEPS = 3
CLI_BATCHES = 16  # per --speed-benchmark run: 10 warm-up (test.py's) + 6


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
    import collections
    import ctypes
    import os
    import re

    from spgan_tpu_torch.ops.kernels import build

    names = sorted(p.stem for p in build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(names)
    dt = time.perf_counter() - t0
    print(f"[build] {names} in {dt:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning")):
                print(f"[build] {name}: {line.strip()}")
    # what the sphere conv's launches get, as the runtime reports it
    lib = build.load("sphere_conv")
    fn = lib.sphere_conv_attributes
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    for dtype, what in ((1, "sphere_conv_bf16"), (0, "sphere_conv_f32")):
        vals = [ctypes.c_int(0) for _ in range(3)]
        err = fn(dtype, *(ctypes.byref(v) for v in vals))
        if err:
            raise RuntimeError(f"sphere_conv_attributes: cudaError {err}")
        regs, local, dyn = (v.value for v in vals)
        print(f"[build] {what}: {regs} registers, {local} bytes local "
              f"(spills), {dyn} bytes dynamic shared memory")
    # the bf16 body must run on warpgroup MMA: HGMMA in its SASS
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("sphere_conv"))],
                          check=True, capture_output=True, text=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"[build] sphere_conv SASS: {n} HGMMA instructions")
    if n == 0:
        raise AssertionError("no HGMMA in sphere_conv's SASS")
    # the tap sampler's memory instructions: shared loads, cp.async
    # (LDGSTS), 16-byte streaming stores (STG.E.EF.128), local memory
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("sphere_sample"))],
                          check=True, capture_output=True, text=True).stdout
    ops = collections.Counter(re.findall(
        r"\b(?:LDS|LDGSTS|STG|LDL|STL)[A-Z0-9._]*", sass))
    print(f"[build] sphere_sample SASS (4 kernels): {dict(sorted(ops.items()))}")


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
            r["pct_bound"] = 100 * r["bound_ms"] / r["ms"]
            # yardstick only (not the same function): cuDNN's dense 3x3
            # conv of the same B, H, C, Cout, i.e. the same FLOPs
            xc = xb[:b].permute(0, 3, 1, 2)
            wc = wb.reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous()
            r["dense_conv_ms"] = time_ms(
                lambda: torch.nn.functional.conv2d(xc, wc, padding=1), 20)
            print(f"[kernels] {name} H={H} B={b} bf16: {r['ms']:.4f} ms "
                  f"({r['tflops']:.1f} TFLOP/s, {r['pct_bound']:.1f}% of "
                  f"bound), plain {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN dense "
                  f"3x3 conv (not the same function) "
                  f"{r['dense_conv_ms']:.4f} ms")
    for name, per_h in results.items():
        tot = {k: sum(r[k] for r in per_h.values())
               for k in ("ms", "bound_ms", "dense_conv_ms")}
        print(f"[kernels] {name} over H={list(per_h)}: {tot['ms']:.4f} ms, "
              f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of the "
              f"{tot['bound_ms']:.4f} ms bound; cuDNN dense 3x3 conv "
              f"{tot['dense_conv_ms']:.4f} ms")
    return results


def phase_parity(planar=False):
    """The tiny engine on cuda vs cpu: close-loop 128x672, or planar
    128x200 (4 x 5 lattice)."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import (build_close_loop_plan,
                                                build_infinite_plan)
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    g = Generator.from_config(tiny_config(Config))
    object.__setattr__(g.ts, "channel_base", 48)
    plan = (build_infinite_plan(g, 128, 200) if planar
            else build_close_loop_plan(g, 128, 672))
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
    what = "planar" if planar else "close-loop"
    err = check_close(f"tiny {what} engine cuda vs cpu", metas["cuda"],
                      metas["cpu"], 2e-4, 0.0)
    tag = "infer-parity" if planar else "parity"
    print(f"[{tag}] tiny {what} meta {tuple(metas['cuda'].shape)}: "
          f"cuda (kernel, {launched} launches) vs cpu (plain) max_abs_err "
          f"{err:.3e} (atol 2e-4)")


def phase_engine(card_str):
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss

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
    ss.sphere_sample_taps.launches = 0
    per_ms = []
    for _ in range(TIMED_GENERATES):
        t0 = time.perf_counter()
        meta = eng.generate(params, gen)
        torch.cuda.synchronize()
        per_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
                "fused_sphere_conv": sk.fused_sphere_conv.launches,
                "sphere_sample_taps": ss.sphere_sample_taps.launches}
    dt = sum(per_ms) / 1e3
    want = (cfg.task.batch_size, 581, 768, 3)
    if tuple(meta.shape) != want or not bool(meta.isfinite().all()):
        raise AssertionError(f"meta {tuple(meta.shape)} (want {want}), "
                             f"finite={bool(meta.isfinite().all())}")
    per_gen = launches["fused_sphere_conv_grouped"] / TIMED_GENERATES
    if (per_gen != 48 or launches["fused_sphere_conv"]
            or launches["sphere_sample_taps"]):
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
    busy_ms, by_name = trace(lambda: eng.generate(params, gen), "generate")
    untraced_ms = float(np.median(per_ms))
    print(f"[trace] device busy {busy_ms:.1f} ms of the untraced median "
          f"generate {untraced_ms:.1f} ms: idle share "
          f"{100 * (1 - busy_ms / untraced_ms):.1f}%")
    conv_ms = sum(ms for k, ms in by_name.items() if "sphere_conv_bf16" in k)
    print(f"[trace] sphere_conv_bf16 in one generate: {conv_ms:.2f} ms, "
          f"{100 * conv_ms / busy_ms:.1f}% of device busy time")
    return {k: v // TIMED_GENERATES for k, v in launches.items()}


def png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def run_cli(argv, want_per_batch):
    """One in-process run of the inference CLI with every launch count at
    0 before it; returns (manager, grouped-kernel launches per batch)."""
    from spgan_tpu_torch.infer.__main__ import main
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss

    sk.fused_sphere_conv_grouped.launches = 0
    sk.fused_sphere_conv.launches = 0
    ss.sphere_sample_taps.launches = 0
    t0 = time.perf_counter()
    manager = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_batches = manager.cur_global_id // manager.engine.batch
    launches = {"fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
                "fused_sphere_conv": sk.fused_sphere_conv.launches,
                "sphere_sample_taps": ss.sphere_sample_taps.launches}
    per_batch = launches["fused_sphere_conv_grouped"] / n_batches
    if per_batch != want_per_batch or launches["fused_sphere_conv"] \
            or launches["sphere_sample_taps"]:
        raise AssertionError(f"CLI {argv[1]} + {argv[3]}: launches {launches}"
                             f" over {n_batches} batches (want "
                             f"{want_per_batch} grouped a batch)")
    print(f"[cli] {os.path.basename(argv[3])}: {n_batches} batches, "
          f"{per_batch:.0f} grouped-kernel launches a batch, {wall:.2f} s "
          f"wall for the whole CLI call")
    return manager, int(per_batch)


def sec_per_image(manager, what, card_str, warmup=10):
    """The CLI's sec/image: the mean over the batches after test.py's
    `warmup` calls (get_exec_time_stats), with their median, spread and
    the warm-up batches beside it."""
    batch = manager.engine.batch
    per_img = np.asarray(manager.accum_exec_times) / batch
    if len(per_img) <= warmup:
        raise AssertionError(f"{what}: {len(per_img)} timed batches, want "
                             f"more than the {warmup} warm-up ones")
    kept = per_img[warmup:]
    mean, std = (v / batch for v in manager.get_exec_time_stats(warmup))
    print(f"[cli] {card_str}: {what}: {mean:.6f} sec/image, mean of the "
          f"{len(kept)} batches of {batch} after {warmup} warm-up batches "
          f"(median {np.median(kept):.6f}, min {kept.min():.6f}, max "
          f"{kept.max():.6f}, std {std:.6f}; each "
          f"{', '.join(f'{t:.6f}' for t in kept)}); warm-up batches "
          f"{', '.join(f'{t:.6f}' for t in per_img[:warmup])}")
    return mean


def paired_generate(manager, pairs=6):
    """The CLI manager's timed run_next against a bare engine.generate
    ended by a synchronise (phase 4's window), in turns on one card."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bare, managed = [], []
    for _ in range(pairs):
        t0 = time.perf_counter()
        manager.engine.generate(manager.params_ema, gen)
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t0) * 1e3)
        manager.run_next(gen, save=False, write_gpu_time=True)
        managed.append(manager.accum_exec_times[-1] * 1e3)
    print(f"[cli] in turns on the CLI's manager: bare generate "
          f"{', '.join(f'{t:.1f}' for t in bare)} ms (median "
          f"{np.median(bare):.1f}); run_next "
          f"{', '.join(f'{t:.1f}' for t in managed)} ms (median "
          f"{np.median(managed):.1f})")


def check_planar_b1(manager):
    """B1's float32 body at the planar CLI's own shapes against its plain
    version: every chunk's tables of the run's plan (groups = chunk, Bg =
    batch), x (chunk*batch, H, H, local_dim) random, w9 the run's SS
    weights (identity-initialised, so mostly the centre tap) and a random
    one.  Returns the max abs error."""
    from spgan_tpu_torch.geometry.sphere_conv import _taps
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    eng = manager.engine
    G, ld = eng.patch_chunk, eng.g.ss.local_dim
    scale = eng.g.ss.sphere_spec().conv_spec().scale
    n_chunks = len(eng._render_idx) // G
    rng = np.random.RandomState(5)
    # phase 2's float32 limits: sums of 9*C products in another order
    atol, rtol = 2e-4 * math.sqrt(ld / 16), 1e-4
    worst = 0.0
    for tables, blk in zip(eng._ss_tables,
                           manager.params_ema["ss"]["blocks"]):
        H = tables["y0"].shape[1]
        x = torch.as_tensor(rng.randn(G * eng.batch, H, H, ld)
                            .astype(np.float32)).cuda()
        weights = {
            "run's": _taps(blk["sphere"]["conv"]["weight"].float()
                           * scale)[:, :ld].contiguous(),
            "random": torch.as_tensor((rng.randn(9, ld, ld) / math.sqrt(9 * ld))
                                      .astype(np.float32)).cuda()}
        for ci in range(n_chunks):
            tg = {k: v[ci * G:(ci + 1) * G].contiguous()
                  for k, v in tables.items()}
            for wname, w9 in weights.items():
                got = sk.fused_sphere_conv_grouped(x, tg, w9, G)
                ref = sk.fused_sphere_conv_plain(x, tg, w9, G)
                worst = max(worst, check_close(
                    f"planar B1 float32 H={H} chunk {ci} {wname} w9", got,
                    ref, atol, rtol))
        print(f"[cli] planar B1 float32 H={H}: x {tuple(x.shape)}, groups "
              f"{G}, {n_chunks} chunks x (run's, random) w9 vs plain: max "
              f"abs err so far {worst:.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
    return worst


def phase_cli(card_str):
    """The inference CLI at full width, run from a temporary directory
    (its logs-quant/ and outputs land there)."""
    repo = os.path.dirname(os.path.abspath(__file__))

    def cfg(*p):
        return os.path.join(repo, "configs", *p)

    out = {}
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            m, out["close_loop"] = run_cli(
                ["--model-config", cfg("model", "spgan_run5k_bf16.yaml"),
                 "--test-config", cfg("test", "spgan_384x768.yaml"),
                 "--random-init", "--num-gen", str(16 * CLI_BATCHES),
                 "--speed-benchmark", "--save-root", "close_loop"],
                want_per_batch=48)
            out["close_loop_sec_per_image"] = sec_per_image(
                m, "close-loop 384x768 bf16 batch 16", card_str)
            paired_generate(m)
            del m
            m, out["planar"] = run_cli(
                ["--model-config", cfg("model", "spgan.yaml"),
                 "--test-config", cfg("test", "spgan_infinite_256x512.yaml"),
                 "--num-gen", "8", "--save-root", "planar"],
                want_per_batch=40)
            pngs = sorted(f for f in os.listdir("planar") if f.endswith(".png"))
            sizes = {png_size(os.path.join("planar", f)) for f in pngs}
            if len(pngs) != 8 or sizes != {(512, 256)}:
                raise AssertionError(f"planar CLI wrote {pngs} of sizes {sizes}"
                                     " (want 8 of 512x256)")
            crops = m.engine.crop_to_target(m.full_image)
            if not (np.isfinite(m.full_image).all() and crops.std() > 0):
                raise AssertionError("planar meta not finite or constant")
            print(f"[cli] planar 256x512 float32: {len(pngs)} PNGs of "
                  f"512x256 (IHDR), meta {m.full_image.shape} finite")
            out["planar_f32_max_abs_err"] = check_planar_b1(m)
            del m
            m, _ = run_cli(
                ["--model-config", cfg("model", "spgan.yaml"),
                 "--test-config", cfg("test", "spgan_infinite_256x512.yaml"),
                 "--num-gen", str(8 * CLI_BATCHES), "--speed-benchmark",
                 "--save-root", "planar_bench"], want_per_batch=40)
            out["planar_sec_per_image"] = sec_per_image(
                m, "planar 256x512 float32 batch 8", card_str)
            del m
        finally:
            os.chdir(old)
    return out


def trace(run, what, top=12):
    """Device time by kernel over one call of `run` (torch.profiler), and
    the device's busy share of its wall time under the profiler.  Returns
    the device-busy milliseconds and the milliseconds by kernel name."""
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
    print(f"[trace] one {what} under the profiler: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"[trace] {ms:9.2f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
              f"x{e.count:<5d} {e.key[:110]}")
    return busy_ms, {e.key: e.self_device_time_total / 1e3 for e in kernels}


def phase_patch():
    """Generator.apply on 16 per-sample crops of the shipped plan."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.coords import CoordsPartial
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
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
    ss.sphere_sample_taps.launches = 0
    with torch.inference_mode():
        img = g.apply(params, global_latent=gl, local_latent=z,
                      coords=torch.as_tensor(coords).cuda(), cp=cp,
                      noises=noises)["gen"]
    torch.cuda.synchronize()
    launches = {"fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
                "fused_sphere_conv": sk.fused_sphere_conv.launches,
                "sphere_sample_taps": ss.sphere_sample_taps.launches}
    if tuple(img.shape) != (B, 101, 101, 3) or not bool(img.isfinite().all()):
        raise AssertionError(f"patch {tuple(img.shape)} finite="
                             f"{bool(img.isfinite().all())}")
    if launches != {"fused_sphere_conv_grouped": 0,
                    "fused_sphere_conv": g.ss.n_layers,
                    "sphere_sample_taps": 0}:
        raise AssertionError(f"patch-forward launches {launches}")
    print(f"[patch] Generator.apply batch {B} bf16: {tuple(img.shape)} "
          f"finite, launches {launches}")
    return launches


def training_crops(B, H, seed):
    """Offset tables and the equivalent (3H,3W) sampling grid of B random
    training crops (x_total 45, y_total 140, grid_partial 0.8) at size H."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.sphere_grid import (
        sphere_offset_tables_batch, sphere_patch_grid_batch)
    from spgan_tpu_torch.models.generator import Generator

    grid = Generator.from_config(Config()).ss.coord_grid
    _, _, cp = grid.sample_training(
        torch.Generator(device="cuda").manual_seed(seed), B)
    tables = {k: v.contiguous()
              for k, v in sphere_offset_tables_batch(cp, H, H).items()}
    return tables, sphere_patch_grid_batch(cp, H, H)


def device_ms(run, name, iters=20, tries=3):
    """Mean device time (torch.profiler, self device time) of the kernels
    whose name holds `name`, over `iters` back-to-back calls of `run`; each
    call must launch one.  Returns (ms, traces taken).  A trace, each with
    its own fresh profiler, once saw 19 of 20 launches on the H100, cause
    not found: a short trace is then taken again, up to `tries` times, and
    the count of traces goes into the kernels line; more launches than
    calls fail at once."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.key]
        count = sum(e.count for e in ev)
        if count == iters:
            return (sum(e.self_device_time_total for e in ev) / count / 1e3,
                    attempt)
        print(f"[kernels] {name}: trace {attempt} saw {count} launches of "
              f"{iters} calls")
        if count > iters:
            break
    raise AssertionError(f"{count} traced launches of {name}, want {iters}")


def distinct_rows(tables, taps):
    """Max and mean count of the distinct input rows (y0 and y1) that each
    group of `taps` consecutive taps of an output row (b, r) reads."""
    y = torch.stack([tables["y0"], tables["y1"]], dim=-1)
    B, H, K2, _ = y.shape
    s, _ = y.reshape(B, H, K2 // taps, 2 * taps).sort(dim=-1)
    d = 1 + (s[..., 1:] != s[..., :-1]).sum(dim=-1)
    return int(d.max()), float(d.float().mean())


def phase_sample_kernel():
    """The tap sampler (B3) at the training step's SS shapes."""
    import torch.nn.functional as F

    from spgan_tpu_torch.ops.kernels import sphere_sample as ss

    B, C = 16, 259
    rng = np.random.RandomState(1)
    res = {}
    for H in SS_SIZES:
        tables, grid = training_crops(B, H, seed=H)
        x32 = torch.as_tensor(rng.randn(B, H, H, C).astype(np.float32)).cuda()
        r = res[H] = {"err": 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            ref = ss.sphere_sample_taps_plain(x, tables)
            got = ss.sphere_sample_taps(x, tables)
            torch.cuda.synchronize()
            # the same float32 lerps op by op and one cast: exact
            err = check_close(f"sphere_sample_taps H={H} {dtype}", got, ref,
                              0.0, 0.0)
            r["err"] = max(r["err"], err)
            print(f"[kernels] sphere_sample_taps H={H} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e} (exact)")
        rows_br, rows_unit = distinct_rows(tables, 9), distinct_rows(tables, 3)
        slots, smem, per_sm = ss.staging_plan(torch.cuda.current_device(),
                                              H, C, False)
        print(f"[kernels] sphere_sample_taps H={H} tables: distinct input "
              f"rows per output row (b, r) max {rows_br[0]} mean "
              f"{rows_br[1]:.3f}, per tap row (b, r, 3 taps) max "
              f"{rows_unit[0]} mean {rows_unit[1]:.3f}; f32 launch: "
              f"{slots} row slots, {smem} bytes dynamic shared memory, "
              f"{per_sm} blocks per SM")
        # times in float32, the shipped training dtype
        got = ss.sphere_sample_taps(x32, tables)

        def library():
            # one PyTorch call computing the same samples: bilinear
            # grid_sample over the interleaved (3H,3W) grid, border
            # padding, then the tap-major permute
            y = F.grid_sample(x32.permute(0, 3, 1, 2), grid, mode="bilinear",
                              padding_mode="border", align_corners=True)
            return y.reshape(B, C, H, 3, H, 3).permute(0, 3, 5, 2, 4, 1) \
                .reshape(B, 9, H, H, C)

        r["library_err"] = float((library() - got).abs().max())
        # back to back from the host (host time included), and the
        # kernel's own device time
        r["ms"] = time_ms(lambda: ss.sphere_sample_taps(x32, tables), 20)
        r["device_ms"], r["traces"] = device_ms(
            lambda: ss.sphere_sample_taps(x32, tables),
            "sphere_sample_taps_kernel")
        r["plain_ms"] = time_ms(
            lambda: ss.sphere_sample_taps_plain(x32, tables), 3, warmup=1)
        r["library_ms"] = time_ms(library, 20)
        # each input element read once, nine written; the tables; three
        # lerps (4 float32 ops each) per output element
        r["bytes"] = nbytes = 10 * B * H * H * C * 4 + 5 * B * H * 9 * 4
        flops = 12.0 * 9 * B * H * H * C
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
        r["bound_ms"] = max(t_bytes, t_ops) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[kernels] sphere_sample_taps H={H} B={B} C={C} f32: device "
              f"{r['device_ms']:.4f} ms ({nbytes / r['device_ms'] / 1e6:.0f} "
              f"GB/s, {100 * r['bound_ms'] / r['device_ms']:.1f}% of bound), "
              f"back to back {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"grid_sample+permute {r['library_ms']:.4f} ms (max |diff| vs "
              f"kernel {r['library_err']:.2e}, "
              f"{'matched' if r['library_err'] < 1e-3 else 'DIFFERS'} "
              f"at 1e-3)")
    tot = {k: sum(r[k] for r in res.values())
           for k in ("device_ms", "ms", "bound_ms", "bytes", "library_ms")}
    print(f"[kernels] sphere_sample_taps over H={list(res)}: device "
          f"{tot['device_ms']:.4f} ms ({tot['bytes'] / tot['device_ms'] / 1e6:.0f}"
          f" GB/s, {100 * tot['bound_ms'] / tot['device_ms']:.1f}% of the "
          f"{tot['bound_ms']:.4f} ms bound), back to back {tot['ms']:.4f} ms, "
          f"library {tot['library_ms']:.4f} ms")
    return res


def tiny_train_models():
    """Port config, G and D at the CPU tests' tiny widths (channel_base
    16, D channels 16, 2 SS layers, batch 4)."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator

    cfg = tiny_config(Config)
    tp = cfg.train_params
    tp.batch_size = 4
    tp.n_mlp = 1
    g = Generator.from_config(cfg)
    object.__setattr__(g.ts, "channel_base", 16)
    d = Discriminator(patch_size=101, channel_multiplier=1, batch_size=4,
                      linear_ch=16)
    small = {k: 16 for k in d.channels()}
    object.__setattr__(d, "channels", lambda: small)
    return cfg, g, d


def _moved(obj, dev):
    """A TrainState, StepDraws or GDraws with every tensor moved to dev."""
    import dataclasses

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


def phase_train_parity():
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
    from spgan_tpu_torch.train.state import create_train_state
    from spgan_tpu_torch.train.step import make_train_step

    cfg, g, d = tiny_train_models()
    step = make_train_step(cfg, g, d)
    state = create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                               device="cpu")
    draws = step.draw(torch.Generator().manual_seed(1), do_ppl=True)
    rng = np.random.RandomState(2)
    real = torch.as_tensor(rng.randn(4, 101, 101, 3).astype(np.float32))
    real_ac = torch.as_tensor(rng.uniform(-1, 1, (4, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        st, dr = _moved(state, dev), _moved(draws, dev)
        ss.sphere_sample_taps.launches = 0
        gd, md = step.d_grads(st.params_g, st.params_d, real.to(dev),
                              real_ac.to(dev), dr.d)
        gr, r1 = step.r1_grads(st.params_d, real.to(dev), real_ac.to(dev))
        gg, mg = step.g_grads(st.params_g, st.params_d, dr.g)
        gp, pen, _, plen = step.ppl_grads(st.params_g, dr,
                                          st.mean_path_length)
        if dev == "cuda":
            torch.cuda.synchronize()
            want = 3 * g.ss.n_layers
            if ss.sphere_sample_taps.launches != want:
                raise AssertionError(
                    f"tiny train phases on cuda: {ss.sphere_sample_taps.launches}"
                    f" tap-sampler launches, want {want}")
        out[dev] = ({**md, **mg, "r1": r1, "path": pen, "path_lengths": plen},
                    {"d": gd, "r1": gr, "g": gg, "ppl": gp})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    worst = 0.0
    for k, v in lc.items():
        rel = abs(float(lg[k]) - float(v)) / max(abs(float(v)), 1e-12)
        worst = max(worst, rel)
        # float32 with TF32 off; the PPL penalty is quadratic in tiny path
        # lengths and amplifies summation-order noise
        tol = 1e-4 if k == "path" else 1e-5
        if rel > tol:
            raise AssertionError(f"tiny train {k}: cuda {float(lg[k])} vs "
                                 f"cpu {float(v)} (rel {rel:.2e} > {tol})")
    print(f"[train-parity] losses cuda vs cpu: worst rel diff {worst:.2e} "
          f"(1e-5; path 1e-4)")
    for phase in gc:
        a = [t for t in gc[phase] if t is not None]
        b = [t.cpu() for t in gg[phase] if t is not None]
        scale = max(float(t.abs().max()) for t in a)
        err = max(float((x - y).abs().max()) for x, y in zip(a, b)) / scale
        # gradients summed over ~1e4-1e5 products (double backward for R1
        # and PPL) in another order on each device
        if err > 1e-5:
            raise AssertionError(f"tiny train {phase} grads: cuda vs cpu "
                                 f"rel-to-scale {err:.2e} > 1e-5")
        print(f"[train-parity] {phase} grads ({len(a)} leaves): cuda vs cpu "
              f"max |diff| / scale {err:.2e} (1e-5)")


def phase_train(card_str):
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.data.pipeline import TrainPipeline
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
    from spgan_tpu_torch.train.state import create_train_state
    from spgan_tpu_torch.train.step import make_train_step
    from spgan_tpu_torch.tree import tree_leaves

    cfg = Config()
    tp = cfg.train_params
    g, d = Generator.from_config(cfg), Discriminator.from_config(cfg)
    state = create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                               device="cuda")
    step = make_train_step(cfg, g, d)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pipe = TrainPipeline(cfg, seed=0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(pipe).items()}
               for _ in range(TIMED_TRAIN_STEPS + 4)]
    pipe.close()

    def run(i, reg):
        b = batches[i]
        return step(state, b["patch"], b["ac_coords"], gen, do_r1=reg,
                    do_ppl=reg)

    def check(m, what):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"{what}: non-finite metrics {bad}")

    t0 = time.perf_counter()
    state, m = run(0, True)
    torch.cuda.synchronize()
    check(m, "warm-up step")
    print(f"[train] warm-up R1+PPL step {time.perf_counter() - t0:.2f} s")
    s0 = state
    torch.cuda.reset_peak_memory_stats()
    sk.fused_sphere_conv_grouped.launches = 0
    sk.fused_sphere_conv.launches = 0
    ss.sphere_sample_taps.launches = 0
    per_ms, per_launch = [], []
    for i in range(TIMED_TRAIN_STEPS + 1):
        reg = i == TIMED_TRAIN_STEPS
        n0 = ss.sphere_sample_taps.launches
        t0 = time.perf_counter()
        state, m = run(1 + i, reg)
        torch.cuda.synchronize()
        per_ms.append((time.perf_counter() - t0) * 1e3)
        per_launch.append(ss.sphere_sample_taps.launches - n0)
        check(m, f"step {i}")
    launches = {"fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
                "fused_sphere_conv": sk.fused_sphere_conv.launches,
                "sphere_sample_taps": ss.sphere_sample_taps.launches}
    want = [2 * g.ss.n_layers] * TIMED_TRAIN_STEPS + [3 * g.ss.n_layers]
    if per_launch != want or launches["fused_sphere_conv_grouped"] \
            or launches["fused_sphere_conv"]:
        raise AssertionError(f"tap-sampler launches per step {per_launch} "
                             f"(want {want}), all {launches}")

    def delta(a, b):
        return max(float((x - y).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    d_g = delta(state.params_g, s0.params_g)
    d_d = delta(state.params_d, s0.params_d)
    d_ema = delta(state.params_g_ema, s0.params_g_ema)
    if not (d_g > 0 and d_d > 0 and 0 < d_ema < d_g):
        raise AssertionError(f"params moved G {d_g} D {d_d} EMA {d_ema}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plain = per_ms[:TIMED_TRAIN_STEPS]
    print(f"[train] {card_str}: Config() batch {tp.batch_size} "
          f"{tp.compute_dtype}: plain step {np.mean(plain):.1f} ms "
          f"(each {', '.join(f'{t:.1f}' for t in plain)}), R1+PPL step "
          f"{per_ms[-1]:.1f} ms, peak memory {peak:.2f} GiB; tap-sampler "
          f"launches per step {per_launch}; max |d| over the 4 steps: G "
          f"{d_g:.3e}, D {d_d:.3e}, EMA {d_ema:.3e}")
    print(f"[train] last metrics: "
          f"{ {k: round(float(v), 4) for k, v in m.items()} }")
    for i, (reg, what, untraced_ms) in enumerate((
            (False, "plain train step", float(np.median(plain))),
            (True, "R1+PPL train step", per_ms[-1]))):
        busy_ms, _ = trace(lambda: run(TIMED_TRAIN_STEPS + 2 + i, reg), what)
        print(f"[trace] device busy {busy_ms:.1f} ms of the untraced {what} "
              f"{untraced_ms:.1f} ms: idle share "
              f"{100 * (1 - busy_ms / untraced_ms):.1f}%")
    return launches, float(np.mean(plain))


class TimedPipeline:
    """A training pipeline that synchronises the card and stamps the host
    clock as each batch is asked for, and at close(): consecutive stamps
    bound one whole iteration (its batch, step and ticks).  It also times
    each batch's own loading."""

    def __init__(self, inner):
        self.inner, self.stamps, self.load_ms = inner, [], []

    def __iter__(self):
        return self

    def __next__(self):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        batch = next(self.inner)
        self.load_ms.append((time.perf_counter() - self.stamps[-1]) * 1e3)
        return batch

    def close(self):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.inner.close()


class PremadePipeline:
    """Batches made before the run, handed out in order, with no thread."""

    def __init__(self, batches):
        self.batches = iter(batches)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self.batches)

    def close(self):
        pass


def _run_train_cli(argv, pipelines, want, make=None):
    """One in-process call of the training CLI with its stdout captured
    (and echoed); its pipeline, made by `make` (default the loop's own
    make_train_pipeline) and which must be a `want`, is wrapped in a
    TimedPipeline, appended to `pipelines`.  Returns (final state,
    stdout)."""
    import contextlib
    import io

    from spgan_tpu_torch.train import loop
    from spgan_tpu_torch.train.__main__ import main

    orig = loop.make_train_pipeline
    make = make or orig

    def timed(cfg, seed=0, **kw):
        pipe = make(cfg, seed=seed, **kw)
        if not isinstance(pipe, want):
            raise AssertionError(f"the config took {type(pipe)}, want "
                                 f"{want}")
        pipelines.append(TimedPipeline(pipe))
        return pipelines[-1]

    out = io.StringIO()
    loop.make_train_pipeline = timed
    try:
        with contextlib.redirect_stdout(out):
            state = main(argv)
    finally:
        loop.make_train_pipeline = orig
        print(out.getvalue(), end="")
    return state, out.getvalue()


def _finite_log_lines(text, want_iters):
    """The scalars of the CLI's log lines: every value finite, one line at
    each of `want_iters`."""
    import ast
    import re

    seen = []
    for m in re.finditer(r"^\[train\] iter (\d+)/\d+ .*?: (\{.*\})$", text,
                         re.M):
        vals = ast.literal_eval(m.group(2))  # nan/inf do not parse
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite scalars {vals}")
        seen.append(int(m.group(1)))
    if seen != list(want_iters):
        raise AssertionError(f"log lines at {seen}, want {list(want_iters)}")


def _equal_trees(a, b, what):
    from spgan_tpu_torch.tree import flatten

    fa, fb = dict(flatten(a)), dict(flatten(b))
    if fa.keys() != fb.keys() or not all(
            torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fa):
        raise AssertionError(f"{what}: trees differ")


def phase_train_cli(card_str, plain_step_ms):
    """The training CLI at full width on an .spr of synthetic panoramas,
    run from a temporary directory (its logs/ land there), then the
    inference CLI on its checkpoints."""
    import importlib.util
    import re
    import shutil

    from spgan_tpu_torch.compat.load import (load_generator_params,
                                             save_params_npz)
    from spgan_tpu_torch.config import load_config
    from spgan_tpu_torch.data.native_loader import write_records
    from spgan_tpu_torch.data.pipeline import (NativeTrainPipeline,
                                               SyntheticPanoramas)
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
    from spgan_tpu_torch.train import loop
    from spgan_tpu_torch.train.checkpoint import CheckpointManager
    from spgan_tpu_torch.train.state import create_train_state

    repo = os.path.dirname(os.path.abspath(__file__))
    shipped = os.path.join(repo, "configs", "model", "spgan_run5k.yaml")
    old = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        os.chdir(tmp)
        src = SyntheticPanoramas((768, 256), n=64, seed=3)
        imgs = np.stack([src[i] for i in range(len(src))])
        write_records("train.spr", imgs)
        print(f"[train-cli] train.spr: {imgs.shape} uint8, "
              f"{os.path.getsize('train.spr')} bytes")
        # the shipped yaml with only the data file and the ticks changed
        # (the log directory is logs/ under this working directory)
        text = open(shipped).read()
        for key, val in (("folder", os.path.join(tmp, "train.spr")),
                         ("log_tick", 5), ("img_tick", 10),
                         ("save_tick", 10)):
            text, n = re.subn(rf"^(\s+{key}:) .*$", rf"\g<1> {val}", text,
                              flags=re.M)
            if n != 1:
                raise AssertionError(f"{key}: {n} lines in {shipped}")
        yaml_path = os.path.join(tmp, "spgan_run5k.yaml")
        with open(yaml_path, "w") as f:
            f.write(text)
        cfg, ref = load_config(yaml_path), load_config(shipped)
        ref.data_params.folder = cfg.data_params.folder
        for k in ("log_tick", "img_tick", "save_tick"):
            setattr(ref.log_params, k, getattr(cfg.log_params, k))
        if cfg != ref or cfg.train_params.batch_size != 16 or \
                cfg.train_params.compute_dtype != "float32":
            raise AssertionError("the edited yaml differs from the shipped "
                                 "one beyond its data file and ticks")
        tp = cfg.train_params

        sk.fused_sphere_conv_grouped.launches = 0
        sk.fused_sphere_conv.launches = 0
        ss.sphere_sample_taps.launches = 0
        pipes = []
        t0 = time.perf_counter()
        state, out1 = _run_train_cli([yaml_path, "--max-iters", "20"], pipes,
                                     NativeTrainPipeline)
        wall1 = time.perf_counter() - t0
        mgr = CheckpointManager(os.path.join("logs", "spgan_run5k", "ckpt"))
        if state.step != 20 or mgr.steps() != [10, 20]:
            raise AssertionError(f"first call: step {state.step}, "
                                 f"checkpoints {mgr.steps()}")
        t0 = time.perf_counter()
        state, out2 = _run_train_cli([yaml_path, "--max-iters", "30"], pipes,
                                     NativeTrainPipeline)
        wall2 = time.perf_counter() - t0
        if "Resumed from iter 20" not in out2 or state.step != 30 \
                or mgr.steps() != [20, 30]:
            raise AssertionError(f"second call: step {state.step}, "
                                 f"checkpoints {mgr.steps()}")
        _finite_log_lines(out1, range(5, 21, 5))
        _finite_log_lines(out2, (25, 30))
        # the loop renders grids only into tensorboard (as the JAX loop)
        tb = importlib.util.find_spec("tensorboardX") is not None
        per_forward = Generator.from_config(cfg).ss.n_layers
        launches = {
            "fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
            "fused_sphere_conv": sk.fused_sphere_conv.launches,
            "sphere_sample_taps": ss.sphere_sample_taps.launches}
        want = 2 * per_forward * 30 + (3 * 3 * per_forward if tb else 0)
        if launches != {"fused_sphere_conv_grouped": 0,
                        "fused_sphere_conv": 0, "sphere_sample_taps": want}:
            raise AssertionError(f"training CLI launches {launches}, want "
                                 f"{want} tap-sampler launches")

        # the image grids of the EMA generator, called once here
        g = Generator.from_config(cfg)
        n0 = ss.sphere_sample_taps.launches
        grids = loop.make_image_grids(cfg, g, seed=0, device="cuda")(
            state.params_g_ema, state.step)
        grid_launches = ss.sphere_sample_taps.launches - n0
        shapes = {k: v.shape for k, v in grids.items()}
        if shapes != {"samples/ema": (202, 808, 3),
                      "samples/style_diversity": (101, 808, 3),
                      "samples/structure_diversity": (101, 808, 3)} or \
                grid_launches != 3 * per_forward or \
                not all(v.std() > 0 for v in grids.values()):
            raise AssertionError(f"grids {shapes}, {grid_launches} "
                                 "tap-sampler launches")
        print(f"[train-cli] image grids {shapes}, uint8, "
              f"{grid_launches} tap-sampler launches")
        cli_b3 = launches["sphere_sample_taps"] + grid_launches

        # per-iteration times: stamps of both calls, R1 and saving
        # iterations apart, the first 2 of each call apart
        per_it, first = {}, {}
        for pipe, start in zip(pipes, (0, 20)):
            ms = np.diff(pipe.stamps) * 1e3
            for i, t in enumerate(ms):
                (first if i < 2 else per_it)[start + i] = float(t)
        saving = {k: per_it.pop(k) for k in list(per_it)
                  if (k + 1) % cfg.log_params.save_tick == 0}
        r1 = {k: per_it.pop(k) for k in list(per_it)
              if k % tp.d_reg_every == 0}
        plain = np.array(list(per_it.values()))
        loads = np.concatenate([p.load_ms for p in pipes])
        print(f"[train-cli] {card_str}: spgan_run5k.yaml batch "
              f"{tp.batch_size} {tp.compute_dtype}, spr: "
              f"{plain.mean():.1f} ms per plain iteration with data and "
              f"ticks (median {np.median(plain):.1f}, min {plain.min():.1f},"
              f" max {plain.max():.1f}, {len(plain)} iterations after the "
              f"first 2 of each call; phase 7 bare plain step "
              f"{plain_step_ms:.1f} ms); saving iterations "
              f"{ {k + 1: round(v, 1) for k, v in saving.items()} } ms; "
              f"R1 iterations { {k: round(v, 1) for k, v in r1.items()} } ms;"
              f" first 2 of each call "
              f"{ {k: round(v, 1) for k, v in first.items()} } ms; calls "
              f"{wall1:.1f} s and {wall2:.1f} s wall")
        print(f"[train-cli] loader (C++ .spr, batch {tp.batch_size}): "
              f"{loads.mean():.2f} ms per batch (median "
              f"{np.median(loads):.2f}, max {loads.max():.2f}, "
              f"{len(loads)} batches)")

        # checkpoint save and restore of the final state, timed alone
        one = CheckpointManager("ckpt_timing")
        t0 = time.perf_counter()
        one.save(state.step, state)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(one.path(state.step))
        template = create_train_state(cfg, g, Discriminator.from_config(cfg),
                                      torch.Generator().manual_seed(1),
                                      device="cuda")
        t0 = time.perf_counter()
        back = one.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for name in ("params_g", "params_d", "params_g_ema"):
            _equal_trees(getattr(back, name), getattr(state, name), name)
        shutil.rmtree("ckpt_timing")
        print(f"[train-cli] checkpoint of step {state.step}: save "
              f"{save_s:.2f} s, restore {restore_s:.2f} s (to the card), "
              f"{nbytes} bytes on disk; run's checkpoints "
              f"{ {s: os.path.getsize(mgr.path(s)) for s in mgr.steps()} }")

        # the .npz export of the EMA generator, read back
        t0 = time.perf_counter()
        save_params_npz("g_ema.npz", state.params_g_ema)
        export_s = time.perf_counter() - t0
        _equal_trees(load_generator_params("g_ema.npz", g, device="cuda"),
                     state.params_g_ema, "npz export")
        print(f"[train-cli] g_ema.npz: {os.path.getsize('g_ema.npz')} bytes"
              f", written in {export_s:.2f} s, read back equal")

        # the inference CLI from the run's checkpoint directory
        m, per_batch = run_cli(
            ["--model-config", yaml_path, "--test-config",
             os.path.join(repo, "configs", "test", "spgan_384x768.yaml"),
             "--ckpt", mgr.ckpt_dir, "--num-gen", "16", "--save-root",
             "render"], want_per_batch=48)
        _equal_trees(m.params_ema, state.params_g_ema, "infer CLI weights")
        pngs = sorted(f for f in os.listdir("render") if f.endswith(".png"))
        sizes = {png_size(os.path.join("render", f)) for f in pngs}
        if len(pngs) != 16 or sizes != {(768, 384)}:
            raise AssertionError(f"infer CLI wrote {len(pngs)} PNGs of "
                                 f"sizes {sizes} (want 16 of 768x384)")
        print(f"[train-cli] infer CLI from the checkpoint directory: "
              f"{len(pngs)} PNGs of 768x384 (IHDR), {per_batch} "
              f"grouped-kernel launches in the batch")
        del m
    finally:
        os.chdir(old)
        shutil.rmtree(tmp)
    return {"sphere_sample_taps": cli_b3, "render_per_batch": per_batch,
            "plain_ms": float(plain.mean())}


SYNTHETIC_CLI_ITERS = 10


def phase_train_cli_synthetic(card_str, plain_step_ms, spr_iter_ms):
    """The training CLI on the shipped configs/model/spgan.yaml as it
    stands (batch 16, float32, source synthetic), whose batches the Python
    TrainPipeline makes on its prefetch thread (data/resize.py's numpy
    resizes) beside the step.  make_batch is timed alone on this host,
    making the run's SYNTHETIC_CLI_ITERS batches (seed 0, the pipeline's
    draws); then four CLI calls of as many iterations from a temporary
    directory, in the order thread, premade, premade, thread: the
    pipeline's own thread, or those batches handed out with no thread, so
    the pair of means prices the thread on the step."""
    import shutil

    from spgan_tpu_torch.config import load_config
    from spgan_tpu_torch.data.pipeline import TrainPipeline
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
    from spgan_tpu_torch.tree import flatten

    shipped = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "model", "spgan.yaml")
    cfg = load_config(shipped)
    tp = cfg.train_params
    if (tp.batch_size, tp.compute_dtype, cfg.data_params.source) != \
            (16, "float32", "synthetic"):
        raise AssertionError(f"{shipped}: batch {tp.batch_size} "
                             f"{tp.compute_dtype} {cfg.data_params.source}")

    # make_batch alone on this thread (the prefetch thread stopped first)
    pipe = TrainPipeline(cfg, seed=0)
    pipe.close()
    rng = np.random.RandomState(0)
    premade, batch_ms = [], []
    for _ in range(SYNTHETIC_CLI_ITERS):
        t0 = time.perf_counter()
        b = pipe.make_batch(rng)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if b["patch"].shape != (16, tp.patch_size, tp.patch_size, 3) or \
                b["ac_coords"].shape != (16, 3) or \
                not -1 <= b["patch"].min() < b["patch"].max() <= 1:
            raise AssertionError("synthetic batch out of shape or range")
        premade.append(b)
    batch_ms = np.array(batch_ms[1:])
    print(f"[train-cli-synthetic] {card_str}: TrainPipeline.make_batch "
          f"(spgan.yaml, synthetic, batch 16) on the calling thread: "
          f"{batch_ms.mean():.1f} ms per batch (median "
          f"{np.median(batch_ms):.1f}, min {batch_ms.min():.1f}, max "
          f"{batch_ms.max():.1f}, {len(batch_ms)} batches after the first)")

    argv = [shipped, "--max-iters", str(SYNTHETIC_CLI_ITERS)]
    want = 2 * Generator.from_config(cfg).ss.n_layers * SYNTHETIC_CLI_ITERS
    order = ("thread", "premade", "premade", "thread")
    old = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_synthetic_")
    try:
        os.chdir(tmp)
        sk.fused_sphere_conv_grouped.launches = 0
        sk.fused_sphere_conv.launches = 0
        ss.sphere_sample_taps.launches = 0
        pipes, per_call = [], []
        for kind in order:
            if kind == "thread":
                state, _ = _run_train_cli(argv, pipes, TrainPipeline)
            else:
                state, _ = _run_train_cli(
                    argv, pipes, PremadePipeline,
                    make=lambda cfg, seed=0: PremadePipeline(premade))
            if state.step != SYNTHETIC_CLI_ITERS or not all(
                    torch.isfinite(v).all() for _, v in
                    flatten(state.params_g_ema)):
                raise AssertionError(f"synthetic CLI ({kind}): step "
                                     f"{state.step}, or non-finite EMA "
                                     "weights")
            # iteration 0 is an R1 iteration, 1 the first plain one
            per_call.append(np.diff(pipes[-1].stamps)[2:] * 1e3)
        launches = {
            "fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
            "fused_sphere_conv": sk.fused_sphere_conv.launches,
            "sphere_sample_taps": ss.sphere_sample_taps.launches}
        if launches != {"fused_sphere_conv_grouped": 0,
                        "fused_sphere_conv": 0,
                        "sphere_sample_taps": len(order) * want}:
            raise AssertionError(f"synthetic CLI launches {launches}, want "
                                 f"{len(order) * want} tap-sampler launches")
    finally:
        os.chdir(old)
        shutil.rmtree(tmp)
    ms = {k: np.concatenate([m for o, m in zip(order, per_call) if o == k])
          for k in ("thread", "premade")}
    waits = np.concatenate([p.load_ms[2:] for o, p in zip(order, pipes)
                            if o == "thread"])
    print(f"[train-cli-synthetic] {card_str}: spgan.yaml batch 16 float32, "
          f"synthetic, ms per plain iteration (2 calls each, "
          f"{len(ms['thread']) // 2} iterations after the first 2 of each, "
          f"order {', '.join(order)}): prefetch thread "
          f"{ms['thread'].mean():.1f} (median {np.median(ms['thread']):.1f},"
          f" min {ms['thread'].min():.1f}, max {ms['thread'].max():.1f}), "
          f"premade batches {ms['premade'].mean():.1f} (median "
          f"{np.median(ms['premade']):.1f}, min {ms['premade'].min():.1f}, "
          f"max {ms['premade'].max():.1f}): thread "
          f"{100 * (ms['thread'].mean() / ms['premade'].mean() - 1):+.1f}%;"
          f" call means {', '.join(f'{m.mean():.1f}' for m in per_call)}; "
          f"phase 7 bare plain step {plain_step_ms:.1f} ms, phase 8 spr CLI "
          f"iteration {spr_iter_ms:.1f} ms; waits on the prefetch queue "
          f"{waits.mean():.2f} ms per batch (max {waits.max():.2f}); "
          f"{len(order) * want} tap-sampler launches")
    return {"batch_ms": float(batch_ms.mean()),
            "thread_ms": float(ms["thread"].mean()),
            "premade_ms": float(ms["premade"].mean())}


OPTIONS_ITERS = 12   # call A: three loop calls of steps_per_call 4
FROZEN_ITERS = 8     # call B
N_PANORAMAS = 64


class StepTimer:
    """While entered, every TrainStep call (one training iteration's step,
    also inside steps_per_call's calls) is synchronised before and after;
    its flags and ms are recorded in .steps."""

    def __enter__(self):
        from spgan_tpu_torch.train import step as step_mod

        self.cls, self.steps = step_mod.TrainStep, []
        orig = self.orig = self.cls.__call__

        def timed(obj, state, patch, ac, gen, do_r1, do_ppl):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(obj, state, patch, ac, gen, do_r1=do_r1, do_ppl=do_ppl)
            torch.cuda.synchronize()
            self.steps.append((do_r1 or do_ppl,
                               (time.perf_counter() - t0) * 1e3))
            return out

        self.cls.__call__ = timed
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig

    def plain_ms(self):
        """The unregularised steps after the first 2."""
        return np.array([ms for i, (reg, ms) in enumerate(self.steps)
                         if i >= 2 and not reg])


def _edited_yaml(shipped, path, sections):
    """`shipped` with the keys of `sections` ({section: {key: value}}) set:
    a key the file has keeps its line, a key it lacks goes in under its
    section's header."""
    import re

    def literal(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(list(v)) if isinstance(v, (list, tuple)) else str(v)

    text = open(shipped).read()
    for section, keys in sections.items():
        for key, val in keys.items():
            text, n = re.subn(rf"^(\s+{key}:) .*$", rf"\g<1> {literal(val)}",
                              text, flags=re.M)
            if n == 0:
                text, n = re.subn(rf"^({section}:)$",
                                  rf"\g<1>\n  {key}: {literal(val)}", text,
                                  flags=re.M)
            if n != 1:
                raise AssertionError(f"{section}.{key}: {n} lines")
    with open(path, "w") as f:
        f.write(text)
    return os.path.abspath(path)


def _baseline_state_dict(params):
    """An InfinityGAN-baseline-shaped torch state dict (reference key
    names, torch layouts) of the port's generator `params`: the texture
    synthesizer and the SS planar convs, these at conv_stack.{i}; no
    sphere convs, shortcuts or sphere skip convs."""
    sd = {}

    def linear(prefix, p):
        sd[f"{prefix}.weight"] = p["weight"]
        sd[f"{prefix}.bias"] = p["bias"]

    def modconv(prefix, p):
        sd[f"{prefix}.weight"] = p["weight"][None]
        linear(f"{prefix}.modulation", p["modulation"])

    ts = params["ts"]
    for i, p in enumerate(ts["mapping"]):
        linear(f"texture_synthesizer.mapping.{i + 1}", p)
    for i, p in enumerate(ts["convs"]):
        pre = f"texture_synthesizer.convs.{i}"
        modconv(f"{pre}.conv", p["conv"])
        sd[f"{pre}.activate.bias"] = p["act_bias"]
        sd[f"{pre}.noise.weight"] = p["noise"]["weight"].reshape(1)
    for j, p in enumerate(ts["to_rgbs"]):
        pre = f"texture_synthesizer.to_rgbs.{j}"
        modconv(f"{pre}.conv", p["conv"])
        sd[f"{pre}.bias"] = p["bias"].reshape(1, 3, 1, 1)
    for i, blk in enumerate(params["ss"]["blocks"]):
        pre = f"structure_synthesizer.implicit_model.conv_stack.{i}.conv"
        modconv(f"{pre}.conv", blk["planar"]["conv"])
        sd[f"{pre}.activate.bias"] = blk["planar"]["act_bias"]
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _ext_sampler_check(card_str):
    """B3 against its plain version at the widths of the extrapolated
    grids' first SS layers (W = 45 and 65, C = 259, B = 16) on those
    windows' tables with their own column margins, float32 and bf16,
    exact; its row plan at each.  The widest rows B3 stages; the grids
    themselves do not run it (their windows need the patch grids)."""
    from spgan_tpu_torch.geometry.coords import CoordGrid
    from spgan_tpu_torch.geometry.sphere_grid import sphere_offset_tables_batch
    from spgan_tpu_torch.models.generator import skip_margin
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss

    B, C = 16, 259
    rng = np.random.RandomState(10)
    out = {}
    for H in (45, 65):
        _, _, cp = CoordGrid().sample_training_extrap(
            torch.Generator(device="cuda").manual_seed(H), B, H)
        tables = {k: v.contiguous()
                  for k, v in sphere_offset_tables_batch(cp, H, H).items()}
        margin = skip_margin(tables)
        x32 = torch.as_tensor(rng.randn(B, H, H, C).astype(np.float32)).cuda()
        err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            err = max(err, check_close(
                f"sphere_sample_taps EXT H={H} {dtype}",
                ss.sphere_sample_taps(x, tables, margin),
                ss.sphere_sample_taps_plain(x, tables, margin), 0.0, 0.0))
            slots, smem, per_sm = ss.staging_plan(
                torch.cuda.current_device(), H, C, dtype == torch.bfloat16)
            print(f"[train-options] sphere_sample_taps EXT H=W={H} C={C} "
                  f"B={B} {str(dtype)[6:]}: exact (max_abs_err {err:.1e}), "
                  f"column margin {margin}, {slots} row slots, {smem} bytes "
                  f"dynamic shared memory, {per_sm} blocks per SM")
        ms = time_ms(lambda: ss.sphere_sample_taps(x32, tables, margin), 10)
        print(f"[train-options] {card_str}: sphere_sample_taps EXT H={H} "
              f"f32 back to back {ms:.4f} ms")
        out[H] = err
    return max(out.values())


def phase_train_options(card_str, plain_step_ms):
    """Every ported training option at full width (configs/model/spgan.yaml,
    batch 16, float32) in two in-process calls of the training CLI.  Call
    A: an LMDB of synthetic panoramas (Paeth-filtered PNGs, decoded
    in-tree), the projection head, SS noise, ss_mapping, the extrapolated
    grids, steps_per_call 4 and lr_sch; then the inference CLI renders its
    checkpoint directory in bf16.  Call B: a folder of the same PNGs, SGD
    and a frozen baseline transfer; the frozen G leaves and the whole D
    must come out unchanged."""
    import importlib.util
    import shutil

    from spgan_tpu_torch.compat.baseline import import_torch_baseline_generator
    from spgan_tpu_torch.config import load_config
    from spgan_tpu_torch.data.pipeline import SyntheticPanoramas, TrainPipeline
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
    from spgan_tpu_torch.ops.spatial import out_size_chain
    from spgan_tpu_torch.train import loop
    from spgan_tpu_torch.train.checkpoint import CheckpointManager
    from spgan_tpu_torch.train.state import create_train_state
    from spgan_tpu_torch.tree import flatten
    from spgan_tpu_torch.utils.png import encode_png

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from helpers.lmdb_writer import write_lmdb  # stdlib only

    shipped = os.path.join(repo, "configs", "model", "spgan.yaml")
    t_phase = time.perf_counter()
    ext_err = _ext_sampler_check(card_str)
    old = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_options_")
    try:
        os.chdir(tmp)
        src = SyntheticPanoramas((768, 256), n=N_PANORAMAS, seed=5)
        t0 = time.perf_counter()
        pngs = [encode_png(src[i], filter_type=4) for i in range(len(src))]
        write_lmdb("lmdb", {f"256-{i:08d}".encode(): d
                            for i, d in enumerate(pngs)})
        os.makedirs("folder")
        for i, d in enumerate(pngs):
            with open(os.path.join("folder", f"pano{i:03d}.png"), "wb") as f:
                f.write(d)
        print(f"[train-options] {len(pngs)} panoramas 256x768 as Paeth PNGs "
              f"({sum(map(len, pngs))} bytes) in an LMDB and a folder, "
              f"{time.perf_counter() - t0:.1f} s")
        a_yaml = _edited_yaml(shipped, "options_lmdb.yaml", {
            "data_params": {"source": "lmdb",
                            "folder": os.path.abspath("lmdb")},
            "train_params": {"coord_use_pd": True, "coord_pd_w": 1.0,
                             "ss_disable_noise": False, "ss_mapping": True,
                             "no_ext": False, "steps_per_call": 4,
                             "lr_sch": [8]},
            "log_params": {"log_tick": 4, "img_tick": 8, "save_tick": 12}})
        a_bf16 = _edited_yaml(a_yaml, "options_lmdb_bf16.yaml", {
            "train_params": {"compute_dtype": "bfloat16"}})
        b_yaml = _edited_yaml(shipped, "frozen_folder.yaml", {
            "data_params": {"source": "folder",
                            "folder": os.path.abspath("folder")},
            "train_params": {"optimizer": "sgd", "freeze": True},
            "log_params": {"log_tick": 4, "save_tick": 1000}})
        cfg_a, cfg_b = load_config(a_yaml), load_config(b_yaml)
        for cfg in (cfg_a, cfg_b):
            tp = cfg.train_params
            if (tp.batch_size, tp.compute_dtype, tp.local_latent_dim,
                    tp.global_latent_dim, tp.ss_n_layers) != \
                    (16, "float32", 256, 512, 4):
                raise AssertionError("the options yaml is not the shipped "
                                     "model at full width")
        want_a_opts = dict(coord_use_pd=True, coord_pd_w=1.0,
                           ss_disable_noise=False, ss_mapping=True,
                           no_ext=False, steps_per_call=4, lr_sch=[8])
        for k, v in want_a_opts.items():
            if getattr(cfg_a.train_params, k) != v:
                raise AssertionError(f"call A yaml: {k}")

        # the loaders alone on this thread: decoding and make_batch
        loader_ms = {}
        for name, cfg in (("lmdb", cfg_a), ("folder", cfg_b)):
            pipe = TrainPipeline(cfg, seed=0)
            pipe.close()
            if not np.array_equal(pipe.load(3), src[3]):
                raise AssertionError(f"{name}: decoded pixels differ")
            dec = []
            for rep in range(3):
                t0 = time.perf_counter()
                for i in range(16):
                    pipe.load(16 * rep + i)
                dec.append((time.perf_counter() - t0) * 1e3)
            rng = np.random.RandomState(0)
            batch = []
            for _ in range(4):
                t0 = time.perf_counter()
                pipe.make_batch(rng)
                batch.append((time.perf_counter() - t0) * 1e3)
            loader_ms[name] = float(np.mean(batch[1:]))
            print(f"[train-options] {card_str}: {name} source, on the calling"
                  f" thread: decoding 16 PNGs {np.mean(dec):.1f} ms (each "
                  f"{', '.join(f'{t:.1f}' for t in dec)}); make_batch of 16 "
                  f"(decode, two Lanczos4 resizes, flip, crop) "
                  f"{loader_ms[name]:.1f} ms (each "
                  f"{', '.join(f'{t:.1f}' for t in batch[1:])}, after the "
                  f"first {batch[0]:.1f})")

        tb = importlib.util.find_spec("tensorboardX") is not None
        per_fwd = Generator.from_config(cfg_a).ss.n_layers
        mults = loop.ext_mult_list(cfg_a)
        # the three grids on training crops run the sample-mode convs; the
        # extrapolated ones run on the patch grids and launch no tap sampler
        per_grids = 3 * per_fwd
        want_a = 2 * per_fwd * OPTIONS_ITERS + (per_grids if tb else 0)
        want_b = 2 * per_fwd * FROZEN_ITERS
        print(f"[train-options] expected tap-sampler launches: call A "
              f"{want_a} (2 x {per_fwd} an iteration x {OPTIONS_ITERS}"
              f"{f' + {per_grids} for the grids at iteration 8' if tb else ''}"
              f"; no PPL before g_path_start), the grids called twice "
              f"{2 * per_grids} (3 forwards x {per_fwd} on training crops; "
              f"the ext mults {mults} on the patch grids, none), call B "
              f"{want_b}")

        def counts():
            return {"fused_sphere_conv_grouped":
                    sk.fused_sphere_conv_grouped.launches,
                    "fused_sphere_conv": sk.fused_sphere_conv.launches,
                    "sphere_sample_taps": ss.sphere_sample_taps.launches}

        def zero():
            sk.fused_sphere_conv_grouped.launches = 0
            sk.fused_sphere_conv.launches = 0
            ss.sphere_sample_taps.launches = 0

        def want(n):
            return {"fused_sphere_conv_grouped": 0, "fused_sphere_conv": 0,
                    "sphere_sample_taps": n}

        # ---- call A ---------------------------------------------------
        pipes_a = []
        zero()
        with StepTimer() as timer_a:
            t0 = time.perf_counter()
            state_a, out_a = _run_train_cli(
                [a_yaml, "--max-iters", str(OPTIONS_ITERS)], pipes_a,
                TrainPipeline)
            wall_a = time.perf_counter() - t0
        launches_a = counts()["sphere_sample_taps"]
        if counts() != want(want_a):
            raise AssertionError(f"call A launches {counts()}, want {want_a}")
        mgr = CheckpointManager(os.path.join("logs", "options_lmdb", "ckpt"))
        if state_a.step != OPTIONS_ITERS or mgr.steps() != [12]:
            raise AssertionError(f"call A: step {state_a.step}, checkpoints "
                                 f"{mgr.steps()}")
        _finite_log_lines(out_a, (4, 8, 12))
        flat_g = dict(flatten(state_a.params_g))
        if "coord_proj" not in state_a.params_d or \
                "ss/mapping/7/weight" not in flat_g or \
                "ss/blocks/3/planar/noise/weight" not in flat_g:
            raise AssertionError("call A's state lacks the option leaves")
        steps_a = timer_a.plain_ms()
        stamps = np.array(pipes_a[0].stamps)
        calls = np.diff(stamps[[0, 4, 8, 12]]) * 1e3
        waits = np.array(pipes_a[0].load_ms)
        waits_a = (waits[:4], waits[4:])
        print(f"[train-options] {card_str}: call A (lmdb, pd head, SS noise, "
              f"ss_mapping, EXT grids, steps_per_call 4, lr_sch [8]): "
              f"{steps_a.mean():.1f} ms per plain step (median "
              f"{np.median(steps_a):.1f}, min {steps_a.min():.1f}, max "
              f"{steps_a.max():.1f}, {len(steps_a)} steps after the first 2, "
              f"each synchronised) beside phase 7's bare step "
              f"{plain_step_ms:.1f} ms; loop calls of 4 iterations with data "
              f"and ticks {', '.join(f'{c:.1f}' for c in calls)} ms (the "
              f"first holds R1 and the warm-up, the last the checkpoint "
              f"save), {calls[1] / 4:.1f} ms an iteration in the plain one; "
              f"prefetch-queue waits per batch: first loop call "
              f"{', '.join(f'{w:.2f}' for w in waits_a[0])} ms, later calls "
              f"mean {waits_a[1].mean():.2f} (max {waits_a[1].max():.2f}, "
              f"{len(waits_a[1])} batches); {wall_a:.1f} s wall; "
              f"{launches_a} tap-sampler launches")

        # the image grids, extrapolated ones included, called twice
        g = Generator.from_config(cfg_a)
        grids = loop.make_image_grids(cfg_a, g, seed=0, device="cuda")
        zero()
        for _ in range(2):
            out = grids(state_a.params_g_ema, state_a.step)
        if counts() != want(2 * per_grids):
            raise AssertionError(f"grids launches {counts()}")
        ts_in = cfg_a.train_params.ts_input_size // 2
        size = {m: out_size_chain(g.ts.conv_specs_spatial(),
                                  int(round(ts_in * m)) * 2 + 1)[-1]
                for m in mults}
        shapes = {k: v.shape for k, v in out.items()}
        want_shapes = {"samples/ema": (202, 808, 3),
                       "samples/style_diversity": (101, 808, 3),
                       "samples/structure_diversity": (101, 808, 3),
                       **{f"samples/ema_ext{m}":
                          (16 // max(1, 8 // m) * size[m],
                           max(1, 8 // m) * size[m], 3) for m in mults}}
        if shapes != want_shapes or not all(v.std() > 0
                                            for v in out.values()):
            raise AssertionError(f"grids {shapes}, want {want_shapes}")
        print(f"[train-options] {card_str}: image grids {shapes}; ms of each "
              f"(second call, forward + copy to the host) "
              f"{ {k: round(v, 1) for k, v in grids.ms.items()} }")

        # the inference CLI from call A's checkpoint directory, bf16
        m, per_batch = run_cli(
            ["--model-config", a_bf16, "--test-config",
             os.path.join(repo, "configs", "test", "spgan_384x768.yaml"),
             "--ckpt", mgr.ckpt_dir, "--num-gen", "16", "--save-root",
             "render"], want_per_batch=48)
        _equal_trees(m.params_ema, state_a.params_g_ema, "infer CLI weights")
        pngs_out = sorted(f for f in os.listdir("render")
                          if f.endswith(".png"))
        sizes = {png_size(os.path.join("render", f)) for f in pngs_out}
        if len(pngs_out) != 16 or sizes != {(768, 384)} or \
                m.engine.g.ss.disable_noise or \
                m.engine.compute_dtype != "bfloat16":
            raise AssertionError(f"infer CLI wrote {len(pngs_out)} PNGs of "
                                 f"{sizes}")
        print(f"[train-options] infer CLI (bf16, SS noise, ss_mapping) from "
              f"call A's checkpoint directory: 16 PNGs of 768x384, "
              f"{per_batch} grouped-kernel launches in the batch")
        del m

        # ---- call B ---------------------------------------------------
        gb = Generator.from_config(cfg_b)
        sd = _baseline_state_dict(gb.init(torch.Generator().manual_seed(11),
                                          device="cpu"))
        torch.save({"g_ema": sd}, "baseline.ckpt")
        pipes_b = []
        zero()
        with StepTimer() as timer_b:
            t0 = time.perf_counter()
            state_b, out_b = _run_train_cli(
                [b_yaml, "--max-iters", str(FROZEN_ITERS), "--baseline-ckpt",
                 "baseline.ckpt"], pipes_b, TrainPipeline)
            wall_b = time.perf_counter() - t0
        launches_b = counts()["sphere_sample_taps"]
        if counts() != want(want_b) or state_b.step != FROZEN_ITERS or \
                "(frozen)" not in out_b:
            raise AssertionError(f"call B: launches {counts()} (want "
                                 f"{want_b}), step {state_b.step}")
        _finite_log_lines(out_b, (4, 8))
        start = create_train_state(cfg_b, gb, Discriminator.from_config(cfg_b),
                                   torch.Generator().manual_seed(0),
                                   device="cuda")
        loaded, mask = import_torch_baseline_generator(sd, gb, start.params_g)
        _equal_trees(state_b.params_d, start.params_d, "call B frozen D")
        n_frozen = moved = 0
        for (k, a), (_, b), (_, f) in zip(flatten(state_b.params_g),
                                          flatten(loaded), flatten(mask)):
            if f:
                n_frozen += 1
                if not torch.equal(a, b):
                    raise AssertionError(f"call B: frozen leaf {k} moved")
            else:
                moved += not torch.equal(a, b)
        if not (n_frozen and moved):
            raise AssertionError(f"call B: {n_frozen} frozen, {moved} moved")
        steps_b = timer_b.plain_ms()
        per_it = np.diff(pipes_b[0].stamps)[2:] * 1e3
        waits = np.array(pipes_b[0].load_ms)
        print(f"[train-options] {card_str}: call B (folder, SGD, frozen "
              f"baseline): {n_frozen} G leaves and the whole D unchanged bit "
              f"for bit, {moved} G leaves moved; {steps_b.mean():.1f} ms per "
              f"plain step (median {np.median(steps_b):.1f}, {len(steps_b)} "
              f"steps) and {per_it.mean():.1f} ms per iteration with data "
              f"and ticks (median {np.median(per_it):.1f}, {len(per_it)} "
              f"iterations after the first 2) beside phase 7's bare step "
              f"{plain_step_ms:.1f} ms; prefetch-queue waits per batch: "
              f"first 2 {', '.join(f'{w:.2f}' for w in waits[:2])} ms, later "
              f"mean {waits[2:].mean():.2f} (max {waits[2:].max():.2f}); "
              f"{wall_b:.1f} s wall; {launches_b} tap-sampler launches")
    finally:
        os.chdir(old)
        shutil.rmtree(tmp)
    print(f"[train-options] phase 10 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"sphere_sample_taps": launches_a + launches_b,
            "ext_max_abs_err": ext_err, "render_per_batch": per_batch,
            "loader_ms": loader_ms}

FID_ITERS = 4        # the FID CLI call: eval and fid_ext2 ticks at 2 and 4
FID_TICK = 2
# spgan_run30k_bf16.yaml ships n_fid_sample 2048; phase 11 alone then
# takes ~260 s on an H100 (two sqrtm-bound FID and two generation-bound
# EXT2 ticks), so the whole script would pass ~560 s: cut to a quarter
N_FID_SAMPLE = 512
CLI_SET = 256        # images in each offline-CLI set (256x768 panoramas)


class FIDTickRecorder:
    """While entered, each TrainFID call (a FID or EXT2-FID tick) is
    synchronised before and after and recorded in .ticks: its kind,
    value, the evaluator's own split (.ms), the wall ms, the tap-sampler
    launches inside it and the peak device memory."""

    def __enter__(self):
        from spgan_tpu_torch.ops.kernels import sphere_sample as ss
        from spgan_tpu_torch.train import evals

        self.cls, self.ticks = evals.TrainFID, []
        orig = self.orig = self.cls.__call__

        def recorded(obj, params, gen, n_sample=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n0 = ss.sphere_sample_taps.launches
            t0 = time.perf_counter()
            val = orig(obj, params, gen, n_sample)
            torch.cuda.synchronize()
            self.ticks.append({
                "kind": "fid_ext2" if obj.ext2 else "fid", "value": val,
                "ms": dict(obj.ms),
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "b3": ss.sphere_sample_taps.launches - n0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
            return val

        self.cls.__call__ = recorded
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


def _eval_nets_on_card(card_str):
    """Inception (features, logits) and LPIPS on cuda against the same
    networks on cpu at batch 4 (float32, TF32 off; the 101^2 patch and the
    256x768 panorama, which the resize shrinks); then how far TF32 moves
    the features of 64 patches."""
    from spgan_tpu_torch.evalkit.fid import tf32_off
    from spgan_tpu_torch.evalkit.inception import random_inception
    from spgan_tpu_torch.evalkit.lpips import random_lpips

    rng = np.random.RandomState(12)
    errs = {}
    with torch.no_grad(), tf32_off():
        for with_logits in (False, True):
            gpu = random_inception(with_logits=with_logits, device="cuda")
            cpu = random_inception(with_logits=with_logits, device="cpu")
            for h, w in ((101, 101), (256, 768)):
                x = torch.as_tensor(rng.uniform(-1, 1, (4, h, w, 3)).astype(
                    np.float32))
                ref = cpu(x)
                name = (f"inception {'logits' if with_logits else 'features'}"
                        f" {h}x{w}")
                errs[name] = check_close(name, gpu(x.cuda()).cpu(), ref,
                                         1e-4 * float(ref.abs().max()), 1e-3)
        gpu, cpu = random_lpips(device="cuda"), random_lpips(device="cpu")
        x, y = (torch.as_tensor(rng.uniform(-1, 1, (4, 256, 768, 3)).astype(
            np.float32)) for _ in range(2))
        ref = cpu(x, y)
        errs["lpips 256x768"] = check_close(
            "lpips", gpu(x.cuda(), y.cuda()).cpu(), ref,
            1e-4 * float(ref.abs().max()), 1e-3)
    print(f"[fid] inception and LPIPS, cuda vs cpu at batch 4 (float32, "
          f"TF32 off; limit 1e-4 of the largest value + 1e-3 rel): max abs "
          f"err {json.dumps(errs)}")

    net = random_inception(device="cuda")
    x = torch.as_tensor(rng.uniform(-1, 1, (64, 101, 101, 3)).astype(
        np.float32)).cuda()
    with torch.no_grad():
        with tf32_off():
            off = net(x)
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            on = net(x)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    d = (on - off).abs()
    rel = float(d.max() / off.abs().max())
    print(f"[fid] {card_str}: TF32 on vs off, pool3 features of 64 random "
          f"101^2 patches (random inception): max abs diff "
          f"{float(d.max()):.3e} ({rel:.3e} of the largest feature), mean "
          f"abs diff {float(d.mean()):.3e} (features' mean abs "
          f"{float(off.abs().mean()):.3e})")
    return max(errs.values()), rel


def phase_fid(card_str, n_fid_sample=N_FID_SAMPLE):
    """FID at full width.  The training CLI in process on
    configs/model/spgan_run30k_bf16.yaml (batch 16, bf16 training,
    calc_fid and calc_fid_ext2 on), edited only in its data file (an .spr
    of synthetic panoramas), its eval and fid_ext2 ticks and n_fid_sample
    (the shipped 2048 runs as phase_fid(card(), 2048)), run FID_ITERS
    iterations with SPGAN_TPU_INCEPTION=random: each tick fires twice,
    the second on a warm .fid-cache.  Then
    the inference CLI renders 16 panoramas from best_fid.pt, and the
    offline eval CLI runs fid, stats, fid from the .pkl, is and lpips on
    two .npy sets of synthetic 256x768 panoramas."""
    import re
    import shutil

    from spgan_tpu_torch.config import load_config
    from spgan_tpu_torch.data.native_loader import write_records
    from spgan_tpu_torch.data.pipeline import (NativeTrainPipeline,
                                               SyntheticPanoramas)
    from spgan_tpu_torch.evalkit.__main__ import main as eval_main
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss
    from spgan_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    net_err, tf32_rel = _eval_nets_on_card(card_str)
    repo = os.path.dirname(os.path.abspath(__file__))
    shipped = os.path.join(repo, "configs", "model",
                           "spgan_run30k_bf16.yaml")
    old, old_env = os.getcwd(), os.environ.get("SPGAN_TPU_INCEPTION")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fid_")
    try:
        os.chdir(tmp)
        src = SyntheticPanoramas((768, 256), n=N_PANORAMAS, seed=7)
        write_records("train.spr", np.stack([src[i]
                                             for i in range(len(src))]))
        edits = {"data_params": {"folder": os.path.abspath("train.spr")},
                 "log_params": {"eval_tick": FID_TICK,
                                "fid_ext2_tick": FID_TICK},
                 "test_params": {"n_fid_sample": n_fid_sample}}
        yaml_path = _edited_yaml(shipped, "spgan_run30k_bf16.yaml", edits)
        cfg, ref = load_config(yaml_path), load_config(shipped)
        ref.data_params.folder = cfg.data_params.folder
        ref.log_params.eval_tick = ref.log_params.fid_ext2_tick = FID_TICK
        ref.test_params.n_fid_sample = n_fid_sample
        tp, tep = cfg.train_params, cfg.test_params
        if cfg != ref or (tp.batch_size, tp.compute_dtype, tp.ss_n_layers,
                          tp.local_latent_dim, tep.calc_fid,
                          tep.calc_fid_ext2) != (16, "bfloat16", 4, 256,
                                                 True, True):
            raise AssertionError("the FID yaml is not the shipped "
                                 "spgan_run30k_bf16.yaml at full width "
                                 "beyond its data file, ticks and "
                                 "n_fid_sample")
        n_batches = n_fid_sample // tp.batch_size
        want_tick = {"fid": tp.ss_n_layers * n_batches, "fid_ext2": 0}
        want_train = 2 * tp.ss_n_layers * FID_ITERS
        print(f"[fid] spgan_run30k_bf16.yaml edited: {json.dumps(edits)}; "
              f"--max-iters {FID_ITERS}; SPGAN_TPU_INCEPTION=random; "
              f"expected tap-sampler launches: {want_tick['fid']} a FID tick "
              f"({tp.ss_n_layers} a batch x {n_batches} batches of "
              f"{tp.batch_size}), 0 an EXT2 tick (the patch grids), "
              f"{want_train} over the {FID_ITERS} training iterations")

        os.environ["SPGAN_TPU_INCEPTION"] = "random"
        sk.fused_sphere_conv_grouped.launches = 0
        sk.fused_sphere_conv.launches = 0
        ss.sphere_sample_taps.launches = 0
        pipes = []
        t0 = time.perf_counter()
        with FIDTickRecorder() as rec:
            state, out = _run_train_cli([yaml_path, "--max-iters",
                                         str(FID_ITERS)], pipes,
                                        NativeTrainPipeline)
        wall = time.perf_counter() - t0
        launches = {
            "fused_sphere_conv_grouped": sk.fused_sphere_conv_grouped.launches,
            "fused_sphere_conv": sk.fused_sphere_conv.launches,
            "sphere_sample_taps": ss.sphere_sample_taps.launches}
        kinds = [t["kind"] for t in rec.ticks]
        ticks = {k: [t for t in rec.ticks if t["kind"] == k]
                 for k in ("fid", "fid_ext2")}
        if state.step != FID_ITERS or kinds != ["fid", "fid_ext2"] * 2 or \
                len(pipes) != 2 or pipes[1].inner._ld._full is None:
            raise AssertionError(f"FID call: step {state.step}, ticks "
                                 f"{kinds}, {len(pipes)} pipelines")
        for k, ts in ticks.items():
            for t in ts:
                if t["b3"] != want_tick[k] or not math.isfinite(t["value"]) \
                        or t["value"] <= 0:
                    raise AssertionError(f"{k} tick: {t}")
            # the second tick reads the real statistics from the cache
            if not ts[1]["ms"]["real_stats"] < 0.1 * ts[0]["ms"]["real_stats"]:
                raise AssertionError(f"{k}: the second tick's real stats "
                                     f"took {ts[1]['ms']['real_stats']} ms")
        if launches != {"fused_sphere_conv_grouped": 0,
                        "fused_sphere_conv": 0,
                        "sphere_sample_taps": want_train + sum(
                            want_tick[k] for k in kinds)}:
            raise AssertionError(f"FID call launches {launches}")
        printed = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^\[train\] iter \d+: (metric/fid(?:_ext2)?) (\S+)", out, re.M)}
        if set(printed) != {"metric/fid", "metric/fid_ext2"} or \
                "RANDOM inception weights" not in out:
            raise AssertionError("FID scalars or the random-weights warning "
                                 "missing from the log")
        ckpt = os.path.join("logs", "spgan_run30k_bf16", "ckpt")
        best = json.load(open(os.path.join(ckpt, "best.json")))
        files = sorted(os.listdir(ckpt))
        if not {"best.json", "best_fid.pt", "best_fid_ext2.pt"} <= set(files) \
                or CheckpointManager(ckpt).steps() or \
                best["best_fid"] != min(t["value"] for t in ticks["fid"]) or \
                best["best_ext2_fid"] != min(t["value"]
                                             for t in ticks["fid_ext2"]):
            raise AssertionError(f"FID snapshots {files}, best.json {best}")
        cache = sorted(os.listdir(".fid-cache"))
        for t in rec.ticks:
            print(f"[fid] {card_str}: {t['kind']} tick ({n_fid_sample} "
                  f"samples, batch {tp.batch_size}, float32 EMA weights): "
                  f"value {t['value']:.6g} (random inception: meaningless); "
                  f"ms real stats {t['ms']['real_stats']:.1f}, generation "
                  f"{t['ms']['generate']:.1f}, inception features "
                  f"{t['ms']['features']:.1f}, host Frechet (stats + 2048^2 "
                  f"sqrtm) {t['ms']['frechet']:.1f}; whole tick "
                  f"{t['wall_ms']:.1f} ms; {t['b3']} tap-sampler launches; "
                  f"peak device memory {t['peak_gib']:.2f} GiB")
        print(f"[fid] FID CLI call: {FID_ITERS} iterations in {wall:.1f} s "
              f"wall; {launches['sphere_sample_taps']} tap-sampler launches "
              f"({want_train} training + the ticks'); snapshots {files}; "
              f"best.json {json.dumps(best)}; .fid-cache {cache}")

        # the inference CLI from the best-FID snapshot
        m, per_batch = run_cli(
            ["--model-config", yaml_path, "--test-config",
             os.path.join(repo, "configs", "test", "spgan_384x768.yaml"),
             "--ckpt", os.path.join(ckpt, "best_fid.pt"), "--num-gen", "16",
             "--save-root", "render"], want_per_batch=48)
        pngs = sorted(f for f in os.listdir("render") if f.endswith(".png"))
        sizes = {png_size(os.path.join("render", f)) for f in pngs}
        if len(pngs) != 16 or sizes != {(768, 384)}:
            raise AssertionError(f"infer CLI wrote {len(pngs)} PNGs of "
                                 f"{sizes} from best_fid.pt")
        print(f"[fid] infer CLI from best_fid.pt: 16 PNGs of 768x384, "
              f"{per_batch} grouped-kernel launches in the batch")
        del m

        # the offline eval CLI on two sets of 256x768 panoramas
        del os.environ["SPGAN_TPU_INCEPTION"]
        for name, seed in (("a", 21), ("b", 22)):
            pano = SyntheticPanoramas((768, 256), n=CLI_SET, seed=seed)
            np.save(f"{name}.npy", np.stack([pano[i]
                                            for i in range(CLI_SET)]))
        secs = {}

        def cli(label, *argv):
            t = time.perf_counter()
            res = eval_main(list(argv) + ["--batch", "32",
                                          "--allow-random-weights"])
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t
            return res

        same = cli("fid self", "fid", "a.npy", "a.npy")
        stats = cli("stats", "stats", "b.npy", "--out", "b.pkl")
        dist = cli("fid from pkl", "fid", "b.pkl", "a.npy")
        score = cli("is", "is", "a.npy")
        lp = cli("lpips", "lpips", "a.npy", "b.npy")
        if not (abs(same["value"]) < 1e-3 and dist["value"] > 0
                and stats["n"] == CLI_SET and dist["n_a"] == CLI_SET
                and score["value"] >= 1 - 1e-5 and lp["value"] > 0
                and all("WARNING" in r for r in (same, stats, dist, score,
                                                 lp))):
            raise AssertionError(f"eval CLI: fid self {same}, from .pkl "
                                 f"{dist}, is {score}, lpips {lp}")
        print(f"[fid] {card_str}: offline eval CLI on two sets of {CLI_SET} "
              f"synthetic 256x768 panoramas (random networks, batch 32): "
              f"fid a vs a {same['value']:.3e} ({secs['fid self']:.2f} s, "
              f"{2 * CLI_SET / secs['fid self']:.1f} images/s with its "
              f"sqrtm); stats of b {secs['stats']:.2f} s "
              f"({CLI_SET / secs['stats']:.1f} images/s); fid b.pkl vs a "
              f"{dist['value']:.6g} ({secs['fid from pkl']:.2f} s); is "
              f"{score['value']:.4f} ({secs['is']:.2f} s, "
              f"{CLI_SET / secs['is']:.1f} images/s); lpips a vs b "
              f"{lp['value']:.4f} ({secs['lpips']:.2f} s, "
              f"{CLI_SET / secs['lpips']:.1f} pairs/s)")
    finally:
        os.chdir(old)
        shutil.rmtree(tmp)
        if old_env is None:
            os.environ.pop("SPGAN_TPU_INCEPTION", None)
        else:
            os.environ["SPGAN_TPU_INCEPTION"] = old_env
    print(f"[fid] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"tick_launches": {k: [t["b3"] for t in ts]
                              for k, ts in ticks.items()},
            "train_launches": want_train, "net_max_abs_err": net_err,
            "tf32_rel": tf32_rel, "render_per_batch": per_batch}


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
    sample = phase_sample_kernel()
    phase_parity()
    phase_parity(planar=True)
    engine_launches = phase_engine(card_str)
    cli_launches = phase_cli(card_str)
    patch_launches = phase_patch()
    phase_train_parity()
    train_launches, plain_step_ms = phase_train(card_str)
    train_cli = phase_train_cli(card_str, plain_step_ms)
    phase_train_cli_synthetic(card_str, plain_step_ms, train_cli["plain_ms"])
    options = phase_train_options(card_str, plain_step_ms)
    fid = phase_fid(card_str)

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
        if name == "fused_sphere_conv_grouped":
            # its launches a batch on the inference CLI's two lattices
            line[-1]["cli_launches_per_batch"] = {
                "close_loop_384x768": cli_launches["close_loop"],
                "planar_256x512": cli_launches["planar"]}
            # its float32 body at the planar CLI's shapes vs the plain one
            line[-1]["planar_f32_max_abs_err"] = \
                cli_launches["planar_f32_max_abs_err"]
            # its launches rendering the training CLIs' checkpoints
            line[-1]["train_cli_render_launches_per_batch"] = \
                train_cli["render_per_batch"]
            line[-1]["train_options_render_launches_per_batch"] = \
                options["render_per_batch"]
            # rendering phase 11's best_fid.pt snapshot
            line[-1]["fid_render_launches_per_batch"] = \
                fid["render_per_batch"]
    dev_ms = sum(r["device_ms"] for r in sample.values())
    bound_ms = sum(r["bound_ms"] for r in sample.values())
    line.append({
        "name": "sphere_sample_taps", "route": "cuda",
        "source": "spgan_tpu_torch/csrc/sphere_sample.cu",
        "replaces": "spgan_tpu/ops/pallas/sphere_sample.py:60",
        # over the timed training run: 3 plain steps (8 each) + 1 R1+PPL
        # step (12)
        "launches": train_launches["sphere_sample_taps"],
        # over the training CLI's 30 iterations (8 each) and one call of
        # the image grids (3 forwards of 4 SS layers)
        "train_cli_launches": train_cli["sphere_sample_taps"],
        # over phase 10's two training CLI calls (12 + 8 iterations)
        "train_options_launches": options["sphere_sample_taps"],
        # at the extrapolated grids' shapes (W 45 and 65), f32 and bf16
        "ext_max_abs_err": options["ext_max_abs_err"],
        # in each of phase 11's FID and EXT2-FID ticks (spgan_run30k_bf16
        # .yaml, n_fid_sample generations of batch 16), and over its
        # training iterations
        "fid_tick_launches": fid["tick_launches"],
        "fid_train_launches": fid["train_launches"],
        "max_abs_err": max(r["err"] for r in sample.values()),
        # one launch at each of the four SS shapes, B=16, C=259, float32
        # back to back from the host (host time included)
        "ms": sum(r["ms"] for r in sample.values()),
        # the kernel's own time (torch.profiler), and the traces taken
        # for it over the four sizes (4 when none missed a launch)
        "device_ms": dev_ms,
        "device_ms_traces": sum(r["traces"] for r in sample.values()),
        "gb_per_s": sum(r["bytes"] for r in sample.values()) / dev_ms / 1e6,
        "pct_bound": 100 * bound_ms / dev_ms,
        "plain_ms": sum(r["plain_ms"] for r in sample.values()),
        "bound_ms": bound_ms,
        "bound_by": sample[35]["bound_by"],
        "library_ms": sum(r["library_ms"] for r in sample.values()),
    })
    print(json.dumps({"kernels": line}))
    print(card_str)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
