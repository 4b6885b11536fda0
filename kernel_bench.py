#!/usr/bin/env python3
"""Build report and timings of the port's hand-written CUDA kernels on one
NVIDIA GPU: the figures of PERF.md's kernel table.

    python3 kernel_bench.py [build] [b1] [b3] [u1] [e1] [f1]

(all six without an argument; each names one part):

  build  every spgan_tpu_torch/csrc/*.cu compiled afresh into a temporary
         directory: nvcc's registers, spills and shared memory, the
         runtime's attributes of the sphere conv, HGMMA (warpgroup MMA)
         in its SASS (none fails the run), and the memory instructions
         of the tap sampler (shared loads, cp.async, streaming stores,
         local memory), of the styled conv epilogue and of the filtered
         LeakyReLU
  b1     the sphere conv B1 (grouped, B=64 in 4 groups) and B2 (per
         sample, B=16), bf16, C=Cout=256, at each SS size of the shipped
         384x768 plan on its tables
  b3     the tap sampler B3, float32, B=16, C=259, at each SS size on the
         tables of random training crops
  u1     upfirdn2d at the cells' blur shapes (SHAPES)
  e1     the styled conv epilogue at the render cells' largest TS conv
         outputs (EPILOGUE_SHAPES)
  f1     StyleGAN3's filtered LeakyReLU at L9-L13 of the 1024^2 schedule,
         batch 16, float16 (render-sg3t-1024's layers)

Each kernel is timed against its bound (the larger of its operations at
the card's published peak and its bytes at the peak bandwidth), against
its plain PyTorch version and against a library call (B1/B2: cuDNN's
dense 3x3 conv of the same FLOPs, a yardstick only; B3: grid_sample and a
permute, the same samples; U1: one grouped conv, the call the port made
before; E1: the five PyTorch passes StyledConv ran before, whose device
time is every kernel of a call; F1: none, its plain version, the
composed op the port ran before, is the yardstick, and its FIR
multiply-adds at the float32 peak are a second bound beside its
bytes).  "ms" is CUDA events around 20 back-to-back calls (host time
included); "device_ms" the kernel's own time in a torch.profiler trace
of 20 calls, read from the raw device events as portbench/trace.py reads
them.  The last line is one JSON object: the card, its power limit and
each kernel's figures.  Correctness is the card tests' job (`python -m
pytest --noconftest -q -m gpu tests/test_*_card.py`); the max abs error
against the plain version is printed beside each time.  Imports no JAX.
"""
import collections
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12    # dense bf16, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3
SS_SIZES = (35, 29, 23, 17)
ITERS = 20
# (what, B, H, W, C, stencil, gain, up, down, pads (py0, py1, px0, px1),
# dtype): the planar TS's largest blur (a chunk of 4 x 16 patches,
# 105^2 x 512), the training TS's largest blur and its adjoint, D's first
# blur (16 x 101^2 x 256, [1, 3, 3, 1], pad 2) and its skip's (pad 1),
# and render-360's largest blur in bf16
SHAPES = (
    ("planar TS blur", 64, 105, 105, 512, (1.0, 2.0, 1.0), 4.0, 1, 1,
     (0, 0, 0, 0), torch.float32),
    ("training TS blur", 16, 105, 105, 512, (1.0, 2.0, 1.0), 4.0, 1, 1,
     (0, 0, 0, 0), torch.float32),
    ("training TS blur adjoint", 16, 103, 103, 512, (1.0, 2.0, 1.0), 4.0, 1,
     1, (2, 2, 2, 2), torch.float32),
    ("D first blur", 16, 101, 101, 256, (1.0, 3.0, 3.0, 1.0), 1.0, 1, 1,
     (2, 2, 2, 2), torch.float32),
    ("D first skip blur", 16, 101, 101, 256, (1.0, 3.0, 3.0, 1.0), 1.0, 1,
     1, (1, 1, 1, 1), torch.float32),
    ("render-360 TS blur", 64, 105, 105, 512, (1.0, 2.0, 1.0), 4.0, 1, 1,
     (0, 0, 0, 0), torch.bfloat16),
)

# (what, B, H, C, dtype): the largest styled conv outputs a chunk of 64
# patches makes: the 101 plan's last TS conv (render-360 in bf16, planar
# in float32) and the 197 plan's last (render-360-p197)
EPILOGUE_SHAPES = (
    ("render-360 TS conv 8", 64, 101, 512, torch.bfloat16),
    ("p197 TS conv 10", 64, 197, 256, torch.bfloat16),
    ("planar TS conv 8", 64, 101, 512, torch.float32),
)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=ITERS, warmup=2):
    """CUDA events around `iters` back-to-back calls, per call."""
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


def device_ms(fn, kernel):
    """The device time per launch of the operations named `kernel` in a
    trace of ITERS calls (portbench/trace.py's raw-event reader), and the
    launches it saw."""
    from portbench import trace

    def run():
        for _ in range(ITERS):
            fn()

    fn()
    records = {}
    trace.profile(run, records)
    hits = [v for k, v in records["kernels"].items() if kernel in k]
    n = sum(v[1] for v in hits)
    if n == 0:
        raise AssertionError(f"no {kernel} launch in the trace")
    return sum(v[0] for v in hits) * 1e3 / n, n


def device_ms_per_call(fn):
    """The device time of every kernel of `fn`, per call, in a trace of
    ITERS calls."""
    from portbench import trace

    def run():
        for _ in range(ITERS):
            fn()

    fn()
    records = {}
    trace.profile(run, records)
    return sum(v[0] for v in records["kernels"].values()) * 1e3 / ITERS


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def show(kind, row):
    print(f"[{kind}] " + json.dumps(row))
    return row


def phase_build():
    """nvcc into a fresh directory, so its report is always printed."""
    import ctypes

    from spgan_tpu_torch.utils import native

    native.BUILD_DIR = Path(tempfile.mkdtemp(prefix="kernel_bench_"))
    logs = native.build_cuda(native.cuda_sources())
    out = {"report": {}}
    for name, log in logs.items():
        out["report"][name] = [line.strip() for line in log.splitlines()
                               if any(w in line for w in
                                      ("registers", "spill", "arning"))]
    fn = native.load_cuda("sphere_conv").sphere_conv_attributes
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    for dtype, what in ((1, "sphere_conv_bf16"), (0, "sphere_conv_f32")):
        vals = [ctypes.c_int(0) for _ in range(3)]
        err = fn(dtype, *(ctypes.byref(v) for v in vals))
        if err:
            raise RuntimeError(f"sphere_conv_attributes: cudaError {err}")
        out[what] = dict(zip(("registers", "local_bytes", "dynamic_smem"),
                             (v.value for v in vals)))
    cuobjdump = os.path.join(os.path.dirname(native.find_nvcc()), "cuobjdump")

    def sass(name):
        return subprocess.run([cuobjdump, "-sass",
                               str(native.cuda_library_path(name))],
                              check=True, capture_output=True,
                              text=True).stdout

    out["sphere_conv_hgmma"] = sum("HGMMA" in line for line in
                                   sass("sphere_conv").splitlines())
    out["sphere_sample_memory_ops"] = dict(sorted(collections.Counter(
        re.findall(r"\b(?:LDS|LDGSTS|STG|LDL|STL)[A-Z0-9._]*",
                   sass("sphere_sample"))).items()))
    out["styled_epilogue_memory_ops"] = dict(sorted(collections.Counter(
        re.findall(r"\b(?:LDG|STG|LDL|STL)[A-Z0-9._]*",
                   sass("styled_epilogue"))).items()))
    out["filtered_lrelu_memory_ops"] = dict(sorted(collections.Counter(
        re.findall(r"\b(?:LDG|STG|LDS|STS|LDL|STL)[A-Z0-9._]*",
                   sass("filtered_lrelu"))).items()))
    show("build", out)
    if out["sphere_conv_hgmma"] == 0:
        raise AssertionError("no HGMMA in sphere_conv's SASS")
    return out


def engine_tables(positions, H):
    """Offset tables of the shipped 384x768 plan's lattice positions."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.coords import CoordsPartial
    from spgan_tpu_torch.geometry.sphere_grid import sphere_offset_tables_batch
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan
    from spgan_tpu_torch.models.generator import Generator

    plan = build_close_loop_plan(Generator.from_config(Config()), 384, 768)
    cp = CoordsPartial.from_scalars(plan.cp_scalars[positions], plan.x_total,
                                    plan.y_total, 0.6667)
    return {k: v.cuda().contiguous()
            for k, v in sphere_offset_tables_batch(cp, H, H).items()}


def phase_b1():
    from spgan_tpu_torch.ops.kernels import sphere_kernel as sk

    B, G, C = 64, 4, 256
    rng = np.random.RandomState(0)
    positions = rng.choice(48, G, replace=False)
    rows = []
    for H in SS_SIZES:
        tg = engine_tables(positions, H)
        x = torch.as_tensor(rng.randn(B, H, H, C).astype(np.float32)).cuda() \
            .to(torch.bfloat16)
        w9 = torch.as_tensor((rng.randn(9, C, C) / math.sqrt(9 * C))
                             .astype(np.float32)).cuda().to(torch.bfloat16)
        x16 = x[:16].contiguous()
        tp16 = {k: v.repeat_interleave(B // G, dim=0)[:16].contiguous()
                for k, v in tg.items()}
        cases = {"B1 fused_sphere_conv_grouped": (
                     B, G, lambda: sk.fused_sphere_conv_grouped(x, tg, w9, G),
                     lambda: sk.fused_sphere_conv_plain(x, tg, w9, G)),
                 "B2 fused_sphere_conv": (
                     16, 16, lambda: sk.fused_sphere_conv(x16, tp16, w9),
                     lambda: sk.fused_sphere_conv_plain(x16, tp16, w9, 16))}
        for name, (b, tables, kern, plain) in cases.items():
            flops = 2.0 * b * H * H * 9 * C * C
            nbytes = 2 * b * H * H * C * 2 + 9 * C * C * 2 + 5 * tables * H * 9 * 4
            r = {"kernel": name, "H": H, "B": b, "dtype": "bf16",
                 "max_abs_err": max_err(kern(), plain())}
            r["ms"] = time_ms(kern)
            r["device_ms"], r["traced_launches"] = device_ms(
                kern, "sphere_conv_bf16")
            r["plain_ms"] = time_ms(plain, 3, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(flops, nbytes,
                                                 H100_BF16_FLOPS)
            r["pct_bound"] = 100 * r["bound_ms"] / r["ms"]
            # a yardstick only (not the same function): cuDNN's dense 3x3
            # conv of the same B, H, C, Cout, so the same FLOPs
            xc = x[:b].permute(0, 3, 1, 2)
            wc = w9.reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous()
            r["dense_conv_ms"] = time_ms(lambda: F.conv2d(xc, wc, padding=1))
            rows.append(show("b1", r))
    return rows


def phase_b3():
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.geometry.sphere_grid import (
        sphere_offset_tables_batch, sphere_patch_grid_batch)
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.ops.kernels import sphere_sample as ss

    B, C = 16, 259
    rng = np.random.RandomState(1)
    grid_of = Generator.from_config(Config()).ss.coord_grid
    rows = []
    for H in SS_SIZES:
        _, _, cp = grid_of.sample_training(
            torch.Generator(device="cuda").manual_seed(H), B)
        tables = {k: v.contiguous()
                  for k, v in sphere_offset_tables_batch(cp, H, H).items()}
        grid = sphere_patch_grid_batch(cp, H, H)
        x = torch.as_tensor(rng.randn(B, H, H, C).astype(np.float32)).cuda()

        def kern():
            return ss.sphere_sample_taps(x, tables)

        def library():
            # the same samples: bilinear grid_sample over the interleaved
            # (3H, 3W) grid, border padding, then the tap-major permute
            y = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear",
                              padding_mode="border", align_corners=True)
            return y.reshape(B, C, H, 3, H, 3).permute(0, 3, 5, 2, 4, 1) \
                .reshape(B, 9, H, H, C)

        # each input element read once, nine written, the tables; three
        # lerps (4 float32 operations each) an output element
        nbytes = 10 * B * H * H * C * 4 + 5 * B * H * 9 * 4
        r = {"kernel": "B3 sphere_sample_taps", "H": H, "B": B, "C": C,
             "dtype": "f32",
             "max_abs_err": max_err(kern(), ss.sphere_sample_taps_plain(
                 x, tables)),
             "library_max_abs_diff": max_err(library(), kern()),
             "row_slots": ss.staging_plan(torch.cuda.current_device(), H, C,
                                          False)[0]}
        r["ms"] = time_ms(kern)
        r["device_ms"], r["traced_launches"] = device_ms(
            kern, "sphere_sample_taps_kernel")
        r["plain_ms"] = time_ms(lambda: ss.sphere_sample_taps_plain(x, tables),
                                3, warmup=1)
        r["library_ms"] = time_ms(library)
        r["bound_ms"], r["bound_by"] = bound(12.0 * 9 * B * H * H * C, nbytes,
                                             H100_F32_FLOPS)
        r["gb_per_s"] = nbytes / r["device_ms"] / 1e6
        r["pct_bound"] = 100 * r["bound_ms"] / r["device_ms"]
        rows.append(show("b3", r))
    return rows


def phase_u1():
    from spgan_tpu_torch.ops.kernels import upfirdn as ku
    from spgan_tpu_torch.ops.upfirdn import make_kernel

    rng = np.random.RandomState(3)
    rows = []
    for what, B, H, W, C, kernel, gain, up, down, pad, dtype in SHAPES:
        k = make_kernel(np.asarray(kernel, np.float32)) * gain
        taps, kh = tuple(k.astype(np.float32).ravel().tolist()), k.shape[0]
        x = torch.as_tensor(rng.randn(B, H, W, C).astype(np.float32)).cuda() \
            .to(dtype)
        w = torch.as_tensor(np.flip(k, (0, 1)).copy()).to(
            device="cuda", dtype=dtype)[None, None].expand(C, 1, kh, kh) \
            .contiguous()

        def kern():
            return ku.upfirdn2d(x, taps, kh, up, down, pad)

        def library():
            # one grouped conv of the same stencil on the NCHW view (up 1,
            # even pads)
            return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad[0],
                            groups=C).permute(0, 2, 3, 1)

        got = kern()
        nbytes = (x.numel() + got.numel()) * x.element_size()
        r = {"kernel": "U1 upfirdn2d", "shape": what,
             "x": list(x.shape), "dtype": str(dtype)[6:],
             "max_abs_err": max_err(got, ku.upfirdn2d_plain(
                 x.float(), taps, kh, up, down, pad))}
        r["ms"] = time_ms(kern)
        r["device_ms"], r["traced_launches"] = device_ms(
            kern, "upfirdn2d_nhwc_kernel")
        r["plain_ms"] = time_ms(
            lambda: ku.upfirdn2d_plain(x, taps, kh, up, down, pad), 5)
        r["library_ms"] = time_ms(library, 5)
        r["bound_ms"], r["bound_by"] = bound(2.0 * kh * kh * got.numel(),
                                             nbytes, H100_F32_FLOPS)
        r["pct_bound"] = 100 * r["bound_ms"] / r["device_ms"]
        rows.append(show("u1", r))
    return rows


def phase_e1():
    from spgan_tpu_torch.ops.kernels import styled_epilogue as ep
    from spgan_tpu_torch.ops.linear import fused_leaky_relu

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for what, B, H, C, dtype in EPILOGUE_SHAPES:
        y = torch.randn((B, H, H, C), generator=gen, device="cuda").to(dtype)
        # demod under 0.75: the kernel runs over its own output, which the
        # gain of sqrt(2) then leaves bounded
        demod = torch.rand((B, C), generator=gen, device="cuda") * 0.7 + 0.05
        bias = torch.randn((C,), generator=gen, device="cuda")
        noise = torch.randn((B, H, H, 1), generator=gen,
                            device="cuda").to(dtype)
        nw = torch.tensor(0.3, device="cuda")
        y0 = y.clone()

        def kern():
            return ep.styled_epilogue(y, demod, bias, noise, nw)

        def composed():
            # StyledConv's passes before the kernel (ops/modulated.py)
            t = y0 * demod.to(dtype)[:, None, None, :]
            t = t + nw.to(dtype) * noise
            return fused_leaky_relu(t, bias)

        got = ep.styled_epilogue(y0.clone(), demod, bias, noise, nw)
        nbytes = (2 * y.numel() + noise.numel()) * y.element_size()
        r = {"kernel": "E1 styled_epilogue", "shape": what,
             "y": list(y.shape), "dtype": str(dtype)[6:],
             "max_abs_err": max_err(got, ep.styled_epilogue_plain(
                 y0, demod, bias, noise, nw))}
        r["ms"] = time_ms(kern)
        r["device_ms"], r["traced_launches"] = device_ms(
            kern, "styled_elementwise_epilogue")
        r["plain_ms"] = time_ms(
            lambda: ep.styled_epilogue_plain(y0, demod, bias, noise, nw), 5)
        r["composed_ms"] = time_ms(composed, 5)
        r["composed_device_ms"] = device_ms_per_call(composed)
        r["bound_ms"], r["bound_by"] = bound(6.0 * y.numel(), nbytes,
                                             H100_F32_FLOPS)
        r["gb_per_s"] = nbytes / r["device_ms"] / 1e6
        r["pct_bound"] = 100 * r["bound_ms"] / r["device_ms"]
        rows.append(show("e1", r))
    return rows


def fir_macs(spec, batch):
    """The filtered LeakyReLU's FIR multiply-adds at one layer: polyphase
    up along W then H (taps / up a sample), down along H then W at the
    kept samples only."""
    side = spec.in_size + spec.conv_kernel - 1
    t_up, kd = spec.up_taps // spec.up_factor, spec.down_taps
    mid = (side * spec.up_factor + spec.padding[0] + spec.padding[1]
           - spec.up_taps + 1)
    out = spec.out_size
    per = (side * mid * t_up + mid * mid * t_up + out * mid * kd
           + out * out * kd)
    return float(per * spec.out_channels * batch)


def phase_f1():
    from spgan_tpu_torch.config import StyleGAN3Params
    from spgan_tpu_torch.models import stylegan3 as sg3
    from spgan_tpu_torch.ops import filtered_lrelu as fl

    B = 16
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for spec in sg3.schedule(StyleGAN3Params())[1][9:14]:
        layer = sg3.SynthesisLayer.build(spec, 512, 256.0)
        side = spec.in_size + spec.conv_kernel - 1
        x = torch.randn((B, side, side, spec.out_channels), generator=gen,
                        device="cuda").to(torch.float16)
        scale = torch.rand((B, spec.out_channels), generator=gen,
                           device="cuda") + 0.5
        b = torch.randn((spec.out_channels,), generator=gen, device="cuda")
        kw = dict(fu=layer.up_filter, fd=layer.down_filter, b=b,
                  up=spec.up_factor, down=spec.down_factor,
                  padding=spec.padding, clamp=256.0)

        def kern():
            return fl.filtered_lrelu(x, scale=scale, **kw)

        def plain():
            return fl.filtered_lrelu_plain(x, scale=scale, **kw)

        # flops_sg3.py's rule: the conv output read once, the output
        # written once, at the layer's dtype
        nbytes = (side * side + spec.out_size ** 2) * spec.out_channels \
            * 2 * B
        macs = fir_macs(spec, B)
        r = {"kernel": "F1 filtered_lrelu", "layer": spec.name,
             "x": list(x.shape), "dtype": "float16", "up": spec.up_factor,
             "max_abs_err": max_err(kern()[:1], fl.filtered_lrelu_plain(
                 x[:1].float(), scale=scale[:1], **kw))}
        r["ms"] = time_ms(kern)
        r["device_ms"], r["traced_launches"] = device_ms(
            kern, "filtered_lrelu_kernel")
        r["plain_ms"] = time_ms(plain, 3, warmup=1)
        r["byte_bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
        r["fma_bound_ms"] = 2 * macs / H100_F32_FLOPS * 1e3
        r["gmac"] = macs / 1e9
        r["bound_ms"], r["bound_by"] = bound(2 * macs, nbytes,
                                             H100_F32_FLOPS)
        r["pct_bound"] = 100 * r["bound_ms"] / r["device_ms"]
        r["pct_byte_bound"] = 100 * r["byte_bound_ms"] / r["device_ms"]
        rows.append(show("f1", r))
    return rows


PHASES = {"build": phase_build, "b1": phase_b1, "b3": phase_b3,
          "u1": phase_u1, "e1": phase_e1, "f1": phase_f1}


def main(argv):
    unknown = [a for a in argv if a not in PHASES]
    if unknown:
        print(f"unknown part {unknown}; choose from {list(PHASES)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    # float32 means float32 (the plain versions and the library calls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    print(f"[env] {json.dumps(out)}")
    for name in argv or list(PHASES):
        out[name] = PHASES[name]()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
