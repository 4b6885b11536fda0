"""Offline panorama rendering on several ranks, one process a card, through
the program's lattice-sharded engine (PanoramaEngine.make_sharded_generate):
each rank renders its whole chunks of the lattice, the patches are
all-gathered and every rank scatters the same meta image; rank 0 crops
it, copies the crop to the host and quantises it (`to_uint8`), as the
infer CLI's `--engine sharded` does.  One image is one of rank 0's
finished uint8 crops.  Rank 0's host path of a batch runs behind the
next batch's render, as an offline renderer's does: the crop's copy is
queued on the card's stream into pinned memory, and `to_uint8` runs in
slices of the batch on worker threads once it has landed.  Run one
after the other, that host path took half of each batch, so the rate
swung with the host's speed from run to run (13% between the
quartiles on four H100s).

This process is no rank: it builds the kernels and calibrates the ToRGB
scale (on the first card), then starts `traffic["ranks"]` processes of
this module, joined by torch.distributed (NCCL on cuda:<rank>, gloo on
the CPU), waits for them and checks rank 0's sample against the plain
reference.  Every rank draws the batch's fields from the batch's seed, as
the CLI's ranks do.  The window opens behind a barrier; after each batch
rank 0 tells the others whether the window has closed.  Each rank keeps
to its own share of the host's cores, those of its card's NUMA node
where the host says which they are (`pin`), as a deployment binds one
process a card: unbound, where the scheduler put rank 0 (its host copy
and `to_uint8` are half of a batch) moved images_per_s by 15% from run
to run.  peak_mem_gib is
the largest rank's; the traced stretch, its breakdown and the records
are rank 0's, with the program's tracer on there
(`portbench.spans.with_spans`).  A rank that fails, or a world that
outlives its deadline, fails the run with the rank's output.

    python3 -m portbench.loops.render_sharded <job.json> <rank>

is one rank (started by `run`; the job file holds the cell's
configuration, traffic, seed, window, scale, device and the address).
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from portbench import build, harness, peaks, spans, trace
from portbench.loops import render
from portbench.reference import render as ref_render

# a world's set-up (imports, process group, weights, warm-up) and its
# reference-free tail, on top of the window and the traced stretch
DEADLINE_S = 600.0
GROUP_TIMEOUT_S = 300.0
# rank 0 quantises a batch in this many slices at once, on worker
# threads, while the next batch renders
QUANT_THREADS = 4
# the launcher's variables, which would make a rank join another world
_WORLD_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "LOCAL_WORLD_SIZE", "GROUP_RANK")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def gathered(ctx: harness.Context, scale: float, threads: int = 0):
    """Run the world: (rank 0's result dict, rank 0's sample {batch index:
    uint8 crops}).  threads: torch's threads a rank (0: its default)."""
    n = ctx.traffic["ranks"]
    tmp = Path(tempfile.mkdtemp(prefix="portbench-sharded-"))
    job = {"config": ctx.config, "traffic": ctx.traffic, "seed": ctx.seed,
           "seconds": ctx.seconds, "trace": ctx.trace, "scale": scale,
           "device": ctx.device, "world": n, "threads": threads,
           "coordinator": f"localhost:{_free_port()}", "out": str(tmp)}
    (tmp / "job.json").write_text(json.dumps(job))
    env = {k: v for k, v in os.environ.items() if k not in _WORLD_ENV}
    procs, logs = [], []
    for r in range(n):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(tmp / f"rank{r}.log")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.loops.render_sharded",
             str(tmp / "job.json"), str(r)],
            cwd=harness.REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    allowed = DEADLINE_S + 2 * ctx.seconds
    deadline = time.monotonic() + allowed
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {codes[bad[0]]}"
            elif time.monotonic() > deadline:
                failed = f"the world outlived its {allowed:.0f} s"
            if failed is not None or None not in codes:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    try:
        for r, path in enumerate(logs):
            for line in path.read_text(errors="replace").splitlines()[-40:]:
                harness.log(f"[rank {r}] {line}")
        if failed is not None:
            raise RuntimeError(f"the sharded world failed: {failed}")
        result = json.loads((tmp / "rank0.json").read_text())
        with np.load(tmp / "rank0.npz") as f:
            got = {int(k): f[k] for k in f.files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result, got


def run(ctx: harness.Context) -> harness.Outcome:
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
    ctx.setup.mark("imports and CUDA context")
    if cuda:
        render.prebuild_kernels()
    ctx.setup.mark("kernel build")
    scale = ref_render.calibrate(ctx.config, ctx.seed, dev)
    if cuda:
        torch.cuda.empty_cache()
    ctx.setup.mark("the reference's ToRGB calibration", counted=False)
    # on the CPU the ranks share the host's cores
    threads = 0 if cuda else max(1, torch.get_num_threads()
                                 // ctx.traffic["ranks"])
    result, got = gathered(ctx, scale, threads)
    # rank 0 stamped the window's opening on the Unix clock
    opened = result["window_open_unix"] - (time.time() - time.perf_counter())
    e2e = dict(result["end_to_end"],
               setup_s=opened - ctx.setup.t0 - ctx.setup.uncounted)
    ctx.setup.mark("the ranks' run")
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    tr = ctx.traffic
    sample = {k: result["sample"][str(k)] for k in got}
    want = ref_render.render_sample(ctx.config, tr, ctx.seed, scale, sample,
                                   dev)
    harness.log(f"[reference] {sum(len(v) for v in sample.values())} images "
                f"in {time.perf_counter() - t_ref:.3f} s")
    checks = ref_render.checks(got, want, ctx.limits)
    return harness.Outcome(end_to_end=e2e, records=result["records"],
                           attempted=result["images"], failed=0,
                           checks=checks, device=result["device"],
                           breakdown=result["breakdown"])


# ------------------------------------------------------------------ a rank

def _max_over_ranks(v: float, mesh) -> float:
    import torch.distributed as dist
    t = torch.tensor([float(v)], dtype=torch.float64,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _cpu_list(text: str) -> list:
    """"0-3,8,10-11" -> [0, 1, 2, 3, 8, 10, 11]."""
    out = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out += range(int(lo), int(hi or lo) + 1)
    return out


def _card_nodes(world: int) -> list:
    """The NUMA node of each card 0..world-1 (from nvidia-smi's PCI bus ids
    and /sys), or None where the host does not say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return [None] * world
    nodes = []
    for bus in out.split()[:world]:
        # 00000000:18:00.0 -> 0000:18:00.0
        path = Path("/sys/bus/pci/devices") / bus.lower()[-12:] / "numa_node"
        try:
            node = int(path.read_text())
        except (OSError, ValueError):
            node = -1
        nodes.append(node if node >= 0 else None)
    return nodes + [None] * (world - len(nodes))


def pin(rank: int, world: int, nodes: list) -> list:
    """Bind this process to its share of the cores it may use: those of
    its card's node (`nodes`, one a card, None where unknown), split in
    equal blocks among the ranks on that node; with no node known, the
    cores split among all ranks.  Returns the cores."""
    allowed = sorted(os.sched_getaffinity(0))
    node = nodes[rank] if rank < len(nodes) else None
    pool = allowed
    peers = list(range(world))
    if node is not None:
        try:
            local = _cpu_list(Path(
                f"/sys/devices/system/node/node{node}/cpulist").read_text())
        except OSError:
            local = []
        local = [c for c in local if c in set(allowed)]
        if local:
            pool = local
            peers = [r for r in range(world) if nodes[r] == node]
    k = len(pool) // len(peers)
    i = peers.index(rank)
    cpus = pool[i * k:(i + 1) * k] if k else pool
    os.sched_setaffinity(0, cpus)
    return cpus


def _exit_with_parent() -> None:
    """End this rank when the process that started it ends (a parent
    killed at its time limit leaves no rank holding a card)."""
    import threading

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def rank_main(job: dict, rank: int) -> int:
    t_start = time.time()
    _exit_with_parent()
    if job["device"] != "cpu":
        cpus = pin(rank, job["world"], _card_nodes(job["world"]))
        print(f"[pin] rank {rank}: cores {cpus[0]}-{cpus[-1]} "
              f"({len(cpus)})", flush=True)
    if job["threads"]:
        torch.set_num_threads(job["threads"])
    from spgan_tpu_torch.parallel.mesh import close, init_distributed

    mesh = init_distributed(job["coordinator"], job["world"], rank,
                            device=job["device"], timeout_s=GROUP_TIMEOUT_S)
    try:
        return _rank(job, mesh, t_start)
    finally:
        close(mesh)


def _rank(job: dict, mesh, t_start: float) -> int:
    from spgan_tpu_torch.parallel.mesh import barrier, broadcast_int

    (Config, PanoramaEngine, to_uint8, close_plan, planar_plan,
     gen_mod) = render._program(None)
    dev = mesh.device
    cuda = dev.type == "cuda"
    root = mesh.is_root
    cfg_json, tr, seed = job["config"], job["traffic"], job["seed"]
    cfg = build.make_config(Config, cfg_json, tr["task"])
    tp = cfg.train_params
    if tp.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    phases = {"imports and process group": time.time() - t_start}
    t = time.time()
    g = build.make_generator(gen_mod, cfg, cfg_json)
    params = build.generator_params(cfg_json, seed, dev, job["scale"])
    close_loop = tr["lattice"]["close_loop"]
    plan = (close_plan if close_loop else planar_plan)(
        g, cfg.task.height, cfg.task.width)
    engine = PanoramaEngine(
        g=g, plan=plan, batch=cfg.task.batch_size,
        patch_chunk=cfg.task.patch_chunk, grid_partial=tp.partial,
        compute_dtype=tp.compute_dtype,
        dedup_wrap=tr["lattice"]["dedup_wrap"], device=dev)
    fn = engine.make_sharded_generate(mesh)
    B = cfg.task.batch_size
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    phases["weights and engine tables"] = time.time() - t

    pool = ThreadPoolExecutor(QUANT_THREADS) if root else None
    slices = [slice(int(ix[0]), int(ix[-1]) + 1) for ix in
              np.array_split(np.arange(B), QUANT_THREADS) if len(ix)]

    def host_path(meta, spans_on):
        """Start rank 0's host path of one batch: the crop's copy to the
        host, queued behind the render, then `to_uint8` in slices on the
        pool once the copy has landed.  Returns a function that waits for
        the batch's uint8 crops."""
        with torch.inference_mode():
            crop = engine.crop_to_target(meta)
            if cuda:
                host = torch.empty(crop.shape, dtype=crop.dtype,
                                   pin_memory=True)
                host.copy_(crop, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(dev))
            else:
                host, copied = crop, None
        arr = host.numpy()

        def part(sl):
            if copied is not None:
                copied.synchronize()
            if not spans_on:
                return to_uint8(arr[sl])
            with trace.span("to_uint8"):
                return to_uint8(arr[sl])

        parts = [pool.submit(part, sl) for sl in slices]
        return lambda: np.concatenate([f.result() for f in parts])

    def run_batches(gen_of, stop, spans_on=False):
        """Render batch k from the fields of gen_of(k) until stop(k + 1)
        holds, each batch's host path behind the next batch's render;
        rank 0's uint8 batches ([] on the others)."""
        done, pending, k = [], None, 0
        while True:
            fields = engine.sample_fields(gen_of(k))
            if spans_on:
                with trace.span("generate"):
                    meta = fn(params, *fields)
            else:
                meta = fn(params, *fields)
            if root:
                if spans_on:
                    with trace.span("crop_host_copy"):
                        started = host_path(meta, True)
                else:
                    started = host_path(meta, False)
                if pending is not None:
                    done.append(pending())
                pending = started
            k += 1
            if stop(k):
                break
        if pending is not None:
            done.append(pending())
        return done

    t = time.time()
    run_batches(lambda k: build.generator(seed, build.TAG_WARM, device=dev),
                lambda k: k >= 1)
    sync()
    phases["warm-up"] = time.time() - t
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    barrier(mesh)
    opened = time.time()
    t0 = time.perf_counter()
    outputs = run_batches(
        lambda k: build.generator(seed, build.TAG_BATCH, k, device=dev),
        lambda k: bool(broadcast_int(
            int(root and time.perf_counter() - t0 >= job["seconds"]),
            mesh)))
    sync()
    window_s = time.perf_counter() - t0
    n_batches = len(outputs)
    window_peak = _max_over_ranks(
        torch.cuda.max_memory_allocated(dev) if cuda else 0, mesh)
    setup_peak = _max_over_ranks(setup_peak, mesh)

    records = {"untraced_images": n_batches * B, "untraced_s": window_s,
               "images_per_unit": B,
               "peak_flops": peaks.PEAK_FLOPS[tp.compute_dtype],
               "power_limit_w": peaks.power_limit_w() if cuda and root
               else None}
    breakdown = None
    if job["trace"]:
        n = tr["traced_units"]

        def traced():
            run_batches(lambda k: build.generator(seed, build.TAG_WARM, 1 + k,
                                                  device=dev),
                        lambda k: k >= n, spans_on=True)

        if root:
            joined: dict = {}
            breakdown = spans.with_spans(trace.profile, joined)(
                traced, records, sync)
            records["traced_images"] = n * B
            if "table" in joined:
                records["spans"] = joined["table"]
                records["counters"] = joined["counters"]
        else:
            traced()
            sync()
    if pool is not None:
        pool.shutdown()
    traced_peak = _max_over_ranks(
        torch.cuda.max_memory_allocated(dev) if cuda else 0, mesh)
    barrier(mesh)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", flush=True)
        return 3
    if not root:
        return 0

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": mesh.world_size,
              "memory_peak_bytes": int(max(setup_peak, window_peak,
                                           traced_peak))}
    if job["trace"]:
        device["busy_s"] = records["busy_s"]
        device["window_s"] = records["wall_s"]
    sample = render.sample_images(seed, n_batches, B, tr["check_images"])
    out_dir = Path(job["out"])
    np.savez(out_dir / "rank0.npz",
             **{str(k): outputs[k][bs] for k, bs in sample.items()})
    for k, v in phases.items():
        print(f"[setup] {k}: {v:.3f} s", flush=True)
    print(f"[window] {n_batches} batches, {n_batches * B} images in "
          f"{window_s:.3f} s on {mesh.world_size} ranks", flush=True)
    (out_dir / "rank0.json").write_text(json.dumps({
        "end_to_end": {"images_per_s": n_batches * B / window_s,
                       "peak_mem_gib": window_peak / 2 ** 30},
        "window_open_unix": opened, "images": n_batches * B,
        "records": records, "device": device, "breakdown": breakdown,
        "sample": {str(k): bs for k, bs in sample.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(json.loads(Path(sys.argv[1]).read_text()),
                       int(sys.argv[2])))
