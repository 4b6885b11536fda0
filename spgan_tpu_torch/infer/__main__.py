"""Inference CLI of the port (counterpart of the repo's test.py, flag for
flag):

    python -m spgan_tpu_torch.infer --model-config configs/model/spgan.yaml \\
        --test-config configs/test/spgan_384x768.yaml \\
        [--ckpt SP-GAN.ckpt | params.npz] [--random-init] [--speed-benchmark] \\
        [--calc-flops] [--num-gen N] [--seed S] [--save-root DIR] \\
        [--exp-suffix S] [--override-save-idx I] [--inter-ckpt PATH] \\
        [--dump-vars] [--save_all_space] [--inv-records A:B \\
        --inv-placements x,y] [--profile-dir DIR] [--clear-fid-cache] \\
        [--interactive] [--debug] [--engine folded|sharded|halo] \\
        [--device cuda|cpu]

StyleGAN3-T at 1024x1024 (models/stylegan3.py, whole images through
ImageGenerationManager):

    python -m spgan_tpu_torch.infer \\
        --model-config configs/model/stylegan3_t_ffhq1024.yaml \\
        --test-config configs/test/stylegan3_1024.yaml

with random weights from the seed (--ckpt reads SP-GAN checkpoints).

Runs on cuda unless --device cpu.  Without --ckpt (or with --random-init)
the generator has random weights from the seed.  --ckpt takes an .npz
export (either package's save_params_npz), a reference PyTorch checkpoint,
or the checkpoint directory (or one checkpoint file) of a training run of
the port (python -m spgan_tpu_torch.train); not an Orbax directory.
--interactive (or task.interactive) runs the editing REPL
(infer/interactive.py) on stdin instead of the batches; batch_size 1.

--engine sharded (the lattice split over the ranks) and halo (close-loop
fields split by width, for panoramas wider than one card holds) run one
process per card under torchrun, and in a world of one without it:

    torchrun --nproc-per-node 4 -m spgan_tpu_torch.infer ... --engine halo

Every rank renders with the same seed; only rank 0 writes.
"""
import argparse
import glob
import os
import shutil
import socket

import torch

from spgan_tpu_torch.compat.load import load_generator_params
from spgan_tpu_torch.config import load_config
from spgan_tpu_torch.infer.interactive import run_interactive
from spgan_tpu_torch.infer.managers import save_image_batch
from spgan_tpu_torch.infer.testing_vars import TestingVars, load_record
from spgan_tpu_torch.parallel.mesh import close, init_distributed
from spgan_tpu_torch.utils import trace
from spgan_tpu_torch.utils.flops import generator_flops, pretty
from spgan_tpu_torch.utils.misc import import_func, manually_seed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m spgan_tpu_torch.infer")
    ap.add_argument("--model-config", required=True)
    ap.add_argument("--test-config", required=True)
    ap.add_argument("--ckpt", default=None,
                    help=".npz params export, a reference PyTorch "
                         ".ckpt/.pth/.pth.tar with a g_ema entry, or a "
                         "port training run's checkpoint directory")
    ap.add_argument("--random-init", action="store_true",
                    help="skip checkpoint loading, use seeded random weights")
    ap.add_argument("--exp-suffix", default=None,
                    help="suffix appended to the save directory name")
    ap.add_argument("--override-save-idx", type=int, default=None,
                    help="start the saved-image global id here "
                         "(task.init_index)")
    ap.add_argument("--speed-benchmark", action="store_true",
                    help="time each batch (no images written) and append "
                         "sec/image to logs-quant/benchmark_results/")
    ap.add_argument("--calc-flops", action="store_true")
    ap.add_argument("--num-gen", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--save-root", default=None)
    ap.add_argument("--inv-records", default=None,
                    help="colon-separated inversion record files (.npz of "
                         "the JAX package's invert_patch) pasted into the "
                         "latent fields")
    ap.add_argument("--inv-placements", default=None,
                    help="comma-separated horizontal centres in [0,1], one "
                         "per record (default 0.5)")
    ap.add_argument("--inter-ckpt", default=None, metavar="PATH",
                    help="render from saved TestingVars (.npz file, or a "
                         "directory of them, one per batch)")
    ap.add_argument("--dump-vars", action="store_true",
                    help="save each batch's TestingVars (.npz) next to its "
                         "images")
    ap.add_argument("--save_all_space", action="store_true",
                    help="also save the uncropped meta image as <id>full.png")
    ap.add_argument("--clear-fid-cache", action="store_true",
                    help="remove the cached FID statistics (.fid-cache/)")
    ap.add_argument("--engine", default=None,
                    choices=["folded", "sharded", "halo"],
                    help="override task.engine: folded (one card), "
                         "sharded or halo (one process per card under "
                         "torchrun, or a world of one)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of one batch "
                         "(the second when more than one runs), with the "
                         "engine's spgan.* spans, here")
    ap.add_argument("--interactive", action="store_true",
                    help="the editing REPL on stdin (infer/interactive.py; "
                         "batch_size 1)")
    ap.add_argument("--debug", action="store_true",
                    help="one image, one batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _inv_records(args):
    records = [load_record(p) for p in args.inv_records.split(":")]
    if args.inv_placements:
        placements = [float(v) for v in args.inv_placements.split(",")]
    else:
        placements = [0.5] * len(records)
    return records, placements


def main(argv=None):
    """Run the CLI; returns the manager (None with --calc-flops)."""
    args = parse_args(argv)
    mesh = init_distributed(device=args.device)  # torchrun's world, or one
    try:
        return _run(args, mesh)
    finally:
        close(mesh)


def _run(args, mesh):
    dev = mesh.device
    cfg = load_config(args.model_config, args.test_config)
    if args.interactive:
        cfg.task.interactive = True
    if cfg.task.interactive and cfg.task.batch_size != 1:
        raise ValueError("interactive editing expects task.batch_size 1, "
                         f"got {cfg.task.batch_size}")
    if cfg.task.interactive and mesh.world_size > 1:
        raise ValueError("interactive editing runs in one process, not in "
                         f"a world of {mesh.world_size}")
    if args.num_gen is not None:
        cfg.task.num_gen = args.num_gen
    if args.override_save_idx is not None:
        cfg.task.init_index = args.override_save_idx
    if args.engine is not None:
        cfg.task.engine = args.engine
    if cfg.train_params.compute_dtype == "float32":
        # float32 means float32: no TF32 in cuDNN convolutions or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    seed = args.seed if args.seed is not None else cfg.task.seed
    manually_seed(seed)

    if args.clear_fid_cache and os.path.isdir(".fid-cache"):
        shutil.rmtree(".fid-cache")
        print(" [*] Cleared .fid-cache/")

    g = import_func(cfg.train_params.g_arch).from_config(cfg)
    if args.ckpt is None or args.random_init:
        params_ema = g.init(torch.Generator().manual_seed(seed), device=dev)
        print(" [!] Using randomly initialized weights"
              + (" (--random-init)" if args.random_init else " (no --ckpt)"))
    elif not hasattr(g, "ts"):
        raise ValueError("--ckpt reads SP-GAN checkpoints; StyleGAN3 "
                         "renders random weights from the seed")
    else:
        params_ema = load_generator_params(args.ckpt, g, device=dev)

    if args.calc_flops and not hasattr(g, "ts"):
        raise ValueError("--calc-flops counts SP-GAN's patch generator")
    if args.calc_flops:
        fl = generator_flops(g)
        n_patches = 60  # 384x768 close-loop lattice
        print(" [*] FLOPs per patch: all {} (SS {}, TS {})".format(
            pretty(fl["flops_all"]), pretty(fl["flops_ss"]),
            pretty(fl["flops_ts"])))
        print(" [*] FLOPs per 384x768 pano ({} patches): {}".format(
            n_patches, pretty(fl["flops_all"] * n_patches)))
        return None

    test_name = os.path.splitext(os.path.basename(args.test_config))[0]
    if args.exp_suffix:
        test_name = f"{test_name}_{args.exp_suffix}"
    save_root = args.save_root or os.path.join(
        cfg.log_dir, cfg.exp_name, "test", test_name)

    manager = import_func(cfg.task.task_manager)(
        g=g, params_ema=params_ema, config=cfg, save_root=save_root,
        device=dev, mesh=mesh)
    manager.task_specific_init(seed=seed)

    if cfg.task.interactive:
        n = run_interactive(manager, save_root)
        print(f" [*] interactive session done: {n} image(s) in {save_root}")
        return manager

    batch = cfg.task.batch_size
    num_gen = 1 if args.debug else cfg.task.num_gen
    n_batches = max(1, (num_gen + batch - 1) // batch)
    key = torch.Generator(device=dev).manual_seed(seed)

    inv_records = placements = None
    if args.inv_records:
        inv_records, placements = _inv_records(args)

    # --inter-ckpt: a file applies to every batch; a directory is a sorted
    # list consumed one file per batch
    inter_ckpt_paths = None
    if args.inter_ckpt:
        if os.path.isfile(args.inter_ckpt):
            print(" [!] A single inter ckpt is loaded for all samples!")
            inter_ckpt_paths = [args.inter_ckpt] * n_batches
        else:
            inter_ckpt_paths = sorted(
                glob.glob(os.path.join(args.inter_ckpt, "*.npz")))
            if not inter_ckpt_paths:
                raise FileNotFoundError(
                    f"no .npz TestingVars found under {args.inter_ckpt}")
            n_batches = min(n_batches, len(inter_ckpt_paths))

    root = mesh.is_root

    def save_cropped(meta):
        cropped = manager.engine.crop_to_target(meta)
        if root:
            save_image_batch(cropped, save_root, manager.cur_global_id)
        manager.cur_global_id += cropped.shape[0]

    profile_batch = None
    if args.profile_dir is not None and root:
        profile_batch = 1 if n_batches > 1 else 0
    prof = None
    try:
        for i in range(n_batches):
            if i == profile_batch:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
                trace.enable()
            # batch i draws from `key`, or, with task.seeds, from a
            # generator seeded with i (reproducible alone)
            k = (torch.Generator(device=dev).manual_seed(i)
                 if cfg.task.seeds else key)
            if inter_ckpt_paths is not None:
                tv = TestingVars.load(inter_ckpt_paths[i])
                save_cropped(manager.generate_with_vars(tv))
            elif inv_records is not None:
                tv = manager.create_vars(k)
                tv.replace_by_records(manager.engine.plan, inv_records,
                                      placements)
                save_cropped(manager.generate_with_vars(tv))
            elif args.dump_vars:
                tv = manager.create_vars(k)
                meta = manager.generate_with_vars(tv)
                if root:
                    os.makedirs(save_root, exist_ok=True)
                    tv.save(os.path.join(
                        save_root, f"{manager.cur_global_id:06d}_vars.npz"))
                save_cropped(meta)
            else:
                manager.run_next(k, save=not args.speed_benchmark,
                                 write_gpu_time=args.speed_benchmark)
            if args.save_all_space and not args.speed_benchmark:
                manager.save_full_imgs()
            if i == profile_batch:
                # every branch above copied the meta image to the host, so
                # the batch's device work is inside the window
                trace.disable()
                prof.__exit__(None, None, None)
                os.makedirs(args.profile_dir, exist_ok=True)
                path = os.path.join(args.profile_dir, "infer_trace.json")
                prof.export_chrome_trace(path)
                prof = None
                print(f" [*] Profiler trace written to {path}")
            if args.debug:
                break
    finally:
        if prof is not None:
            # the traced batch raised: close the profiler all the same
            trace.disable()
            prof.__exit__(None, None, None)

    if args.speed_benchmark and root:
        mean, std = manager.get_exec_time_stats()
        per_img = mean / batch
        out_dir = os.path.join("logs-quant", "benchmark_results")
        os.makedirs(out_dir, exist_ok=True)
        line = (f"{cfg.exp_name}: {per_img:.6f} +/- {std / batch:.6f} "
                f"sec/image (batch {batch}, {len(manager.accum_exec_times)}"
                f" calls)")
        with open(os.path.join(out_dir,
                               f"benchmark-{socket.gethostname()}.txt"),
                  "a") as f:
            f.write(line + "\n")
        print(" [*] " + line)

    manager.exit()
    return manager


if __name__ == "__main__":
    main()
