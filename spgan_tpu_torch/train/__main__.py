"""Training CLI of the port (counterpart of the repo's train.py):

    python -m spgan_tpu_torch.train configs/model/spgan_run5k.yaml \\
        [--debug] [--seed N] [--max-iters N] [--baseline-ckpt PATH] \\
        [--profile-dir DIR --profile-start I --profile-iters N] \\
        [--coordinator HOST:PORT --num-processes N --process-id I] \\
        [--device cuda|cpu]

Trains the model of the yaml on its data source (data_params), writing
<log_dir>/<exp_name>/{ckpt,tb,codes}, and resumes from the newest
checkpoint there.  --baseline-ckpt starts the generator from an
InfinityGAN baseline checkpoint (with train_params.freeze its loaded
weights and the whole discriminator stay fixed).  --debug runs one
iteration at batch <= 8 and writes nothing.  Runs on cuda unless
--device cpu.

Data-parallel training, one process per card: --coordinator,
--num-processes and --process-id (train.py's flags) start the world
(NCCL on cuda:<local rank>, gloo with --device cpu), or, without them,
torchrun's environment does:

    torchrun --nproc-per-node 4 -m spgan_tpu_torch.train <yaml>

batch_size is the global batch; only rank 0 writes.  Export the EMA
generator of a run with spgan_tpu_torch.compat.load.save_params_npz, or
pass its ckpt directory to python -m spgan_tpu_torch.infer --ckpt.
"""
import argparse
import os

from spgan_tpu_torch.config import load_config
from spgan_tpu_torch.parallel.mesh import close, init_distributed
from spgan_tpu_torch.train.loop import train


def main(argv=None):
    """Run the CLI; returns the final TrainState."""
    ap = argparse.ArgumentParser(prog="python -m spgan_tpu_torch.train")
    ap.add_argument("config", help="model yaml (reference spgan.yaml layout)")
    ap.add_argument("--debug", action="store_true",
                    help="one iteration at batch <= 8, nothing written")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--baseline-ckpt", default=None,
                    help="transfer-learn from an InfinityGAN baseline "
                         "checkpoint (torch; its g_ema or g entry)")
    ap.add_argument("--coordinator", default=None,
                    help="data-parallel world: rank 0's host:port")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="data-parallel world size (one process per card)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the "
                         "profiled iterations, with the step's spgan.* "
                         "spans, here")
    ap.add_argument("--profile-start", type=int, default=3,
                    help="first traced iteration, counted from the loop's "
                         "start (default 3: after the warm-up)")
    ap.add_argument("--profile-iters", type=int, default=5,
                    help="number of iterations in the trace window")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.baseline_ckpt is not None and \
            not os.path.isfile(args.baseline_ckpt):
        raise FileNotFoundError(f"--baseline-ckpt {args.baseline_ckpt}: "
                                "no such file")
    cfg = load_config(args.config)
    if args.debug:
        cfg.train_params.batch_size = min(cfg.train_params.batch_size, 8)
    mesh = init_distributed(args.coordinator, args.num_processes,
                            args.process_id, device=args.device)
    try:
        return train(cfg, debug=args.debug, seed=args.seed,
                     max_iters=args.max_iters, device=mesh.device,
                     baseline_ckpt=args.baseline_ckpt,
                     profile_dir=args.profile_dir,
                     profile_start=args.profile_start,
                     profile_iters=args.profile_iters, mesh=mesh)
    finally:
        close(mesh)


if __name__ == "__main__":
    main()
