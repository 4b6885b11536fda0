"""python -m spgan_tpu_torch.train [--debug] [--max-iters N] [--seed S]
[--device cuda|cpu]: train the shipped model (Config() defaults, the
reference's configs/model/spgan.yaml) on the synthetic source."""
import argparse

from spgan_tpu_torch.config import Config
from spgan_tpu_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m spgan_tpu_torch.train")
    ap.add_argument("--debug", action="store_true",
                    help="one iteration, then print its metrics")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain versions")
    ap.add_argument("--log-every", type=int, default=100)
    args = ap.parse_args(argv)
    train(Config(), max_iters=args.max_iters, seed=args.seed,
          device=args.device, debug=args.debug, log_every=args.log_every)


if __name__ == "__main__":
    main()
