"""Offline eval CLI of the port (counterpart of tools/eval_metrics.py,
flag for flag): FID, Inception Score and LPIPS over image sets, the
networks on the card.

    # Frechet Inception Distance between two image sets
    python -m spgan_tpu_torch.evalkit fid SET_A SET_B \\
        [--inception pt_inception-2015-12-05.pth] [--n 10000] [--batch 50]

    # Inception Score of one set (the fc head's logits)
    python -m spgan_tpu_torch.evalkit is SET [--splits 10] [--inception ...]

    # mean pairwise LPIPS between aligned sets (same count, same size)
    python -m spgan_tpu_torch.evalkit lpips SET_A SET_B \\
        --alex alexnet.pth --lin lpips_v0.1_alex.pth

    # inception statistics once, as a {mu, sigma, n} pickle; fid takes the
    # .pkl in place of either set
    python -m spgan_tpu_torch.evalkit stats SET --out real_stats.pkl
    python -m spgan_tpu_torch.evalkit fid real_stats.pkl GEN_SET

SET = a folder of images | an .spr record file | an (N, H, W, 3) uint8
.npy.  A folder's PNGs decode in-tree (utils/png.py); JPEG and WebP need
PIL.  Inception weights come from --inception or $SPGAN_TPU_INCEPTION
(the pytorch-fid checkpoint training-time FID reads).
--allow-random-weights substitutes seeded random networks so the
plumbing runs where the weight files are absent: the NUMBERS ARE
MEANINGLESS, and the output says so.  Runs on cuda unless --device cpu.

Output: one JSON line per invocation.
"""
import argparse
import json
import os
from glob import glob

import numpy as np


def _load_set(path: str, n=None) -> np.ndarray:
    """(N, H, W, 3) uint8, kept integer until batch time (a float32 copy
    of a 10,000-image set would be tens of GB)."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        arr = np.asarray(arr[:n] if n else arr)
    elif path.endswith(".spr"):
        from spgan_tpu_torch.data.native_loader import read_records

        arr = np.asarray(read_records(path))
        if n:
            arr = arr[:n]
    elif os.path.isdir(path):
        from spgan_tpu_torch.utils.png import decode_image

        paths = sorted(p for p in glob(os.path.join(path, "*"))
                       if p.lower().endswith((".png", ".jpg", ".jpeg",
                                              ".webp")))
        if not paths:
            raise SystemExit(f"no images in {path}")
        if n:
            paths = paths[:n]

        def read(p):
            with open(p, "rb") as f:
                return decode_image(f.read())

        arr = np.stack([read(p) for p in paths])
    else:
        raise SystemExit(f"unsupported image set {path!r} "
                         "(folder | .spr | .npy)")
    if arr.dtype != np.uint8:
        raise SystemExit(f"{path}: expected uint8 images (0..255), got "
                         f"{arr.dtype}")
    return arr


def _norm(b: np.ndarray) -> np.ndarray:
    return b.astype(np.float32) / 127.5 - 1.0


def _batches(arr: np.ndarray, batch: int):
    for i in range(0, arr.shape[0], batch):
        yield _norm(arr[i:i + batch])


def _inception(args, with_logits=False):
    """(network, real weights?) from --inception / $SPGAN_TPU_INCEPTION,
    or random with --allow-random-weights; else SystemExit naming the
    flags."""
    from spgan_tpu_torch.evalkit.inception import (load_torch_inception,
                                                   random_inception)

    path = args.inception or os.environ.get("SPGAN_TPU_INCEPTION")
    if path and os.path.exists(path):
        return load_torch_inception(path, with_logits=with_logits,
                                    device=args.device), True
    if not args.allow_random_weights:
        raise SystemExit(
            "no inception weights: pass --inception or set "
            "$SPGAN_TPU_INCEPTION to a pytorch-fid checkpoint "
            "(pt_inception-2015-12-05-*.pth), or pass "
            "--allow-random-weights for a meaningless smoke run")
    return random_inception(with_logits=with_logits,
                            device=args.device), False


def _set_stats(path, args, ev_box):
    """FIDStats of `path`: loaded when it is a .pkl, else from its
    images.  ev_box holds the evaluator, built (and the weights required)
    only when a side is an image set."""
    from spgan_tpu_torch.evalkit.fid import FIDEvaluator, FIDStats

    if path.endswith(".pkl"):
        return FIDStats.load(path), True
    if ev_box[0] is None:
        model, real_w = _inception(args)
        ev_box[0] = (FIDEvaluator(model, device=args.device), real_w)
    ev, real_w = ev_box[0]
    return ev.stats_from_batches(
        _batches(_load_set(path, args.n), args.batch)), real_w


def cmd_fid(args):
    from spgan_tpu_torch.evalkit.fid import frechet_distance

    ev_box = [None]
    sa, wa = _set_stats(args.set_a, args, ev_box)
    sb, wb = _set_stats(args.set_b, args, ev_box)
    return {"metric": "fid", "value": frechet_distance(sa, sb),
            "n_a": int(sa.n), "n_b": int(sb.n), "real_weights": wa and wb}


def cmd_stats(args):
    from spgan_tpu_torch.evalkit.fid import FIDEvaluator

    model, real_w = _inception(args)
    s = FIDEvaluator(model, device=args.device).stats_from_batches(
        _batches(_load_set(args.set_a, args.n), args.batch))
    s.save(args.out)
    return {"metric": "inception_stats", "out": args.out, "n": int(s.n),
            "real_weights": real_w}


def cmd_is(args):
    from spgan_tpu_torch.evalkit.is_score import inception_score

    model, real_w = _inception(args, with_logits=True)
    imgs = _load_set(args.set_a, args.n)
    mean, std = inception_score(_batches(imgs, args.batch), model,
                                splits=args.splits)
    return {"metric": "inception_score", "value": mean, "std": std,
            "n": int(imgs.shape[0]), "splits": args.splits,
            "real_weights": real_w}


def cmd_lpips(args):
    import torch

    from spgan_tpu_torch.evalkit.fid import tf32_off
    from spgan_tpu_torch.evalkit.lpips import load_torch_lpips, random_lpips

    if args.alex and args.lin:
        model, real_w = load_torch_lpips(args.alex, args.lin,
                                         device=args.device), True
    elif not args.allow_random_weights:
        raise SystemExit(
            "no LPIPS weights: pass --alex (torchvision alexnet state "
            "dict) and --lin (lpips v0.1 alex.pth, as vendored by the "
            "reference at libs/lpips/weights/v0.1/alex.pth), or "
            "--allow-random-weights for a meaningless smoke run")
    else:
        model, real_w = random_lpips(device=args.device), False
    a = _load_set(args.set_a, args.n)
    b = _load_set(args.set_b, args.n)
    if a.shape != b.shape:
        raise SystemExit(f"lpips compares aligned sets pairwise: {a.shape} "
                         f"vs {b.shape}")
    dev = next(model.parameters()).device
    vals = []
    with torch.no_grad(), tf32_off():
        for i in range(0, a.shape[0], args.batch):
            d = model(torch.as_tensor(_norm(a[i:i + args.batch])).to(dev),
                      torch.as_tensor(_norm(b[i:i + args.batch])).to(dev))
            vals.append(d.cpu().numpy().reshape(-1))
    vals = np.concatenate(vals)
    return {"metric": "lpips", "value": float(vals.mean()),
            "std": float(vals.std()), "n": int(vals.shape[0]),
            "real_weights": real_w}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m spgan_tpu_torch.evalkit",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, two_sets in (("fid", True), ("is", False), ("lpips", True),
                           ("stats", False)):
        p = sub.add_parser(name)
        p.add_argument("set_a")
        if two_sets:
            p.add_argument("set_b")
        p.add_argument("--n", type=int, default=None,
                       help="cap the number of images per set")
        p.add_argument("--batch", type=int, default=50)
        p.add_argument("--allow-random-weights", action="store_true")
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        if name in ("fid", "is", "stats"):
            p.add_argument("--inception", default=None)
        if name == "is":
            p.add_argument("--splits", type=int, default=1)
        if name == "lpips":
            p.add_argument("--alex", default=None)
            p.add_argument("--lin", default=None)
        if name == "stats":
            p.add_argument("--out", required=True,
                           help="output pickle path ({mu, sigma, n})")
    args = ap.parse_args(argv)
    out = {"fid": cmd_fid, "is": cmd_is, "lpips": cmd_lpips,
           "stats": cmd_stats}[args.cmd](args)
    if not out.get("real_weights", True):
        out["WARNING"] = "random network weights — value is meaningless"
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
