"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Loads, warms up, measures the window,
checks what the timed path produced against the plain reference, and
prints the result as one JSON object on the last line of standard output,
the numbers compared with their limits as the last lines of standard
error.  Exits non-zero, printing no result, without enough CUDA devices,
or when JAX or the JAX package is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
_CACHE = _HERE / "_cache"
# every kernel cache of the program at a fixed path inside the checkout,
# so only the first run of a checkout builds
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
if str(_HERE.parent) not in sys.path:
    sys.path.insert(0, str(_HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    manifest = harness.load_manifest()
    cell = harness.find_cell(manifest, args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"needs {cell['chips']}")
        return 2
    result, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t0=T0, manifest=manifest)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"forbidden modules loaded: {found}")
        return 3
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
