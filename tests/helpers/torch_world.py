"""Worlds of CPU processes joined by torch.distributed over gloo, for the
port's scale-out tests.

    results = run_world("helpers.scale_scenarios:train_steps", 2, tmp_path)

starts one process per rank of this file (start_world returns at once,
so the caller can work while the world runs).  Each joins the world with
spgan_tpu_torch.parallel.init_distributed (gloo, CPU, two torch threads,
a process-group timeout of GROUP_TIMEOUT_S), calls the target
`module:function` (importable from tests/ or the repo root, e.g.
"helpers.scale_scenarios:train_steps") as
fn(mesh, out, *args) and saves the dict `out` of numpy arrays.  With
join=False the child joins nothing and calls fn(None, out, coordinator,
n, rank, *args): the target starts the world itself (a CLI's flags).
run_world returns the ranks' dicts in rank order.  A child that fails or
outlives `timeout` fails the caller with its output; every child is
killed before run_world returns.  A world of one joins no process group.
"""
import importlib
import os
import socket
import subprocess
import sys
import time

import numpy as np

TESTS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(TESTS)
GROUP_TIMEOUT_S = 60


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class World:
    """The processes of one world; results() waits for them.  Each child
    writes its output to a file beside its results (a pipe that nobody
    reads could fill and stall it)."""

    def __init__(self, target, procs, outs, logs, timeout):
        self.target, self.procs, self.outs = target, procs, outs
        self.logs, self.timeout = logs, timeout
        self.deadline = time.monotonic() + timeout

    def results(self, check=True):
        """The ranks' dicts in rank order; check=False returns (exit
        codes, outputs) instead.  Every child is ended on return."""
        n = len(self.procs)
        try:
            for r, p in enumerate(self.procs):
                try:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise AssertionError(
                        f"{self.target}: rank {r} of {n} did not end within "
                        f"{self.timeout} s") from None
        finally:
            self.close()
        logs = []
        for path in self.logs:
            with open(path, errors="replace") as f:
                logs.append(f.read())
        if not check:
            return [p.returncode for p in self.procs], logs
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, \
                f"{self.target}: rank {r} of {n} failed:\n{logs[r][-6000:]}"
        return [dict(np.load(o)) for o in self.outs]

    def close(self):
        """Kill every child still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_world(target, n, out_dir, timeout=240, args=(), cwds=None,
                join=True) -> World:
    """Start the world's processes and return at once; cwds: one working
    directory per rank (default: the caller's)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS] + [p for p in [env.get("PYTHONPATH")] if p])
    env.pop("XLA_FLAGS", None)
    stem = os.path.join(str(out_dir), f"{target.replace(':', '_')}_{n}_")
    outs = [f"{stem}{r}.npz" for r in range(n)]
    logs = [f"{stem}{r}.log" for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, target, str(n), str(r), str(port),
                 outs[r], "join" if join else "no-join",
                 *map(str, args)],
                env=env, cwd=None if cwds is None else str(cwds[r]),
                stdout=log, stderr=subprocess.STDOUT))
    return World(target, procs, outs, logs, timeout)


def run_world(target, n, out_dir, timeout=240, args=(), cwds=None,
              join=True, check=True):
    """start_world, then its results."""
    return start_world(target, n, out_dir, timeout, args, cwds,
                       join).results(check)


def _child():
    target, n, rank, port, out, join = sys.argv[1:7]
    import torch

    torch.set_num_threads(2)
    from spgan_tpu_torch.parallel.mesh import close, init_distributed

    fn = getattr(importlib.import_module(target.split(":")[0]),
                 target.split(":")[1])
    res = {}
    if join == "no-join":
        fn(None, res, f"127.0.0.1:{port}", n, rank, *sys.argv[7:])
    else:
        mesh = init_distributed(f"127.0.0.1:{port}", int(n), int(rank),
                                device="cpu",
                                timeout_s=GROUP_TIMEOUT_S)
        try:
            fn(mesh, res, *sys.argv[7:])
        finally:
            close(mesh)
    np.savez(out, **res)


if __name__ == "__main__":
    _child()
