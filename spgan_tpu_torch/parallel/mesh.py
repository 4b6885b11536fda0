"""Scale-out on torch.distributed (counterpart of spgan_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh. The port runs
one process per card, PyTorch's idiom: NCCL between cards, gloo on the
CPU. A `Mesh` is one process's view of that world: its rank, the world
size, its device and the process group's backend. A world of one with no
process group is a Mesh with backend None, and every collective below is
then the identity (or a local copy).

Gloo has no all_gather, gather or send/recv for CUDA tensors, so under
gloo every collective here copies its CUDA tensors through host memory
explicitly. That is the only way two ranks can share one card; NCCL
refuses two ranks on one card ("Duplicate GPU detected"), and that error
is left to raise.

The process group gets a timeout of its own, so a collective that hangs
(a peer that died, ranks that disagree on the sequence of collectives)
fails the run instead of waiting forever.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from spgan_tpu_torch.device import resolve
from spgan_tpu_torch.tree import tree_map

# long enough for rank 0's FID tick while the others wait at a barrier
DEFAULT_TIMEOUT_S = 900.0


@dataclass(frozen=True)
class Mesh:
    rank: int = 0
    world_size: int = 1
    device: Optional[torch.device] = None
    backend: Optional[str] = None  # None: no process group (a world of one)

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def _rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: `device` when it names one (a bare "cuda" means
    cuda:<local rank>); the default is cuda:<local rank>.  More local
    ranks than cards raise: ranks never share a card silently."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(
                f"local rank {local_rank} needs cuda:{local_rank}, but this "
                f"host has {n} card(s): start at most {n} processes per "
                "host, or name a device (ranks sharing a card need gloo)")
        dev = torch.device("cuda", local_rank)
    return dev


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the world and return this process's Mesh.

    The world comes from the arguments (coordinator "host:port",
    num_processes, process_id: train.py's flags) or, without them, from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK).  A world of one is a no-op (no process group) unless a
    backend is named.  The backend defaults to nccl for a CUDA device and
    gloo for the CPU; the device to cuda:<local rank>."""
    env = os.environ
    if num_processes is not None:
        if num_processes > 1 and (coordinator is None or process_id is None):
            raise ValueError("--num-processes > 1 needs --coordinator "
                             "host:port and --process-id")
        world, rank = num_processes, process_id or 0
        init_method = f"tcp://{coordinator}" if coordinator else None
    elif "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = "env://"
    else:
        world, rank, init_method = 1, 0, None
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in a world of {world}")
    if world == 1 and backend is None:
        return Mesh(device=resolve(device))
    # the local rank: torchrun's LOCAL_RANK, else the process id (the
    # processes of one host)
    dev = _rank_device(device, int(env.get("LOCAL_RANK", rank)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None:  # a named backend in a world of one
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank, timeout=timeout)
    return Mesh(rank=rank, world_size=world, device=dev, backend=backend)


def make_mesh(device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The Mesh of the default process group on `device`, or a world of
    one when no group is initialised."""
    if not dist.is_initialized():
        return Mesh(device=None if device is None else torch.device(device))
    return Mesh(rank=dist.get_rank(), world_size=dist.get_world_size(),
                device=None if device is None else torch.device(device),
                backend=dist.get_backend())


def close(mesh: Mesh) -> None:
    """Leave the world (destroy the process group, when there is one)."""
    if mesh.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- helpers
def _comm_copy(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` for a collective to work in: in host memory
    when gloo must carry a CUDA tensor (gloo has no CUDA all_gather,
    gather or send/recv; its other collectives take the same route so
    that every collective moves CUDA data one way)."""
    to = torch.device("cpu") if mesh.backend == "gloo" else t.device
    return t.detach().to(to, copy=True).contiguous()


def barrier(mesh: Mesh) -> None:
    """Wait until every rank arrives (no-op without a process group)."""
    if mesh.backend is not None:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    buf = _comm_copy(mesh, t)
    dist.all_reduce(buf)
    return buf.to(t.device)


def _all_gather_cat(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    src = _comm_copy(mesh, t)
    bufs = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(bufs, src)
    return torch.cat(bufs).to(t.device)


def _broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """`t` overwritten in place with rank src's values; returns it."""
    if mesh.backend is not None:
        buf = _comm_copy(mesh, t)
        dist.broadcast(buf, src)
        with torch.no_grad():
            t.copy_(buf)
    return t


def broadcast_int(v: int, mesh: Mesh, src: int = 0) -> int:
    t = torch.tensor([int(v)], dtype=torch.int64,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    return int(_broadcast(t, mesh, src))


def gather_rows(t: torch.Tensor, mesh: Mesh, dst: int = 0
                ) -> Optional[torch.Tensor]:
    """The ranks' `t` concatenated along dim 0 in rank order on rank dst,
    None on the others (every rank's `t` has the same shape)."""
    if mesh.backend is None:
        return t
    src = _comm_copy(mesh, t)
    bufs = ([torch.empty_like(src) for _ in range(mesh.world_size)]
            if mesh.rank == dst else None)
    dist.gather(src, bufs, dst=dst)
    return torch.cat(bufs).to(t.device) if mesh.rank == dst else None


# ----------------------------------------------- differentiable collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks; the adjoint of a sum that every rank receives is
    again that sum, so backward is this Function (double backward too)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.mesh), None


class _AllGatherRows(torch.autograd.Function):
    """The ranks' rows concatenated in rank order.  Backward: the sum of
    every rank's gradient of the gathered tensor (an _AllReduceSum, so
    R1's double backward passes through it), then this rank's rows.
    torch.distributed.nn's all_gather is not used: its backward needs
    reduce_scatter or all_to_all, which gloo lacks."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.n = mesh, t.shape[0]
        return _all_gather_cat(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        r, n = ctx.mesh.rank, ctx.n
        return _AllReduceSum.apply(grad, ctx.mesh)[r * n:(r + 1) * n], None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t if mesh.backend is None else _AllReduceSum.apply(t, mesh)


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.backend is None:
        return t
    return _AllReduceSum.apply(t, mesh) / mesh.world_size


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `t` (same shape on each) concatenated along dim 0."""
    return t if mesh.backend is None else _AllGatherRows.apply(t, mesh)


def ring_from_right(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor that the right neighbour ((rank + 1) % n) sends, while
    this rank sends `t` to its left neighbour: the counterpart of
    jax.lax.ppermute with perm [(i, (i - 1) % n)].  A world of one gets a
    local copy of its own `t`."""
    if mesh.world_size == 1:
        return t.clone()
    send = _comm_copy(mesh, t)
    recv = torch.empty_like(send)
    n, r = mesh.world_size, mesh.rank
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, (r - 1) % n),
        dist.P2POp(dist.irecv, recv, (r + 1) % n)])
    for q in reqs:
        q.wait()
    return recv.to(t.device)


# ------------------------------------------------------------------ trees
def _flatten(obj, out: List):
    """Tensor leaves of nested dicts, lists, tuples and dataclasses, in a
    fixed order (dict keys sorted)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _flatten(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), out)
    return out


def _flat_apply(tensors: Sequence[torch.Tensor],
                fn: Callable[[torch.Tensor], None]) -> None:
    """fn applied in place to one flat buffer per (dtype, device) holding
    every tensor, then the values copied back into the tensors."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        buf = torch.cat([t.detach().reshape(-1) for t in ts])
        fn(buf)
        with torch.no_grad():
            for t, v in zip(ts, buf.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def replicate(tree: Any, mesh: Mesh, src: int = 0) -> Any:
    """Every tensor of `tree` overwritten in place with rank src's values
    (one broadcast per dtype); returns the tree."""
    if mesh.backend is not None:
        _flat_apply(_flatten(tree, []), lambda b: _broadcast(b, mesh, src))
    return tree


def all_reduce_mean_(tensors: Sequence[Optional[torch.Tensor]],
                     mesh: Mesh) -> None:
    """Each tensor (None skipped) overwritten in place with its mean over
    the ranks: one all-reduce of a flat buffer per dtype (the sum, then
    divided by the world size)."""
    if mesh.backend is None:
        return

    def reduce(buf):
        buf.copy_(_all_reduce(buf, mesh))
        buf.div_(mesh.world_size)

    _flat_apply([t for t in tensors if t is not None], reduce)


def shard_batch(tree: Any, mesh: Mesh, dim: int = 0) -> Any:
    """This rank's contiguous block along `dim` of every tensor or numpy
    array of `tree` (dicts and lists); the size along `dim` must divide by
    the world size."""
    def take(x):
        if not hasattr(x, "shape") or len(x.shape) <= dim:
            return x
        size = x.shape[dim]
        if size % mesh.world_size:
            raise ValueError(f"a batch of {size} along dim {dim} does not "
                             f"split over {mesh.world_size} ranks")
        n = size // mesh.world_size
        idx = [slice(None)] * dim + [slice(mesh.rank * n,
                                           (mesh.rank + 1) * n)]
        return x[tuple(idx)]

    return tree_map(take, tree)
