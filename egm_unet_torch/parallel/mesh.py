"""Data parallelism over processes (port of the data axis of
``egm_unet_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh: the batch is sharded
over the mesh's ``data`` axis and GSPMD inserts every reduction over the
global batch.  Here each rank is a process with its own copy of the model,
and each reduction over the global batch is written out: the BatchNorm's
sums (``nn/layers.py``), the loss's global denominators and first sample
(``losses.py``), the gradients (``engine/train.py``) and the Long-CLIP
features (``engine/longclip_train.py``).  They read the group from
``data_group()``, which a step sets with ``use_data_group``.

- ``launch(fn, world, backend, *args)`` runs ``fn(group, *args)`` on
  ``world`` ranks: processes started by ``torch.multiprocessing`` (spawn),
  joined by a ``file://`` rendezvous in a temporary directory, NCCL with one
  GPU per rank or gloo (CPU tensors, or CUDA tensors through the host); a
  world of 1 runs in the calling process, under a group of one.
- ``rank_rows`` / ``shard_batch`` / ``shard_superbatch``: this rank's rows
  of a global batch (with ``accum`` > 1, of each of its microbatches).
- ``replicated``: a module's parameters and buffers broadcast from rank 0.
- ``all_reduce_grads``: every gradient summed over the group in one flat
  all-reduce per dtype.
- ``all_gather``: a differentiable all-gather (backward: the sum of every
  rank's gradient, this rank's rows kept).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import tempfile
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class DataGroup:
    """This process's place in the data-parallel group: the process group,
    its rank and size, and a count of the collectives issued through it."""

    group: object
    rank: int
    world: int
    collectives: int = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place."""
        self.collectives += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along axis 0 in rank order (no
        gradient: see ``all_gather``)."""
        self.collectives += 1
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        self.collectives += 1
        dist.broadcast(t, src=src, group=self.group)
        return t


_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


def data_group() -> Optional[DataGroup]:
    """The data group of the step running in this thread, or None (one
    process)."""
    return _DATA_GROUP.get()


@contextlib.contextmanager
def use_data_group(group: Optional[DataGroup]):
    """Make ``group`` the data group that the BatchNorms and the losses read
    inside the block."""
    token = _DATA_GROUP.set(group)
    try:
        yield group
    finally:
        _DATA_GROUP.reset(token)


# ------------------------------------------------------------ process groups

def init_group(backend: str, rank: int, world: int, init_file: str) -> DataGroup:
    """Join the default process group by a ``file://`` rendezvous.  NCCL
    takes GPU ``rank``."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    return DataGroup(dist.group.WORLD, rank, world)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world: int, backend: str, tmp: str,
               args: tuple) -> None:
    group = init_group(backend, rank, world, os.path.join(tmp, "rendezvous"))
    try:
        out = fn(group, *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        destroy_group()


def launch(fn: Callable, world: int, backend: str, *args) -> list:
    """``fn(group, *args)`` on ``world`` ranks of this host; returns every
    rank's result in rank order.  ``fn`` must be a module-level function and
    its results and ``args`` picklable: ranks are spawned processes.  A rank
    that raises ends the others, and ``launch`` raises.  ``world == 1`` runs
    ``fn`` in this process.  The ranks talk over the loopback interface
    unless ``GLOO_SOCKET_IFNAME`` / ``NCCL_SOCKET_IFNAME`` name another."""
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    with tempfile.TemporaryDirectory(prefix="egm_dp_") as tmp:
        if world == 1:
            group = init_group(backend, 0, 1, os.path.join(tmp, "rendezvous"))
            try:
                return [fn(group, *args)]
            finally:
                destroy_group()
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, tmp, args), nprocs=world,
            join=True, start_method="spawn")
        # results this function's ranks wrote
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]


# ------------------------------------------------------------ batches

def rank_rows(batch: int, rank: int, world: int, accum: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch`` that rank ``rank`` holds.
    With ``accum`` microbatches of ``batch / accum`` rows (the JAX step's
    microbatch ``i`` is global rows ``[i * mb, (i + 1) * mb)``), the rank
    holds ``mb / world`` consecutive rows of each, microbatch by microbatch,
    so the first row of every microbatch is on rank 0."""
    if batch % (accum * world):
        raise ValueError(f"batch {batch} not divisible by accum {accum} x "
                         f"world {world}")
    mb = batch // accum
    per = mb // world
    return np.concatenate([i * mb + rank * per + np.arange(per) for i in range(accum)])


def shard_batch(group: Optional[DataGroup], *arrays, accum: int = 1):
    """This rank's rows (``rank_rows``) of each ``[B, ...]`` array (numpy or
    torch); all of them without a group."""
    if group is not None:
        rows = rank_rows(arrays[0].shape[0], group.rank, group.world, accum)
        arrays = tuple(a[torch.from_numpy(rows)] if torch.is_tensor(a) else a[rows]
                       for a in arrays)
    return arrays[0] if len(arrays) == 1 else arrays


def shard_superbatch(group: Optional[DataGroup], *arrays, accum: int = 1):
    """``shard_batch`` on the second axis of ``[K, B, ...]`` multi-step
    stacks; the step axis K stays whole."""
    if group is not None:
        rows = rank_rows(arrays[0].shape[1], group.rank, group.world, accum)
        arrays = tuple(a[:, torch.from_numpy(rows)] if torch.is_tensor(a) else a[:, rows]
                       for a in arrays)
    return arrays[0] if len(arrays) == 1 else arrays


def replicated(module: torch.nn.Module, group: Optional[DataGroup]) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place), so that the
    ranks start from one state whatever each loaded."""
    if group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                group.broadcast(t.data)
    return module


def all_reduce_grads(params: Iterable[torch.Tensor], group: DataGroup,
                     *extra: torch.Tensor) -> list:
    """Sum the gradients of ``params`` over ``group``, in place (a parameter
    without one gets the sum of zeros), together with the scalars ``extra``:
    one flat all-reduce per dtype.  Returns the sums of ``extra``."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tensors = [p.grad for p in params] + [e.reshape(1) for e in extra]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = group.all_reduce(torch.cat([t.reshape(-1) for t in same]))
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return [t[0] for t in tensors[len(params):]]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        g = group.all_reduce(g.contiguous().clone())
        b = g.shape[0] // group.world
        return g[group.rank * b:(group.rank + 1) * b], None


def all_gather(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Every rank's ``x`` stacked along axis 0, differentiable: the gradient
    of ``x`` is the sum over ranks of the gradient of its rows (each rank's
    loss differentiated through every rank's copy)."""
    return _AllGather.apply(x, group)
