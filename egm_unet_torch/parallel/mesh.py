"""Data, spatial and model parallelism over processes (port of
``egm_unet_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh: the batch is sharded
over the mesh's ``data`` axis, image height over ``spatial`` or the CLIP
towers' weights over ``model``, and GSPMD inserts every reduction and every
halo exchange.  Here each rank is a process with its own copy of the model,
and each of those is written out: the BatchNorm's sums (``nn/layers.py``),
the loss's global denominators and first sample (``losses.py``), the
gradients (``engine/train.py``), the Long-CLIP features
(``engine/longclip_train.py``), the halos of every op that reads across rows
(``parallel/halo.py``) and the Megatron collectives (``parallel/tp.py``).
They read their groups from ``data_group()``, ``spatial()`` and
``model_group()``, which a step sets with ``use_data_group``,
``use_spatial_group`` and ``use_model_group``.

- ``launch(fn, world, backend, *args)`` runs ``fn(group, *args)`` on
  ``world`` ranks: processes started by ``torch.multiprocessing`` (spawn),
  joined by a ``file://`` rendezvous in a temporary directory, NCCL with one
  GPU per rank or gloo (CPU tensors, or CUDA tensors through the host); a
  world of 1 runs in the calling process, under a group of one.
- ``make_grid(group, n_data, n_inner)``: the ``n_data x n_inner`` rank grid
  (``get_mesh`` / ``get_mesh_sp``): rank ``d * n_inner + i`` is data rank
  ``d``, inner (spatial or model) rank ``i``, with one process group per row
  (the inner ranks of one data rank) and per column (the data ranks of one
  inner rank).
- ``rank_rows`` / ``shard_batch`` / ``shard_superbatch``: this rank's rows
  of a global batch (with ``accum`` > 1, of each of its microbatches);
  ``row_range`` / ``shard_batch_spatial`` / ``shard_superbatch_spatial``:
  also its image rows.
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
    """This process's place in a group of ranks (the data ranks, or a row or
    column of a rank grid): the process group, its rank and size, and a
    count of the collectives issued through it.  ``host`` is a gloo group of
    the same ranks for host-side integers (the group itself under gloo)."""

    group: object
    rank: int
    world: int
    collectives: int = 0
    host: object = None

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the group (a sum unless ``op`` says otherwise),
        in place."""
        self.collectives += 1
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along axis 0 in rank order (no
        gradient: see ``all_gather``)."""
        return torch.cat(self.all_gather_list(t))

    def all_gather_list(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (all of one shape), in rank order."""
        self.collectives += 1
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (``src`` a rank of the
        group), in place."""
        self.collectives += 1
        dist.broadcast(t, group_src=src, group=self.group)
        return t

    def host_ints(self, values) -> list:
        """Every rank's list of ints (one length on every rank), in rank
        order, gathered on the host over ``host``."""
        self.collectives += 1
        t = torch.tensor(list(values), dtype=torch.int64)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.host if self.host is not None else self.group)
        return [p.tolist() for p in parts]


_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)
_SPATIAL: contextvars.ContextVar = contextvars.ContextVar("spatial", default=None)
_MODEL_GROUP: contextvars.ContextVar = contextvars.ContextVar("model_group", default=None)


@contextlib.contextmanager
def _using(var: contextvars.ContextVar, value):
    token = var.set(value)
    try:
        yield value
    finally:
        var.reset(token)


def data_group() -> Optional[DataGroup]:
    """The group over which the step running in this thread reduces its
    batch (the BatchNorms' statistics, the loss, the gradients): the data
    ranks, times the spatial ranks under spatial parallelism; or None (one
    process)."""
    return _DATA_GROUP.get()


def use_data_group(group: Optional[DataGroup]):
    """Make ``group`` the data group that the BatchNorms and the losses read
    inside the block."""
    return _using(_DATA_GROUP, group)


@dataclasses.dataclass(frozen=True)
class Spatial:
    """The spatial group of a row-split step and the global height of the
    maps at the current scope: this rank holds rows
    ``row_range(height, group.rank, group.world)`` of each of them."""

    group: DataGroup
    height: int

    @property
    def rows(self) -> tuple:
        return row_range(self.height, self.group.rank, self.group.world)

    def ranges(self, height: Optional[int] = None) -> list:
        """Every rank's rows at ``height`` (default the scope's)."""
        h = self.height if height is None else height
        return [row_range(h, r, self.group.world) for r in range(self.group.world)]


def spatial() -> Optional[Spatial]:
    """The spatial scope of the step running in this thread, or None (maps
    are whole)."""
    return _SPATIAL.get()


def use_spatial_group(group: Optional[DataGroup], height: Optional[int] = None):
    """Row-split every op inside the block over ``group``, whose maps have
    global height ``height``; nothing without a group."""
    return _using(_SPATIAL, None if group is None else Spatial(group, int(height)))


def use_spatial(scope: Optional[Spatial]):
    """Re-enter a scope ``spatial()`` returned (None: maps are whole)."""
    return _using(_SPATIAL, scope)


def at_height(height: int):
    """The current spatial group at another global height (a deeper or
    shallower stage of a UNet); a no-op context without one."""
    scope = _SPATIAL.get()
    if scope is None:
        return contextlib.nullcontext()
    return _using(_SPATIAL, Spatial(scope.group, int(height)))


def model_group() -> Optional[DataGroup]:
    """The tensor-parallel group of the CLIP towers run in this thread, or
    None.  ``parallel/tp.py``'s sharded layers carry their own group; this
    is the one a caller set for them with ``use_model_group``."""
    return _MODEL_GROUP.get()


def use_model_group(group: Optional[DataGroup]):
    """Make ``group`` the model group that ``shard_clip`` and
    ``gather_clip_state`` take by default inside the block."""
    return _using(_MODEL_GROUP, group)


# ------------------------------------------------------------ process groups

def init_group(backend: str, rank: int, world: int, init_file: str) -> DataGroup:
    """Join the default process group by a ``file://`` rendezvous.  NCCL
    takes GPU ``rank``."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    return DataGroup(dist.group.WORLD, rank, world)


@dataclasses.dataclass
class Grid:
    """This rank's place in an ``n_data x n_inner`` grid (``make_grid``):
    ``world`` every rank, ``inner`` its row (the spatial or model ranks of
    its data rank), ``data`` its column (the data ranks of its inner
    rank)."""

    world: DataGroup
    inner: DataGroup
    data: DataGroup
    n_data: int
    n_inner: int

    @property
    def data_rank(self) -> int:
        return self.data.rank

    @property
    def inner_rank(self) -> int:
        return self.inner.rank


def make_grid(group: DataGroup, n_data: int, n_inner: int) -> Grid:
    """Split ``group`` (the whole world) into an ``n_data x n_inner`` grid,
    row-major as ``get_mesh`` reshapes the devices: rank ``d * n_inner + i``
    holds data rank ``d`` and inner rank ``i``.  Every rank creates every
    row and column group, in one order (``dist.new_group`` is collective),
    and a gloo twin of each for host integers where the backend is not
    gloo."""
    if n_data * n_inner != group.world:
        raise ValueError(f"grid {n_data} x {n_inner} != {group.world} ranks")
    gloo = dist.get_backend() == "gloo"
    d, i = divmod(group.rank, n_inner)
    groups = {}
    for kind, members in ([("inner", [r * n_inner + j for j in range(n_inner)])
                           for r in range(n_data)]
                          + [("data", [r * n_inner + j for r in range(n_data)])
                             for j in range(n_inner)]):
        pg = dist.new_group(members)
        host = pg if gloo else dist.new_group(members, backend="gloo")
        if group.rank in members:
            groups[kind] = DataGroup(pg, members.index(group.rank), len(members),
                                     host=host)
    if group.host is None:
        group.host = dist.group.WORLD if gloo else dist.new_group(backend="gloo")
    assert (groups["data"].rank, groups["inner"].rank) == (d, i)
    return Grid(group, groups["inner"], groups["data"], n_data, n_inner)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world: int, backend: str, tmp: str,
               args: tuple, grid: Optional[tuple] = None) -> None:
    group = init_group(backend, rank, world, os.path.join(tmp, "rendezvous"))
    try:
        out = fn(group if grid is None else make_grid(group, *grid), *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        destroy_group()


def launch(fn: Callable, world: int, backend: str, *args,
           grid: Optional[tuple] = None) -> list:
    """``fn(group, *args)`` on ``world`` ranks of this host; returns every
    rank's result in rank order.  ``fn`` must be a module-level function and
    its results and ``args`` picklable: ranks are spawned processes.  A rank
    that raises ends the others, and ``launch`` raises.  ``world == 1`` runs
    ``fn`` in this process.  ``grid=(n_data, n_inner)``: ``fn`` gets the
    rank's ``Grid`` (``make_grid``) in place of the group.  The ranks talk
    over the loopback interface unless ``GLOO_SOCKET_IFNAME`` /
    ``NCCL_SOCKET_IFNAME`` name another."""
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    with tempfile.TemporaryDirectory(prefix="egm_dp_") as tmp:
        if world == 1:
            group = init_group(backend, 0, 1, os.path.join(tmp, "rendezvous"))
            try:
                return [fn(group if grid is None else make_grid(group, *grid), *args)]
            finally:
                destroy_group()
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, tmp, args, grid), nprocs=world,
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


def row_range(height: int, rank: int, n: int) -> tuple:
    """The image rows ``[lo, hi)`` that spatial rank ``rank`` of ``n``
    holds of a map whose global height is ``height``: ``lo = rank * height
    // n``, ``hi = (rank + 1) * height // n``.  Every rank holds
    ``floor(height / n)`` or ``ceil(height / n)`` rows (6 rows over 4 ranks:
    1, 2, 1, 2), in order; the ranges tile ``[0, height)``.  Each stage of a
    UNet is split afresh at its own height, so a pooled map's rows need not
    be the halves of the rows above it (``ops/pooling.py`` fetches the row
    a pair is missing).  A height below ``n`` leaves a rank without rows:
    ValueError."""
    if height < n:
        raise ValueError(f"a map of {height} rows cannot be split over {n} spatial "
                         f"ranks (at least one row each)")
    return rank * height // n, (rank + 1) * height // n


UNET_STAGES = 5  # the UNets' stages: the input's height, then four pools


def check_spatial_height(height: int, n: int) -> None:
    """Refuse an input height whose UNet stages (``height >> k``) cannot
    each give every one of ``n`` spatial ranks a row: ValueError naming the
    stage, before any step runs."""
    for k in range(UNET_STAGES):
        if height >> k < n:
            raise ValueError(
                f"input height {height} over {n} spatial ranks: stage {k} has "
                f"{height >> k} rows, fewer than the ranks; use a height of at "
                f"least {n << (UNET_STAGES - 1)}")


def global_height(group: DataGroup, rows: int) -> int:
    """The global height of a row-split input of which this rank holds
    ``rows`` rows: the sum of every spatial rank's, gathered on the host.
    Raises ValueError on every rank if the ranks' rows are not
    ``row_range``'s split of it, or a stage would be left without rows
    (``check_spatial_height``)."""
    counts = [c[0] for c in group.host_ints([rows])]
    height = sum(counts)
    check_spatial_height(height, group.world)
    want = [hi - lo for lo, hi in (row_range(height, r, group.world)
                                   for r in range(group.world))]
    if counts != want:
        raise ValueError(f"the spatial ranks hold {counts} rows of {height}, not "
                         f"row_range's split {want}: shard with shard_batch_spatial")
    return height


def _spatial_take(grid: Grid, arrays, axis: int, accum: int):
    rows = rank_rows(arrays[0].shape[axis], grid.data_rank, grid.n_data, accum)
    height = arrays[0].shape[axis + 1]
    check_spatial_height(height, grid.n_inner)
    lo, hi = row_range(height, grid.inner_rank, grid.n_inner)
    out = []
    for a in arrays:
        idx = torch.from_numpy(rows) if torch.is_tensor(a) else rows
        a = a[(slice(None),) * axis + (idx,)]
        out.append(a[(slice(None),) * (axis + 1) + (slice(lo, hi),)])
    return out[0] if len(out) == 1 else tuple(out)


def shard_batch_spatial(grid: Grid, *arrays, accum: int = 1):
    """This rank's part of each ``[B, H, ...]`` array (numpy or torch): its
    data rank's rows of the batch (``rank_rows``, by microbatch with
    ``accum``), and of those its spatial rank's image rows
    (``row_range``).  The port of ``shard_batch_spatial``'s
    ``P("data", "spatial")``."""
    return _spatial_take(grid, arrays, 0, accum)


def shard_superbatch_spatial(grid: Grid, *arrays, accum: int = 1):
    """``shard_batch_spatial`` on ``[K, B, H, ...]`` multi-step stacks; the
    step axis K stays whole (``P(None, "data", "spatial")``)."""
    return _spatial_take(grid, arrays, 1, accum)


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
