"""Spatial collectives: the halo exchanges and global reductions of maps
split by image rows over a spatial group (the port of what GSPMD inserts
for ``egm_unet_tpu/parallel/mesh.py``'s ``spatial`` axis).

Under ``parallel.use_spatial_group`` each rank of the group holds rows
``row_range(H, rank, n)`` of every map whose global height is H (the scope's
``spatial().height``).  An op that reads across rows asks for the rows it
needs in global coordinates; rows outside ``[0, H)`` take the op's fill (0
for convolutions and average pools, ``-inf`` for max pools), rows inside come
from whichever ranks hold them, however far away: a halo may be taller than
a neighbour's slab.  Every function here is a ``torch.autograd.Function``
whose backward sends each gradient back to the rank that owns its rows, and
is collective: every rank of the group calls it, in the same order, forward
and backward (a rank whose own exchange is empty still takes part).

- ``fetch_rows(x, a, b, fill)``: global rows ``[a[r], b[r])`` on rank r.
- ``halo(x, top, bottom, fill)``: this rank's rows with ``top`` rows above
  and ``bottom`` below.
- ``spatial_sum`` / ``spatial_max``: a reduction over the group.

Each exchange is one all-gather of equal blocks (each rank's rows for the
others, padded to the largest block), which moves CUDA tensors under both
NCCL and gloo; the collectives are counted on the group (``DataGroup``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from egm_unet_torch.parallel.mesh import DataGroup, Spatial, spatial


def _overlap(a: int, b: int, lo: int, hi: int) -> tuple:
    return max(a, lo), min(b, hi)


def _plan(sp: Spatial, a: Sequence[int], b: Sequence[int]) -> dict:
    """``(t, u) -> (r0, r1)``: the global rows rank t sends to rank u."""
    ranges = sp.ranges()
    plan = {}
    for t, (lo, hi) in enumerate(ranges):
        for u in range(len(ranges)):
            r0, r1 = _overlap(a[u], b[u], lo, hi)
            if t != u and r1 > r0:
                plan[(t, u)] = (r0, r1)
    return plan


def _rows(x: torch.Tensor, axis: int, r0: int, r1: int) -> torch.Tensor:
    return x.narrow(axis, r0, r1 - r0)


def _exchange(group: DataGroup, blocks: list, sizes: list, like: torch.Tensor,
              axis: int) -> list:
    """All-gather this rank's ``blocks`` (rows along ``axis``) as one block
    padded to the largest of every rank's ``sizes``; returns each rank's
    block."""
    shape = list(like.shape)
    shape[axis] = max(sizes)
    mine = like.new_zeros(shape)
    off = 0
    for blk in blocks:
        n = blk.shape[axis]
        _rows(mine, axis, off, off + n).copy_(blk)
        off += n
    return group.all_gather_list(mine)


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, fill, axis, sp):
        group, me, n = sp.group, sp.group.rank, sp.group.world
        lo, hi = sp.rows
        plan = _plan(sp, a, b)
        sizes = [sum(r1 - r0 for (t, _), (r0, r1) in plan.items() if t == s)
                 for s in range(n)]
        parts = _exchange(group, [_rows(x, axis, r0 - lo, r1 - lo)
                                  for (t, _), (r0, r1) in plan.items() if t == me],
                          sizes, x, axis)
        shape = list(x.shape)
        shape[axis] = b[me] - a[me]
        out = x.new_full(shape, fill)
        r0, r1 = _overlap(a[me], b[me], lo, hi)
        if r1 > r0:
            _rows(out, axis, r0 - a[me], r1 - a[me]).copy_(_rows(x, axis, r0 - lo, r1 - lo))
        for t in range(n):
            if (t, me) in plan:
                # t's block holds its rows for each rank u in order
                off = sum(r1 - r0 for (s, u), (r0, r1) in plan.items() if s == t and u < me)
                r0, r1 = plan[(t, me)]
                _rows(out, axis, r0 - a[me], r1 - a[me]).copy_(
                    _rows(parts[t], axis, off, off + r1 - r0))
        ctx.sp, ctx.a, ctx.axis, ctx.plan = sp, a, axis, plan
        ctx.in_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        sp, a, axis, plan = ctx.sp, ctx.a, ctx.axis, ctx.plan
        group, me, n = sp.group, sp.group.rank, sp.group.world
        lo, hi = sp.rows
        gx = g.new_zeros(ctx.in_shape)
        r0, r1 = _overlap(a[me], a[me] + g.shape[axis], lo, hi)
        if r1 > r0:
            _rows(gx, axis, r0 - lo, r1 - lo).add_(_rows(g, axis, r0 - a[me], r1 - a[me]))
        # each received row's gradient goes back to its owner, in the
        # forward's plan reversed: rank u sends (t -> u) rows back to t
        sizes = [sum(r1 - r0 for (_, u), (r0, r1) in plan.items() if u == s)
                 for s in range(n)]
        parts = _exchange(group, [_rows(g, axis, r0 - a[me], r1 - a[me])
                                  for (_, u), (r0, r1) in plan.items() if u == me],
                          sizes, g, axis)
        for u in range(n):
            if (me, u) in plan:
                off = sum(r1 - r0 for (t, v), (r0, r1) in plan.items() if v == u and t < me)
                r0, r1 = plan[(me, u)]
                _rows(gx, axis, r0 - lo, r1 - lo).add_(
                    _rows(parts[u], axis, off, off + r1 - r0))
        return gx, None, None, None, None, None


def fetch_rows(x: torch.Tensor, a: Sequence[int], b: Sequence[int], fill: float = 0.0,
               axis: int = 1, scope: Optional[Spatial] = None) -> torch.Tensor:
    """Global rows ``[a[rank], b[rank])`` of the row-split map ``x`` (this
    rank's rows along ``axis``) on each rank of the spatial group: rows
    outside ``[0, H)`` take ``fill``, the others come from the ranks that
    hold them.  ``a`` and ``b`` list every rank's request (every rank can
    compute them, and every rank must pass the same lists): a rank sends
    another the rows it asked for.  ``scope`` defaults to ``spatial()``.
    The backward adds each fetched row's gradient into the rank that owns
    it.  Where every rank asks only for rows it holds, no collective runs
    and the result is a view of ``x``."""
    sp = scope or spatial()
    if sp is None:
        raise ValueError("fetch_rows needs a spatial group (use_spatial_group)")
    a, b = tuple(int(v) for v in a), tuple(int(v) for v in b)
    ranges = sp.ranges()
    lo, hi = ranges[sp.group.rank]
    if x.shape[axis] != hi - lo:
        raise ValueError(f"rank {sp.group.rank} holds {x.shape[axis]} rows along axis "
                         f"{axis}, not {hi - lo} of a map of height {sp.height}")
    if all(r0 <= ar and br <= r1 for (r0, r1), ar, br in zip(ranges, a, b)):
        return x.narrow(axis, a[sp.group.rank] - lo, b[sp.group.rank] - a[sp.group.rank])
    return _FetchRows.apply(x, a, b, float(fill), axis, sp)


def halo(x: torch.Tensor, top: int, bottom: Optional[int] = None, fill: float = 0.0,
         axis: int = 1) -> torch.Tensor:
    """This rank's rows of ``x`` with ``top`` rows above and ``bottom``
    (default ``top``) below: the input of a stride-1 window op whose
    padding is ``top`` / ``bottom`` rows of ``fill``."""
    sp = spatial()
    bottom = top if bottom is None else bottom
    ranges = sp.ranges()
    return fetch_rows(x, [lo - top for lo, _ in ranges], [hi + bottom for _, hi in ranges],
                      fill, axis, sp)


def image_rows(lo: int, hi: int, height: int, device=None) -> torch.Tensor:
    """A bool ``[hi - lo]`` mask of the global rows ``[lo, hi)`` that lie in
    the image ``[0, height)``."""
    r = torch.arange(lo, hi, device=device)
    return (r >= 0) & (r < height)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum: the gradient of x is their sum
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = group.all_reduce(x.detach().clone(), op=dist.ReduceOp.MAX)
        ctx.group = group
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        hit = (x == m).to(g.dtype)
        # the summed gradient, shared by the ranks whose values are the max
        total, ties = ctx.group.all_reduce(torch.stack([g, hit])).unbind(0)
        return hit * total / ties, None


def _group(group: Optional[DataGroup]) -> DataGroup:
    if group is not None:
        return group
    sp = spatial()
    if sp is None:
        raise ValueError("no spatial group (use_spatial_group) and none given")
    return sp.group


def spatial_sum(x: torch.Tensor, group: Optional[DataGroup] = None) -> torch.Tensor:
    """``x`` summed over ``group`` (default the spatial group), every rank
    the sum; the backward sums the ranks' gradients (each rank's loss reads
    the sum)."""
    return _Sum.apply(x, _group(group))


def spatial_max(x: torch.Tensor, group: Optional[DataGroup] = None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` (default the spatial
    group); the backward gives the summed gradient to the ranks holding the
    maximum, shared equally where several do."""
    return _Max.apply(x, _group(group))
