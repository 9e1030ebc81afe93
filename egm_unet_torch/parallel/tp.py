"""Tensor parallelism for the CLIP towers (port of
``egm_unet_tpu/parallel/tp.py``), Megatron's layout over a model group.

In JAX the layout is a sharding annotation and GSPMD reshards around it.
Here each rank holds real slices of the weights and runs two collectives a
sublayer:

- attention ``in_proj`` [d, 3d] is split by heads (column parallel): rank r
  keeps the q, k and v columns of its ``heads / n`` heads, so that
  ``.chunk(3)`` of its output is its own heads' q, k and v.  (JAX's
  contiguous ``P(None, "model")`` would hand rank 0 all of q and half of k;
  GSPMD reshards around that, explicit ranks cannot.)  The block then runs
  its local heads, CSA (kernel K6) included;
- ``out_proj`` [d, d] is split by rows (row parallel), its bias added once
  after the all-reduce;
- MLP ``c_fc`` [d, 4d] by contiguous columns, ``c_proj`` [4d, d] by rows;
- the RN tower's attention-pool ``c_proj`` [E, out] by rows: its input is
  whole on every rank, and each takes its slice of it.

A block whose heads do not divide over the model ranks (the tiny test
configurations' one 64-wide vision head) keeps its attention whole on every
rank, and splits its MLP only: a head cannot be split without splitting its
scores, which K6 computes in one pass.  GSPMD splits such a head's columns
and reshards around it.

Before each column-split layer ``copy_to_model`` (identity forward,
all-reduce backward), after each row-split one ``reduce_from_model``
(all-reduce forward, identity backward): the replicated LayerNorms,
embeddings and projections then see whole activations and get whole, equal
gradients on every model rank.  Everything else stays replicated.

- ``clip_param_specs(module)``: parameter name -> ``"column"`` / ``"row"`` /
  ``"replicated"``, leaf for leaf JAX's ``clip_param_specs``.
- ``shard_clip(module, group)``: slice the full weights (as
  ``utils/from_flax.py`` loads them) in place to this rank's shard.
- ``gather_clip_state(module, group)``: the full ``state_dict`` (or the full
  gradients) back on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.parallel.mesh import DataGroup, model_group

COLUMN, ROW, REPLICATED = "column", "row", "replicated"


def _spec(parent: str, leaf: str) -> str:
    """JAX's ``_spec_for`` on the last two keys of a parameter's path."""
    if parent in ("in_proj", "c_fc"):
        return COLUMN
    if parent in ("out_proj", "c_proj"):
        return ROW if leaf == "kernel" else REPLICATED
    return REPLICATED


def clip_param_specs(module: nn.Module) -> dict:
    """Parameter name -> ``"column"`` (``P(None, "model")`` kernels and
    ``P("model")`` biases), ``"row"`` (``P("model", None)``) or
    ``"replicated"`` (``P()``), by the flax path of each parameter as JAX's
    ``_spec_for`` reads it (a module's ``flax_child`` is the leaf's
    parent)."""
    out = {}
    for name, _ in module.named_parameters():
        mod_path, _, leaf = name.rpartition(".")
        parent = (getattr(module.get_submodule(mod_path), "flax_child", None)
                  or mod_path.rpartition(".")[2])
        out[name] = _spec(parent, leaf)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Megatron's f: the identity forward; the backward sums the model
    ranks' gradients (each used the whole input for its shard)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Megatron's g: the sum of the model ranks' partial outputs; the
    identity backward."""
    return _ReduceFromModel.apply(x, group)


class _ShardedDense(nn.Module):
    """A shard of ``nn.layers.Dense``: ``kernel`` [in, out] and ``bias``
    under the same names, in the compute dtype (``cast_weights``)."""

    casts_with_compute_dtype = True

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor, group: DataGroup):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)
        self.group = group


class ColumnDense(_ShardedDense):
    """A ``Dense`` holding this rank's output columns: ``f(x) @ kernel +
    bias``.  ``layout``: ``"heads"`` (the q, k and v columns of this rank's
    heads) or ``"contiguous"``."""

    def __init__(self, kernel, bias, group: DataGroup, layout: str):
        super().__init__(kernel, bias, group)
        self.layout = layout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.group)
        return F.linear(x.to(self.kernel.dtype), self.kernel.t(), self.bias)


class RowDense(_ShardedDense):
    """A ``Dense`` holding this rank's input rows: ``g(x @ kernel) +
    bias``.  ``in_slice``: the input is whole on every rank and this rank
    takes those features of it (after ``f``, so that its gradient is whole
    too); else the input is this rank's part already."""

    def __init__(self, kernel, bias, group: DataGroup, in_slice: Optional[slice] = None):
        super().__init__(kernel, bias, group)
        self.in_slice = in_slice

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_slice is not None:
            x = copy_to_model(x, self.group)[..., self.in_slice]
        y = reduce_from_model(F.linear(x.to(self.kernel.dtype), self.kernel.t()), self.group)
        return y + self.bias


def _heads_cols(d: int, group: DataGroup) -> torch.Tensor:
    """The columns of ``in_proj`` [d, 3d] that this rank's heads use: q, k
    and v of heads ``[r h / n, (r + 1) h / n)``."""
    w = d // group.world
    own = torch.arange(group.rank * w, (group.rank + 1) * w)
    return torch.cat([own + i * d for i in range(3)])


def _rows(n: int, group: DataGroup) -> slice:
    if n % group.world:
        raise ValueError(f"{n} features do not split over {group.world} model ranks")
    w = n // group.world
    return slice(group.rank * w, (group.rank + 1) * w)


def _tp_block(block: nn.Module, group: DataGroup) -> None:
    hidden = _rows(block.c_fc.kernel.shape[1], group)
    ip, op, fc, pj = block.in_proj, block.out_proj, block.c_fc, block.c_proj
    with torch.no_grad():
        if block.heads % group.world == 0:
            d = ip.kernel.shape[0]
            cols, own = _heads_cols(d, group), _rows(d, group)
            block.in_proj = ColumnDense(ip.kernel[:, cols].clone(), ip.bias[cols].clone(),
                                        group, "heads")
            block.out_proj = RowDense(op.kernel[own].clone(), op.bias.detach(), group)
            block.heads //= group.world
        block.c_fc = ColumnDense(fc.kernel[:, hidden].clone(), fc.bias[hidden].clone(),
                                 group, "contiguous")
        block.c_proj = RowDense(pj.kernel[hidden].clone(), pj.bias.detach(), group)


def shard_clip(module: nn.Module, group: Optional[DataGroup] = None) -> nn.Module:
    """Slice ``module``'s full weights (a ``CLIP`` or a tower) in place to
    this rank's shard of ``group`` (default ``model_group()``): every
    ``ResidualAttentionBlock`` runs ``heads / n`` local heads (all of them
    where they do not divide) and its MLP's shard, and the RN tower's
    attention pool its ``c_proj`` rows.  Returns ``module``."""
    from egm_unet_torch.models.clip.model import ResidualAttentionBlock
    from egm_unet_torch.models.clip.resnet import AttentionPool2d

    group = group or model_group()
    if group is None:
        raise ValueError("shard_clip needs a model group")
    for mod in list(module.modules()):
        if isinstance(mod, ResidualAttentionBlock):
            _tp_block(mod, group)
        elif isinstance(mod, AttentionPool2d):
            pj = mod.c_proj
            rows = _rows(pj.kernel.shape[0], group)
            with torch.no_grad():
                mod.c_proj = RowDense(pj.kernel[rows].clone(), pj.bias.detach(), group, rows)
    return module


def _gather(t: torch.Tensor, layer: nn.Module, leaf: str, group: DataGroup) -> torch.Tensor:
    """The whole tensor of a sharded layer's ``leaf`` from every rank's
    shard."""
    if isinstance(layer, RowDense):
        return t if leaf == "bias" else torch.cat(group.all_gather_list(t), dim=0)
    parts = group.all_gather_list(t)
    axis = t.ndim - 1
    if layer.layout == "contiguous":
        return torch.cat(parts, dim=axis)
    # per head: q of every rank, then k, then v
    return torch.cat([p_.chunk(3, dim=axis)[i] for i in range(3) for p_ in parts], dim=axis)


def gather_clip_state(module: nn.Module, group: Optional[DataGroup] = None, *,
                      grads: bool = False) -> dict:
    """The full ``state_dict`` of a module ``shard_clip`` sliced (the names
    and shapes of the unsharded module) on every rank of ``group`` (default
    ``model_group()``); ``grads=True``: the full gradients instead (None for
    a parameter without one).  Collective: every rank calls it."""
    group = group or model_group()
    params = dict(module.named_parameters())
    out = {}
    for name, value in module.state_dict().items():
        if grads:
            if name not in params:
                continue
            p = params[name]
            value = None if p.grad is None else p.grad
        mod_path, _, leaf = name.rpartition(".")
        layer = module.get_submodule(mod_path)
        if value is not None and isinstance(layer, (ColumnDense, RowDense)):
            value = _gather(value.detach(), layer, leaf, group)
        out[name] = None if value is None else value.detach().clone()
    return out
