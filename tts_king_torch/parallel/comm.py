"""Collectives over one axis of the mesh, and the autograd functions that
carry them through the backward.

``Axis`` is one axis of a mesh (dp or tp) as this process sees it: its
process group, its size and this process's index on it. An axis of size 1
carries no group (parallel.mesh.build_mesh), and every helper is the
identity on an axis of no group (one process, a single-process mesh, or a
mesh axis of size 1), so a layer written through them is the plain layer
there, with no collective.

Gloo reduces CUDA tensors but gathers only host tensors, so ``all_gather``
stages a CUDA tensor through pinned host memory on a gloo group;
``all_reduce`` runs on the tensors where they lie. NCCL runs each
collective on the card.

Tensor parallelism (Megatron-LM's column -> row split) needs two autograd
functions on the tp axis: ``copy_to`` (identity forward, all-reduce of the
gradient backward) in front of a column-split layer, and ``reduce_from``
(all-reduce forward, identity backward) behind a row-split one. Statistics
over the data-parallel batch (BatchNorm's, the CWT pitch's) go through
``sum_over``: all-reduce forward and backward, since every rank's loss
depends on the sum of every rank's rows.
"""

from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis seen from this process."""
    group: Any = None      # a ProcessGroup, or None: no collective runs
    size: int = 1
    index: int = 0


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, axis: Optional[Axis],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over ``axis``; returns it. NCCL reduces
    contiguous tensors only: a strided one goes through a contiguous
    copy."""
    if axis is not None and axis.group is not None:
        c = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(c, op=op, group=axis.group)
        if c is not t:
            t.copy_(c)
    return t


def all_reduce_many(tensors, axis: Optional[Axis]) -> List[torch.Tensor]:
    """The sums over ``axis`` of several tensors, through one flat
    all-reduce (new tensors; the inputs are left as they are)."""
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)

    tensors = list(tensors)
    if axis is None or axis.group is None:
        return tensors
    flat = all_reduce(_flatten_dense_tensors(tensors), axis)
    return list(_unflatten_dense_tensors(flat, tensors))


def all_gather(t: torch.Tensor, axis: Optional[Axis]) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in axis order."""
    if axis is None or axis.group is None:
        return [t]
    staged = t.is_cuda and _gloo(axis.group)
    src = t.detach().contiguous()
    if staged:
        src = src.to("cpu").pin_memory()
    out = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(out, src, group=axis.group)
    if staged:
        out = [o.to(t.device) for o in out]
    return out


def _copy(x):
    """A contiguous copy to reduce in place (NCCL's layout)."""
    return x.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(_copy(x), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(_copy(x), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), ctx.axis), None


def copy_to(x, axis: Optional[Axis]):
    """Identity forward, all-reduce of the gradient backward."""
    if axis is None or axis.group is None:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x, axis: Optional[Axis]):
    """All-reduce forward, identity backward."""
    if axis is None or axis.group is None:
        return x
    return _ReduceFrom.apply(x, axis)


def sum_over(x, axis: Optional[Axis]):
    """All-reduce forward and backward."""
    if axis is None or axis.group is None:
        return x
    return _SumOver.apply(x, axis)
