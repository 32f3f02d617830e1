"""Conditional collectives of the optionally sharded ops.

Port of lvt_tpu/ops/collectives.py on ``torch.distributed``. Every
map-indexed op of the step takes an optional ``group`` (a
``torch.distributed.ProcessGroup``, standing in for lvt_tpu's mesh
``axis_name``): with None it is the plain one-process program, bit for
bit; otherwise these reduce across the group's ranks, each of which holds
one block of the map.

Every reduction is one custom op, ``lvt_tpu_torch::all_reduce`` (``sum``,
``min`` or ``max`` of a tensor over the group): it all-reduces a
contiguous copy with ``torch.distributed.all_reduce`` and returns the copy,
so the caller's tensor is never written and nothing is read back to the
host (on NCCL the reduction is queued on the card's stream; gloo, which
carries CUDA tensors through the host, synchronises). Its ``register_vmap``
rule all-reduces the whole batched tensor once, with vmap's axis moved to
the front: a reduction is elementwise and every rank of a points group
holds the same local streams in the same order, so one collective of the
batch is S collectives of its streams. A plain functional collective under
``torch.func.vmap`` reduces nothing (each rank gets its own value back,
without an error); this op is what the stream x points step
(parallel/stream_point.py) runs under vmap.

:func:`axis_index` and :func:`axis_size` are the rank and the size of the
group, fields of the group object fixed when it is made: reading them
communicates nothing and touches no device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@torch.library.custom_op("lvt_tpu_torch::all_reduce", mutates_args=())
def all_reduce_op(x: torch.Tensor, op: str, group_name: str) -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``x`` over the process group named
    ``group_name``, elementwise; a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op],
                    group=dist.distributed_c10d._resolve_process_group(
                        group_name))
    all_reduce.calls += 1
    return out


@all_reduce_op.register_fake
def _all_reduce_fake(x, op, group_name):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _all_reduce_vmap(info, in_dims, x, op, group_name):
    """Batching rule: one collective of the whole batch, vmap's axis first."""
    d = in_dims[0]
    if d is None:
        return all_reduce_op(x, op, group_name), None
    return all_reduce_op(x.movedim(d, 0), op, group_name), 0


all_reduce_op.register_vmap(_all_reduce_vmap)


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` of ``x`` over ``group`` (a ProcessGroup), as a new tensor.
    ``all_reduce.calls`` counts the collectives run (one per batched call
    under vmap)."""
    return all_reduce_op(x, op, group.group_name)


all_reduce.calls = 0


def psum_if(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks when the caller's tensors are sharded."""
    return x if group is None else all_reduce(x, "sum", group)


def pmin_if(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over the group's ranks."""
    return x if group is None else all_reduce(x, "min", group)


def por_if(mask: torch.Tensor, group) -> torch.Tensor:
    """Logical OR of a boolean mask across ranks: a sum of int32, > 0, as
    lvt_tpu does."""
    if group is None:
        return mask
    return all_reduce(mask.to(torch.int32), "sum", group) > 0


def axis_index(group) -> int:
    """This rank's index in the group (0 without one)."""
    return 0 if group is None else group.rank()


def axis_size(group) -> int:
    """The number of ranks in the group (1 without one)."""
    return 1 if group is None else group.size()
