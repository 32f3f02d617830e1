"""Process meshes: the port's distributed runtime.

Port of lvt_tpu/parallel/mesh.py on ``torch.distributed``, which stands in
for ``jax.sharding.Mesh`` and ``shard_map``: one process per mesh slot
(rank), each holding its block of the sharded state and running the step
on it. Independent camera streams split over the ``stream`` axis; within
a stream, map-point blocks split over the ``points`` axis, whose process
group carries the step's reductions (ops/collectives.py). A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; ``mesh.get_group(axis)`` is
the group of this rank along ``axis``.

Set the process's device before a CUDA mesh is made (``init`` does): a
mesh made first would pick ``cuda:rank``, and ranks that share one card
all use ``cuda:0``.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

STREAM_AXIS = "stream"
POINT_AXIS = "points"


def init(backend: str, world_size: int, rank: int, init_method: str, *,
         device=None, timeout_s: float = 600.0) -> None:
    """Join the process group (``torch.distributed.init_process_group``):
    ``backend`` "gloo" or "nccl", ``init_method`` a ``tcp://host:port`` or
    ``file://`` rendezvous. With a CUDA ``device``, set it as this
    process's device first."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
        torch.cuda.init()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def _check_init() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call mesh.init (or "
                           "torch.distributed.init_process_group) first")


def mesh_1d(axis: str, n: int | None = None, *,
            device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named ``axis`` over the first ``n`` ranks (all by
    default)."""
    _check_init()
    n = dist.get_world_size() if n is None else n
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def stream_mesh(n: int | None = None, *,
                device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the ranks: pure data parallelism over camera
    streams."""
    return mesh_1d(STREAM_AXIS, n, device_type=device_type)


def point_mesh(n: int | None = None, *,
               device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the ranks: one stream's map split over them."""
    return mesh_1d(POINT_AXIS, n, device_type=device_type)


def stream_point_mesh(n_stream: int, n_point: int, *,
                      device_type: str = "cuda") -> DeviceMesh:
    """2-D mesh: streams x map-point shards, rank = stream * n_point +
    point."""
    _check_init()
    if dist.get_world_size() < n_stream * n_point:
        raise ValueError(f"a {n_stream} x {n_point} mesh needs "
                         f"{n_stream * n_point} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (n_stream, n_point),
                            mesh_dim_names=(STREAM_AXIS, POINT_AXIS))
