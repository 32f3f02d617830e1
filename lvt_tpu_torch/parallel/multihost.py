"""Multi-process execution of many streams (config 4 across hosts).

Port of lvt_tpu/parallel/multihost.py on ``torch.distributed``:

* :func:`initialize` joins the process group (``init_process_group`` over
  TCP at the coordinator's address), the port's ``jax.distributed
  .initialize``;
* :class:`MultiHostStreamVO` is the config-4 driver where every process
  feeds only its own streams, so ingest never crosses hosts; the
  ``stream`` mesh places whole streams on single ranks, so tracking needs
  no collective at all;
* ``local_stream_indices`` (parallel/multistream.py) and
  ``MultiHostStreamVO.local_poses`` give this process's slice of the
  results. In torch a process holds only its
  own streams' tensors (there are no global arrays), so ``local_poses``
  is what it tracked; ``all_poses`` gathers every stream's poses over the
  group. lvt_tpu's ``_local_concat``, which assembles a process's slice
  from a global array's addressable shards, has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.parallel import mesh as mesh_mod
from lvt_tpu_torch.parallel.multistream import MultiStreamVO
# lvt_tpu's multihost.local_stream_indices, here as there
from lvt_tpu_torch.parallel.multistream import local_stream_indices  # noqa: F401


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, backend: str = "nccl",
               device=None) -> None:
    """Join the process group: ``coordinator_address`` is "host:port" of
    process 0, every process passes the same ``num_processes`` and its own
    ``process_id``. With a CUDA ``device``, it becomes this process's
    device first."""
    mesh_mod.init(backend, num_processes, process_id,
                  f"tcp://{coordinator_address}", device=device)


class MultiHostStreamVO(MultiStreamVO):
    """Config-4 driver where every process feeds only its local streams:
    ``track`` / ``track_chunk`` take arrays of this process's streams
    ([S_local, H, W] / [N, S_local, H, W], in ``local_stream_indices``
    order) and return their poses."""

    def __init__(self, config: VOConfig, n_streams: int, mesh=None, *,
                 device="cuda", auto_reset: bool = True, rgbd: bool = False):
        dev = torch.device(device)
        if mesh is None:
            mesh = mesh_mod.stream_mesh(device_type=dev.type)
        super().__init__(config, n_streams, mesh, device=device,
                         auto_reset=auto_reset, rgbd=rgbd)

    def local_poses(self, poses: Pose) -> tuple[np.ndarray, np.ndarray]:
        """(t, q) of this process's streams as numpy, stream axis in
        ``local_stream_indices`` order; [S_local] or [N, S_local]
        results."""
        return poses.t.cpu().numpy(), poses.q.cpu().numpy()

    def all_poses(self, poses: Pose) -> tuple[np.ndarray, np.ndarray]:
        """(t, q) of every stream, gathered over the stream group in
        global stream order (a collective: every process calls it)."""
        group = self.mesh.get_group(0)
        out = []
        for x in (poses.t, poses.q):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(group.size())]
            dist.all_gather(parts, x, group=group)
            out.append(torch.cat(parts, dim=x.ndim - 2).cpu().numpy())
        return out[0], out[1]
