"""2-D ``stream x points`` parallelism: many VO streams, each with a map
sharded over ranks (configs 4 and 5 at once) on ``torch.distributed``.

Port of lvt_tpu/parallel/stream_point.py. On a ``(stream=NS, points=NP)``
mesh (parallel/mesh.py) the rank at (i, j) holds S / NS streams (the i-th
contiguous block) and, of each, the j-th block of M / NP map slots (and of
the staged slots and the BA window's point axis):
:func:`batched_state_specs` gives each leaf's split. Per frame the rank
extracts its streams' 2 S / NS images as one batch (kernels A and P once),
then runs ``torch.func.vmap`` of the sharded step body
(``core/step.py::track_features(group=)``) over its streams, the
collectives over its ``points`` group: under vmap each is one collective of
the batch (ops/collectives.py's batching rule; every rank of a points
group holds the same streams in the same order). The stream axis needs no
collective. A lost stream is reset after its frame inside the chunk, as
lvt_tpu's ``_reset_lost`` does; its status is the same on every rank of
its points group, so they reset alike. The step runs through a runner
(core/graphs.py), which resets the lost streams at the end of the frame
(``tail.reset_lost``): a CUDA graph on an NCCL group, eager on gloo.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.core import step as step_mod
from lvt_tpu_torch.core.state import VOState
from lvt_tpu_torch.device import resolve_device
from lvt_tpu_torch.ops.collectives import axis_index, axis_size, psum_if
from lvt_tpu_torch.parallel import mesh as mesh_mod
from lvt_tpu_torch.parallel import multistream as ms
from lvt_tpu_torch.parallel.sharded_stream import initial_shard, state_specs
from lvt_tpu_torch.tree import tree_map

STREAM_AXIS = mesh_mod.STREAM_AXIS
POINT_AXIS = mesh_mod.POINT_AXIS


def batched_state_specs(stream_axis: str = STREAM_AXIS,
                        point_axis: str = POINT_AXIS) -> VOState:
    """Each leaf's split for a stream-batched state whose stores are also
    sharded over the point axis: [S, N, ...] -> (stream, points, ...)."""
    return tree_map(lambda spec: (stream_axis, *spec), state_specs(point_axis))


def stream_point_step_stereo(states: VOState, imgs_left: torch.Tensor,
                             imgs_right: torch.Tensor, config: VOConfig,
                             group):
    """One frame for this rank's streams ([S_local, H, W] left and right;
    ``states`` their blocks), the maps sharded over ``group`` -> (states,
    poses [S_local], metrics [S_local])."""
    step_mod._check_config(config)
    s = imgs_left.shape[0]
    left, right = ms._split(extract.extract_features_batched(
        torch.cat([imgs_left, imgs_right]), config), s)
    return vmap(lambda st, lf, rf: step_mod.track_features(
        st, lf, rf, config, group))(states, left, right)


def stream_point_chunk_stereo(states: VOState, imgs1: torch.Tensor,
                              imgs2: torch.Tensor, config: VOConfig, group,
                              runners: dict, auto_reset: bool = True):
    """N frames of this rank's streams, imgs [N, S_local, H, W], in order;
    with ``auto_reset`` a lost stream is reset after its frame. Runs
    through the runner in ``runners`` (which writes ``states`` in place);
    returns (states, poses [N, S_local], metrics [N, S_local])."""
    dev = states.status.device
    return step_mod._scan(
        lambda: lambda st, a, b: stream_point_step_stereo(st, a, b, config,
                                                          group),
        states, (imgs1, imgs2), runners, "stereo", group=group,
        batched=True,
        make_reset=(lambda: initial_shard(config, axis_size(group),
                                          device=dev))
        if auto_reset else None)


def _default_mesh(n_streams: int, device_type: str):
    """lvt_tpu's choice: the most stream ranks that divide both the
    streams and the ranks, the rest over points."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 0
    if n == 0:
        raise RuntimeError("no process group: call mesh.init first")
    ns = max(d for d in range(1, n + 1) if n_streams % d == 0 and n % d == 0)
    return mesh_mod.stream_point_mesh(ns, n // ns, device_type=device_type)


class StreamPointVO:
    """Driver for S streams, each with a map sharded over points, on a 2-D
    ``(stream, points)`` mesh. Every rank makes one and is given the whole
    batch's frames ([S, H, W] or [N, S, H, W]); it tracks its own
    streams (``local_streams``) on its block of their maps and returns
    their poses."""

    def __init__(self, config: VOConfig, n_streams: int, mesh=None,
                 auto_reset: bool = True, *, device="cuda"):
        config.validate()
        step_mod._check_config(config)
        self.config = config
        self.n_streams = n_streams
        self.auto_reset = auto_reset
        self.device = resolve_device(device)
        if mesh is None:
            mesh = _default_mesh(n_streams, self.device.type)
        self.mesh = mesh
        stream_group = mesh.get_group(STREAM_AXIS)
        self.group = mesh.get_group(POINT_AXIS)
        ns = axis_size(stream_group)
        if n_streams % ns:
            raise ValueError(f"{n_streams} streams do not divide over {ns} "
                             f"stream ranks")
        per = n_streams // ns
        first = per * axis_index(stream_group)
        self.local_streams = np.arange(first, first + per)
        # static buffers, written in place by the runner and never rebound
        self.states = tree_map(
            lambda x: x[None].expand(per, *x.shape).clone(),
            initial_shard(config, axis_size(self.group), device=self.device))
        self.runners: dict = {}

    def _prep(self, imgs, ndim: int) -> torch.Tensor:
        a = torch.as_tensor(imgs)
        hw = (self.config.img_height, self.config.img_width)
        if a.ndim != ndim or a.shape[-3] != self.n_streams or \
                tuple(a.shape[-2:]) != hw:
            raise ValueError(f"expected {ndim}-d images of [{self.n_streams}, "
                             f"{hw[0]}, {hw[1]}], got {tuple(a.shape)}")
        lo, hi = self.local_streams[0], self.local_streams[-1] + 1
        a = a[..., lo:hi, :, :].to(self.device)
        return a if a.dtype == torch.uint8 else a.float()

    def track(self, imgs_left, imgs_right):
        """One frame of every stream, [S, H, W]; returns (poses
        [S_local], metrics [S_local]) of this rank's streams."""
        poses, metrics = self.track_chunk(
            torch.as_tensor(imgs_left)[None], torch.as_tensor(imgs_right)[None])
        return (tree_map(lambda x: x[0], poses),
                tree_map(lambda x: x[0], metrics))

    def track_chunk(self, imgs1, imgs2):
        """N frames of every stream, [N, S, H, W]; the same result as N
        ``track`` calls. Returns (poses [N, S_local], metrics [N,
        S_local])."""
        a, b = self._prep(imgs1, 4), self._prep(imgs2, 4)
        if a.shape != b.shape:
            raise ValueError(f"right chunk {tuple(b.shape)} != left chunk "
                             f"{tuple(a.shape)}")
        _, poses, metrics = stream_point_chunk_stereo(
            self.states, a, b, self.config, self.group, self.runners,
            auto_reset=self.auto_reset)
        return poses, metrics

    @property
    def status(self) -> np.ndarray:
        """[S_local] tracking state of this rank's streams."""
        return self.states.status.cpu().numpy()

    def map_sizes(self) -> np.ndarray:
        """[S_local] valid map points of this rank's streams, over all
        their point shards (a collective, then a read)."""
        return psum_if(self.states.map.size(), self.group).cpu().numpy()
