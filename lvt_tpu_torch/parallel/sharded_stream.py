"""Sharded-map single-stream tracking (BASELINE config 5) on
``torch.distributed``.

Port of lvt_tpu/parallel/sharded_stream.py. One camera stream whose local
map is spread over the ranks of a ``points`` mesh (parallel/mesh.py): each
rank (process) holds a block of ``max_map_points / n`` map slots and of
``max_staged_points / n`` staged slots, and the BA observation window's
point axis split the same way (:func:`state_specs`); the frames, the
features and the pose state are the same on every rank. Every rank
extracts the frame's features itself (kernels A and P), as lvt_tpu's
extraction runs outside its ``shard_map``, then runs the step on its
blocks with the ``points`` group (``core/step.py::track_features(group=)``):

* per-map-point work (projection, visibility, kernel T at the block's
  rows, counters, insert and cull) is local to the rank;
* the cross-shard quantities reduce over the group: match counts and map
  sizes with ``psum``, the one-to-one match claims with ``pmin`` over a
  (distance, global index) key, the PnP and windowed-BA sums in float64
  before their one rounding;
* new triangulations are partitioned across the ranks by valid rank.

This computes the same map set and the same trajectory as the unsharded
step, up to the order of the sums (slot layout differs, and float sums
over the points run in another order), as lvt_tpu says of its own.
Caveat at capacity, as in lvt_tpu: insertions partition across the ranks
by valid-candidate rank, so once one rank's block fills, its share of the
new points drops even if another rank still has free slots, whereas the
unsharded map fills any free slot. Size the per-rank capacity with the
headroom one device would need.

The step, collectives included, runs through a runner (core/graphs.py):
on an NCCL group one CUDA graph captured at the first frame and replayed
per frame, on gloo eagerly (gloo synchronises the host in its own
threads).
"""

from __future__ import annotations

from functools import partial

import torch

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core import extract
from lvt_tpu_torch.core import step as step_mod
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.core.state import ObsWindow, PointStore, VOState
from lvt_tpu_torch.device import resolve_device, upload
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops.collectives import axis_size, psum_if
from lvt_tpu_torch.parallel import mesh as mesh_mod
from lvt_tpu_torch.tree import tree_map

POINT_AXIS = mesh_mod.POINT_AXIS


def _store_specs(axis: str) -> PointStore:
    return PointStore(*(((axis,),) * len(PointStore._fields)))


def state_specs(axis: str = POINT_AXIS) -> VOState:
    """Each VOState leaf's split, as lvt_tpu's PartitionSpecs: a tuple with
    the mesh axis that splits each leading dimension (None: not split);
    ``()`` is the same on every rank."""
    rep = ()
    win = (None, axis)
    return VOState(
        map=_store_specs(axis), staged=_store_specs(axis),
        pose=Pose(rep, rep), motion=MotionState(rep, rep, rep, rep),
        last_matches=rep, frame_number=rep, status=rep,
        ba=ObsWindow(poses_t=rep, poses_q=rep, obs=win, w=win, obs_r=win,
                     w_r=win, n=rep))


def initial_shard(config: VOConfig, n: int, *, device) -> VOState:
    """One rank's block of the initial state of a map sharded over ``n``
    ranks (every rank's is the same); each capacity must divide evenly."""
    if config.max_map_points % n or config.max_staged_points % n:
        raise ValueError(f"max_map_points {config.max_map_points} and "
                         f"max_staged_points {config.max_staged_points} must "
                         f"divide evenly over {n} point shards")
    return VOState.initial(config.max_map_points // n,
                           config.max_staged_points // n,
                           config.local_ba_window, device=device)


def track_step_stereo_sharded(state: VOState, img_left: torch.Tensor,
                              img_right: torch.Tensor, config: VOConfig,
                              group):
    """One stereo frame with the map sharded over ``group``: extraction on
    this rank, then the step on its blocks -> (state, pose, metrics)."""
    left, right = extract.extract_features_stereo(img_left, img_right, config)
    return step_mod.track_features(state, left, right, config, group)


def track_chunk_stereo_sharded(state: VOState, imgs_left: torch.Tensor,
                               imgs_right: torch.Tensor, config: VOConfig,
                               group, runners: dict):
    """N frames in order, the map sharded over ``group``, through the
    runner in ``runners`` (which writes ``state`` in place); returns
    (state, poses [N], metrics [N])."""
    return step_mod._scan(
        lambda: partial(track_step_stereo_sharded, config=config,
                        group=group),
        state, (imgs_left, imgs_right), runners, "stereo", group=group)


class ShardedStreamVO:
    """Driver for one VO stream whose map is sharded over the ranks of a
    ``points`` mesh (config 5). Every rank makes one, with the same frames;
    each holds its blocks in ``state``. ``mesh`` None: a 1-D mesh named
    ``axis`` over all ranks of the process group (which must exist: a
    group that cannot be made raises, it never runs unsharded)."""

    def __init__(self, config: VOConfig, mesh=None, axis: str = POINT_AXIS,
                 *, device="cuda"):
        config.validate()
        step_mod._check_config(config)
        self.config = config
        self.axis = axis
        self.device = resolve_device(device)
        if mesh is None:
            mesh = mesh_mod.mesh_1d(axis, device_type=self.device.type)
        self.mesh = mesh
        self.group = mesh.get_group(axis)
        self.n_shards = axis_size(self.group)
        # static buffers, written in place by the runner and never rebound
        self.state = initial_shard(config, self.n_shards, device=self.device)
        self.runners: dict = {}
        self.last_metrics = None

    def _prep(self, img, ndim: int) -> torch.Tensor:
        a = upload(img, self.device)
        hw = (self.config.img_height, self.config.img_width)
        if a.ndim != ndim or tuple(a.shape[-2:]) != hw:
            raise ValueError(f"expected {ndim}-d grayscale image(s) of {hw}, "
                             f"got {tuple(a.shape)}")
        return a if a.dtype == torch.uint8 else a.float()

    def track(self, img_left, img_right) -> Pose:
        """One stereo frame (the same on every rank); returns its pose."""
        poses, metrics = self.track_chunk(self._prep(img_left, 2)[None],
                                          self._prep(img_right, 2)[None])
        self.last_metrics = tree_map(lambda x: x[0], metrics)
        return tree_map(lambda x: x[0], poses)

    def track_chunk(self, imgs_left, imgs_right):
        """N frames; the same result as N ``track`` calls. Returns (poses
        [N], metrics [N]), the same on every rank."""
        a, b = self._prep(imgs_left, 3), self._prep(imgs_right, 3)
        if a.shape != b.shape:
            raise ValueError(f"right chunk {tuple(b.shape)} != left chunk "
                             f"{tuple(a.shape)}")
        _, poses, metrics = track_chunk_stereo_sharded(
            self.state, a, b, self.config, self.group, self.runners)
        self.last_metrics = tree_map(lambda x: x[-1], metrics)
        return poses, metrics

    @property
    def map_size(self) -> int:
        """Valid map points over all ranks (a collective, then a read)."""
        return int(psum_if(self.state.map.size(), self.group))

    @property
    def local_map_size(self) -> int:
        """Valid map points in this rank's block."""
        return int(self.state.map.size())

    @property
    def status(self) -> int:
        return int(self.state.status)
