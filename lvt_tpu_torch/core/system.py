"""VOSystem: the host-side object around the tracking step.

Port of lvt_tpu/core/system.py (stereo and RGB-D), with its constructor:
``VOSystem(config, sensor_type, metrics_recorder, trace_log, log_dir,
rectify_maps, *, device="cuda")``. The VOState lives on ``device``;
``track`` uploads one frame (a rectified stereo pair, a raw pair when the
system holds ``rectify_maps``, or a gray image and its metric depth) and
returns its pose, ``track_chunk`` runs N frames and returns N poses,
``track_with_external_corners`` tracks a stereo pair at the caller's
corners. Each entry point (stereo, raw stereo with ``rectify_maps``,
RGB-D, external corners) runs its step through its own runner
(core/graphs.py): on the card a CUDA graph of the step, captured at the
entry point's first frame and replayed for every frame, eager under
``graphs.disable_graphs()`` and on the CPU. ``state``'s leaves are the
runners' static buffers: later frames, ``reset`` and ``load_checkpoint``
overwrite them in place, so a caller that keeps a state copies it; every
pose and metric returned (and ``last_pose``) is a copy. Host arrays go
up from pinned memory without blocking the host (``device.upload``), so
a chunk syncs the host only where a caller reads a result. A
``metrics_recorder`` (``observability.ValueRecorder``) gets every
frame's metrics, a chunk's in one transfer; a ``trace_log``
(``observability.TraceLog``, made in ``log_dir`` when
``config.enable_logging`` is set) gets the parameters at creation, a line
per ``track`` call and the resets. With neither, nothing is read back.
Checkpoints are npz files keyed by state path (``.map.pos``, ...), the
same keys and dtypes lvt_tpu writes, so a checkpoint crosses between the
two packages in both directions; lvt_tpu's older positional files
(``arr_0``, ...) load too.
"""

from __future__ import annotations

import enum
from functools import partial
from typing import Optional

import numpy as np
import torch

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch import convert
from lvt_tpu_torch.core import graphs
from lvt_tpu_torch.core import step as step_mod
from lvt_tpu_torch.core.state import StepMetrics, VOState
from lvt_tpu_torch.device import resolve_device, upload
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.tree import flatten_with_path, tree_map, unflatten_like


class SensorType(enum.IntEnum):
    STEREO = 1
    RGBD = 2


class TrackingState(enum.IntEnum):
    NOT_INITIALIZED = 1
    TRACKING = 2
    LOST = 3


class VOSystem:
    """Visual odometry over one camera stream (stereo or RGB-D) on
    ``device``."""

    def __init__(self, config: VOConfig,
                 sensor_type: SensorType = SensorType.STEREO,
                 metrics_recorder=None, trace_log=None, log_dir: str = ".",
                 rectify_maps: tuple | None = None, *, device="cuda"):
        """``rectify_maps``: (left, right) [H, W, 2] source-pixel maps
        (``ops.undistort.make_rectify_map``), stereo only; then raw
        (distorted, unrectified) frames go in and are remapped inside the
        step. The maps are uploaded to ``device`` once."""
        config.validate()
        step_mod._check_config(config)
        self.config = config
        self.sensor_type = SensorType(sensor_type)
        self.device = resolve_device(device)
        self.metrics_recorder = metrics_recorder
        self.rectify_maps = None
        if rectify_maps is not None:
            if self.sensor_type != SensorType.STEREO:
                raise ValueError("rectify_maps: stereo input only")
            hw2 = (config.img_height, config.img_width, 2)
            self.rectify_maps = tuple(
                upload(np.asarray(m, np.float32), self.device)
                for m in rectify_maps)
            if any(tuple(m.shape) != hw2 for m in self.rectify_maps):
                raise ValueError(f"rectify_maps: expected two maps of {hw2}")
        # the reference's LVT_ENABLE_LOG wiring (lvt_system.cpp:106-116):
        # a trace log made when config.enable_logging is set (or given),
        # the parameters dumped at creation
        if trace_log is None and config.enable_logging:
            from lvt_tpu_torch.observability import TraceLog

            trace_log = TraceLog(out_dir=log_dir)
        self.trace_log = trace_log
        if self.trace_log is not None:
            self.trace_log.log_params(config)
        # static buffers, written in place by the runners and never rebound
        self.state = self._initial_state()
        self.runners: dict = {}
        self.last_metrics: Optional[StepMetrics] = None

    @staticmethod
    def create(config: VOConfig, sensor_type: SensorType = SensorType.STEREO,
               **kw) -> "VOSystem":
        return VOSystem(config, sensor_type, **kw)

    def _initial_state(self) -> VOState:
        return VOState.initial(
            self.config.max_map_points, self.config.max_staged_points,
            self.config.local_ba_window, device=self.device)

    def reset(self) -> None:
        """Clear map, motion model and state machine."""
        graphs.copy_into(self.state, self._initial_state())
        self.last_metrics = None
        if self.metrics_recorder is not None:
            self.metrics_recorder.reset()
        if self.trace_log is not None:
            self.trace_log.log("VO was just reset.")

    # -- introspection (each reads one scalar back from the device)
    def get_state(self) -> TrackingState:
        return TrackingState(int(self.state.status))

    @property
    def frame_number(self) -> int:
        return int(self.state.frame_number)

    @property
    def map_size(self) -> int:
        return int(self.state.map.size())

    @property
    def last_pose(self) -> Pose:
        """The pose of the last tracked frame (camera in world), on the
        device: a copy, which later frames leave as it is."""
        return tree_map(torch.clone, self.state.pose)

    # -- tracking
    def _prep(self, img, ndim: int) -> torch.Tensor:
        a = upload(img, self.device)
        hw = (self.config.img_height, self.config.img_width)
        if a.ndim != ndim or tuple(a.shape[-2:]) != hw:
            raise ValueError(f"expected {ndim}-d grayscale image(s) of {hw}, "
                             f"got {tuple(a.shape)}")
        # uint8 uploads 4x less than f32 and kernel A widens on the card
        return a if a.dtype == torch.uint8 else a.float()

    def _prep2(self, img, ndim: int) -> torch.Tensor:
        """The second input: the right image, or the metric depth (float32)
        for RGB-D."""
        if self.sensor_type == SensorType.STEREO:
            return self._prep(img, ndim)
        return self._prep(torch.as_tensor(img, dtype=torch.float32), ndim)

    def _finish(self, pose: Pose, metrics: StepMetrics) -> Pose:
        """One frame's pose, after its metrics went to the recorder and its
        line to the trace log (the reference's per-frame logs,
        lvt_system.cpp:159,174,258,265; one read of six scalars)."""
        self.last_metrics = metrics
        if self.metrics_recorder is not None:
            self.metrics_recorder.record_step(metrics)
        if self.trace_log is not None:
            frame, status, matches, inliers, size, kps = torch.stack([
                self.state.frame_number, self.state.status,
                metrics.tracked_map_points, metrics.inlier_count,
                metrics.map_points_count, metrics.image_keypoints,
            ]).tolist()
            self.trace_log.log(
                f"Frame #{frame}: status={TrackingState(status).name} "
                f"matches={matches} inliers={inliers} map={size} "
                f"keypoints={kps}")
        return pose

    def track(self, img1, img2) -> Pose:
        """One frame, a chunk of one. Stereo: grayscale (left, right), raw
        if the system holds ``rectify_maps``, rectified otherwise; RGB-D:
        (gray, metric depth)."""
        poses, metrics = self._track_chunk(self._prep(img1, 2)[None],
                                           self._prep2(img2, 2)[None])
        first = lambda x: x[0]  # noqa: E731
        return self._finish(tree_map(first, poses), tree_map(first, metrics))

    def track_chunk(self, imgs1, imgs2):
        """N frames, same result as N ``track`` calls; returns (poses,
        metrics) with a leading N axis. The recorder, if any, reads the
        chunk's metrics in one transfer."""
        poses, metrics = self._track_chunk(imgs1, imgs2)
        if self.metrics_recorder is not None:
            self.metrics_recorder.record_chunk(metrics)
        return poses, metrics

    def _track_chunk(self, imgs1, imgs2):
        a = self._prep(imgs1, 3)
        b = self._prep2(imgs2, 3)
        if a.shape != b.shape:
            raise ValueError(f"second-input chunk {tuple(b.shape)} != image "
                             f"chunk {tuple(a.shape)}")
        if self.sensor_type == SensorType.RGBD:
            out = step_mod.track_chunk_rgbd(self.state, a, b, self.config,
                                            self.runners)
        elif self.rectify_maps is not None:
            out = step_mod.track_chunk_stereo_rectified(
                self.state, a, b, *self.rectify_maps, self.config,
                self.runners)
        else:
            out = step_mod.track_chunk_stereo(self.state, a, b, self.config,
                                              self.runners)
        _, poses, metrics = out
        self.last_metrics = tree_map(lambda x: x[-1], metrics)
        return poses, metrics

    def track_with_external_corners(self, left_image, right_image,
                                    corners_left, corners_right) -> Pose:
        """One stereo frame (rectified grayscale) described at the caller's
        corners, [N, 2] (x, y) per image, N free per call: padded on the
        host to kp_capacity (corners past it are dropped), uploaded with
        their validity as one array, then tracked (the step unpacks it: a
        call launches the upload and the runner's chunk of one frame)."""
        if self.sensor_type != SensorType.STEREO:
            raise ValueError("track_with_external_corners: stereo input only")
        cap = self.config.kp_capacity
        packed = np.zeros((2, cap, 3), np.float32)   # x, y, valid
        for side, c in enumerate((corners_left, corners_right)):
            c = np.asarray(c, np.float32).reshape(-1, 2)[:cap]
            packed[side, :len(c), :2] = c
            packed[side, :len(c), 2] = 1.0
        frame = (self._prep(left_image, 2), self._prep(right_image, 2),
                 upload(packed, self.device))
        config = self.config
        _, poses, metrics = step_mod._scan(
            lambda: partial(step_mod.track_step_packed_corners,
                            config=config),
            self.state, tuple(x[None] for x in frame), self.runners,
            "corners")
        first = lambda x: x[0]  # noqa: E731
        return self._finish(tree_map(first, poses), tree_map(first, metrics))

    # -- checkpoint / resume
    def save_checkpoint(self, path: str) -> None:
        arrays = dict(flatten_with_path(convert.to_numpy(self.state)))
        np.savez(path, _sensor=np.int64(int(self.sensor_type)), **arrays)

    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint of either package; its shapes (map and staged
        capacity, BA window) must be this system's config's. A file without
        path keys is lvt_tpu's older positional format (``arr_0``,
        ``arr_1``, ... as ``np.savez`` names its arguments), read in the
        file's order as lvt_tpu's leaf order, which is the port's path
        order."""
        data = np.load(path)
        flat = flatten_with_path(self.state)
        named = [k for k in data.files if not k.startswith("_")]
        if not any(k.startswith(".") for k in named):
            if len(named) != len(flat):
                raise ValueError(f"positional checkpoint has {len(named)} "
                                 f"arrays, the state {len(flat)} leaves")
            data = {key: data[k] for (key, _), k in zip(flat, named)}
        leaves = {}
        for key, leaf in flat:
            leaves[key] = data[key]
            if leaves[key].shape != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {key} has shape {leaves[key].shape}, this "
                    f"config needs {tuple(leaf.shape)}")
        graphs.copy_into(self.state, convert.to_port(
            unflatten_like(self.state, leaves), self.device))

