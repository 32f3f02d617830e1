"""Streaming odometry driver: the integration shell of the reference's ROS
node (lvt/src/lvt_ros.cpp:26-319), without ROS.

Port of lvt_tpu/io/streaming.py on the port's ``VOSystem`` (on
``device``, default ``cuda``). It takes a live stream of time-stamped
stereo (or RGB-D) frames, creates the VO system lazily from the first
camera info, drops stale time stamps, resets the VO on LOST (optionally
zeroing the accumulated odometry), carries each frame's VO delta through
a base <-> sensor extrinsic into an odometry frame, and publishes pose and
twist to callbacks. A background worker thread decouples ingestion from
tracking: frames that arrive while the tracker is busy queue up, and the
freshest frame wins when the queue overflows (the real-time policy of a
live VO node). The quaternion math runs in the port's
``geometry.quaternion`` on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

import torch

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core.system import SensorType, TrackingState, VOSystem
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose

# axis fix rotating camera optical frame (z forward) into robot convention
# (x forward, z up) — the reference's ROT_Z_UP (lvt_ros.cpp:91)
ROT_OPTICAL_TO_ROBOT = np.array([
    [0.0, 0.0, 1.0],
    [-1.0, 0.0, 0.0],
    [0.0, -1.0, 0.0],
])


@dataclasses.dataclass
class Odometry:
    """One odometry output sample (nav_msgs/Odometry equivalent)."""

    stamp: float
    position: np.ndarray          # [3] in the odom frame
    orientation: np.ndarray       # [4] (w, x, y, z)
    linear_velocity: np.ndarray   # [3] m/s in the base frame
    angular_velocity: np.ndarray  # [3] rad/s (axis-angle rate)
    tracking_state: TrackingState
    frame_number: int


def _pose_to_mat(pose: Pose) -> np.ndarray:
    """The 4x4 of a pose on any device, in float64, through one host copy
    (the rotation in float32 on the CPU, as lvt_tpu computes it)."""
    tq = torch.cat([pose.t.reshape(3), pose.q.reshape(4)]).cpu()
    m = np.eye(4)
    m[:3, :3] = quat.to_matrix(tq[3:]).numpy()
    m[:3, 3] = tq[:3].numpy()
    return m


class StreamingVO:
    """Asynchronous streaming front end around VOSystem.

    feed(stamp, img1, img2) never blocks on tracking; on_odometry(cb) emits
    results. reset() mirrors the reference's reset_vo service
    (lvt_ros.cpp:184-198).
    """

    def __init__(
        self,
        config: Optional[VOConfig] = None,
        sensor_type: SensorType = SensorType.STEREO,
        *,
        base_from_sensor: Optional[np.ndarray] = None,  # [4,4] extrinsic
        apply_axis_fix: bool = True,
        reset_pose_on_lost: bool = False,
        queue_size: int = 2,
        device="cuda",
    ):
        self._config = config
        self.device = device
        self.sensor_type = sensor_type
        self._t_bs = np.eye(4) if base_from_sensor is None else base_from_sensor
        if apply_axis_fix:
            fix = np.eye(4)
            fix[:3, :3] = ROT_OPTICAL_TO_ROBOT
            self._t_bs = self._t_bs @ fix
        self.reset_pose_on_lost = reset_pose_on_lost

        self.vo: Optional[VOSystem] = None
        self._callbacks: list[Callable[[Odometry], None]] = []
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._last_stamp = -np.inf
        self._accum = np.eye(4)       # accumulated odometry (base frame)
        self._last_vo_mat = np.eye(4)
        self._last_out_time = None
        self._last_out_pos = None
        self._last_out_q = None
        self._dropped = 0
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        # feed() must never block on tracking (the worker holds _lock for
        # the whole track call), so ingestion has its own lock making the
        # stale-stamp check/update and the evict-then-put atomic under
        # multiple producers
        self._feed_lock = threading.Lock()

    # -- configuration --------------------------------------------------
    def set_camera_info(self, fx, fy, cx, cy, baseline, width, height,
                        **extra) -> None:
        """Lazy config from camera info, like the reference building its
        params from the first CameraInfo message (lvt_ros.cpp:172-182)."""
        base = self._config or VOConfig()
        self._config = base.replace(
            fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
            baseline=float(baseline), img_width=int(width),
            img_height=int(height), **extra,
        )

    def _ensure_vo(self) -> VOSystem:
        if self.vo is None:
            assert self._config is not None and self._config.img_width > 0, (
                "camera not configured: call set_camera_info first"
            )
            self.vo = VOSystem(self._config, self.sensor_type,
                               device=self.device)
        return self.vo

    # -- pub/sub --------------------------------------------------------
    def on_odometry(self, callback: Callable[[Odometry], None]) -> None:
        self._callbacks.append(callback)

    @property
    def dropped_frames(self) -> int:
        return self._dropped

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Start the background tracking worker (async mode)."""
        if self._running:
            return
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        self._running = False
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=10.0)
            self._worker = None

    def reset(self, zero_odometry: bool = False) -> None:
        with self._lock:
            if self.vo is not None:
                self.vo.reset()
            self._last_vo_mat = np.eye(4)
            if zero_odometry:
                self._accum = np.eye(4)

    # -- ingestion ------------------------------------------------------
    def feed(self, stamp: float, img1: np.ndarray, img2: np.ndarray) -> bool:
        """Queue one frame (async). Returns False if dropped (queue full —
        the oldest queued frame is evicted so the freshest frame tracks)."""
        with self._feed_lock:
            if stamp <= self._last_stamp:  # stale-timestamp guard (:226-230)
                self._dropped += 1
                return False
            self._last_stamp = stamp
            item = (stamp, img1, img2)
            if not self._running:
                sync = True
            else:
                sync = False
                try:
                    self._queue.put_nowait(item)
                except queue.Full:
                    try:
                        self._queue.get_nowait()
                        self._dropped += 1
                    except queue.Empty:
                        pass
                    self._queue.put_nowait(item)
        if sync:
            self._process(item)
        return True

    # -- worker ---------------------------------------------------------
    def _run(self) -> None:
        while self._running:
            item = self._queue.get()
            if item is None:
                break
            self._process(item)

    def _process(self, item) -> None:
        stamp, img1, img2 = item
        with self._lock:
            vo = self._ensure_vo()
            pose = vo.track(img1, img2)
            state = vo.get_state()

            # delta in the VO/world frame -> base frame -> accumulate
            vo_mat = _pose_to_mat(pose)
            delta_sensor = np.linalg.inv(self._last_vo_mat) @ vo_mat
            self._last_vo_mat = vo_mat
            delta_base = self._t_bs @ delta_sensor @ np.linalg.inv(self._t_bs)
            self._accum = self._accum @ delta_base

            if state == TrackingState.LOST:
                # auto-reset like the reference (lvt_ros.cpp:241-254)
                vo.reset()
                self._last_vo_mat = np.eye(4)
                if self.reset_pose_on_lost:
                    self._accum = np.eye(4)

            pos = self._accum[:3, 3].copy()
            q = quat.from_matrix(torch.as_tensor(self._accum[:3, :3],
                                                 dtype=torch.float32))
            # twist from finite differences (lvt_ros.cpp:284-299)
            lin = np.zeros(3)
            ang = np.zeros(3)
            if self._last_out_time is not None:
                dt = stamp - self._last_out_time
                if dt > 0:
                    lin = (pos - self._last_out_pos) / dt
                    dq = quat.multiply(
                        q, quat.inverse(self._last_out_q)).numpy()
                    angle = 2.0 * np.arccos(np.clip(abs(dq[0]), -1.0, 1.0))
                    axis = dq[1:]
                    nrm = np.linalg.norm(axis)
                    if nrm > 1e-12:
                        ang = axis / nrm * angle / dt
            self._last_out_time = stamp
            self._last_out_pos = pos
            self._last_out_q = q

            odo = Odometry(
                stamp=stamp, position=pos, orientation=q.numpy(),
                linear_velocity=lin, angular_velocity=ang,
                tracking_state=state, frame_number=vo.frame_number,
            )
        for cb in self._callbacks:
            cb(odo)
