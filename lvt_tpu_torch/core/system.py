"""VOSystem: the host-side object around the tracking step.

Port of lvt_tpu/core/system.py (stereo and RGB-D). The VOState lives on
``device`` (default ``cuda``); ``track`` uploads one frame (a rectified
stereo pair, or a gray image and its metric depth) and returns its pose,
``track_chunk`` runs N frames and returns N poses. Checkpoints are npz
files keyed by state path (``.map.pos``, ...), the same keys and dtypes
lvt_tpu writes, so a checkpoint crosses between the two packages in both
directions.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch import convert
from lvt_tpu_torch.core import step as step_mod
from lvt_tpu_torch.core.state import StepMetrics, VOState
from lvt_tpu_torch.device import resolve_device
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
                 sensor_type: SensorType = SensorType.STEREO, *,
                 device="cuda"):
        config.validate()
        step_mod._check_config(config)
        self.config = config
        self.sensor_type = SensorType(sensor_type)
        self.device = resolve_device(device)
        self.last_metrics: Optional[StepMetrics] = None
        self.reset()

    @staticmethod
    def create(config: VOConfig, sensor_type: SensorType = SensorType.STEREO,
               *, device="cuda") -> "VOSystem":
        return VOSystem(config, sensor_type, device=device)

    def reset(self) -> None:
        """Clear map, motion model and state machine."""
        self.state = VOState.initial(
            self.config.max_map_points, self.config.max_staged_points,
            self.config.local_ba_window, device=self.device)
        self.last_metrics = None

    # -- introspection (each reads one scalar back from the device)
    def get_state(self) -> TrackingState:
        return TrackingState(int(self.state.status))

    @property
    def frame_number(self) -> int:
        return int(self.state.frame_number)

    @property
    def map_size(self) -> int:
        return int(self.state.map.size())

    # -- tracking
    def _prep(self, img, ndim: int) -> torch.Tensor:
        a = torch.as_tensor(img).to(self.device)
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

    def track(self, img1, img2) -> Pose:
        """One frame, a chunk of one. Stereo: rectified grayscale (left,
        right); RGB-D: (gray, metric depth)."""
        poses, _ = self.track_chunk(self._prep(img1, 2)[None],
                                    self._prep2(img2, 2)[None])
        return tree_map(lambda x: x[0], poses)

    def track_chunk(self, imgs1, imgs2):
        """N frames, same result as N ``track`` calls; returns (poses,
        metrics) with a leading N axis."""
        a = self._prep(imgs1, 3)
        b = self._prep2(imgs2, 3)
        if a.shape != b.shape:
            raise ValueError(f"second-input chunk {tuple(b.shape)} != image "
                             f"chunk {tuple(a.shape)}")
        chunk = (step_mod.track_chunk_stereo
                 if self.sensor_type == SensorType.STEREO
                 else step_mod.track_chunk_rgbd)
        self.state, poses, metrics = chunk(self.state, a, b, self.config)
        self.last_metrics = tree_map(lambda x: x[-1], metrics)
        return poses, metrics

    # -- checkpoint / resume
    def save_checkpoint(self, path: str) -> None:
        arrays = dict(flatten_with_path(convert.to_numpy(self.state)))
        np.savez(path, _sensor=np.int64(int(self.sensor_type)), **arrays)

    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint of either package; its shapes (map and staged
        capacity, BA window) must be this system's config's."""
        data = np.load(path)
        leaves = {}
        for key, leaf in flatten_with_path(self.state):
            leaves[key] = data[key]
            if leaves[key].shape != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {key} has shape {leaves[key].shape}, this "
                    f"config needs {tuple(leaf.shape)}")
        self.state = convert.to_port(unflatten_like(self.state, leaves),
                                     self.device)

