"""VO state containers: fixed-capacity point stores and the full VOState.

Port of lvt_tpu/core/state.py, field by field, as NamedTuples of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.config import MATCHES_WINDOW_INIT
from lvt_tpu_torch.core.features import DESC_WORDS
from lvt_tpu_torch.core.motion import MotionState
from lvt_tpu_torch.device import DESC_DTYPE
from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose

# tracking-state machine values (reference lvt_system.h:45-50)
NOT_INITIALIZED = 1
TRACKING = 2
LOST = 3

N_MATCHES_WINDOW = 3


class PointStore(NamedTuple):
    """Fixed-capacity SoA of 3D points (map and staged sets). ``counter``
    is failed-to-track frames for map points and tracked frames for
    staged points."""

    pos: torch.Tensor      # [N, 3] float32 world position
    desc: torch.Tensor     # [N, DESC_WORDS] int32 BRIEF descriptor
    counter: torch.Tensor  # [N] int32
    age: torch.Tensor      # [N] int32 frames tracked
    valid: torch.Tensor    # [N] bool

    def size(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)

    @staticmethod
    def empty(capacity: int, device=None) -> "PointStore":
        return PointStore(
            pos=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            desc=torch.zeros((capacity, DESC_WORDS), dtype=DESC_DTYPE,
                             device=device),
            counter=torch.zeros((capacity,), dtype=torch.int32, device=device),
            age=torch.zeros((capacity,), dtype=torch.int32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class ObsWindow(NamedTuple):
    """Sliding observation window of local BA, F = config.local_ba_window
    frames (zero-sized with BA off). The frame axis is oldest-first; the
    point axis is the map's slot index, so a slot's history is dropped
    when the slot is culled or recycled."""

    poses_t: torch.Tensor  # [F, 3]
    poses_q: torch.Tensor  # [F, 4]
    obs: torch.Tensor      # [F, M, 2] left-camera pixel observations
    w: torch.Tensor        # [F, M] observation validity 0/1
    obs_r: torch.Tensor    # [F, M, 2] right-camera pixel observations
    w_r: torch.Tensor      # [F, M] right validity
    n: torch.Tensor        # [] int32 frames accumulated (saturates at F)

    @staticmethod
    def empty(window: int, capacity: int, device=None) -> "ObsWindow":
        f32 = dict(dtype=torch.float32, device=device)
        return ObsWindow(
            poses_t=torch.zeros((window, 3), **f32),
            poses_q=quat.identity(device)[None].repeat(window, 1),
            obs=torch.zeros((window, capacity, 2), **f32),
            w=torch.zeros((window, capacity), **f32),
            obs_r=torch.zeros((window, capacity, 2), **f32),
            w_r=torch.zeros((window, capacity), **f32),
            n=torch.zeros((), dtype=torch.int32, device=device),
        )


class VOState(NamedTuple):
    map: PointStore
    staged: PointStore
    pose: Pose                   # last successfully tracked pose
    motion: MotionState
    last_matches: torch.Tensor   # [3] float32, oldest-first match counts
    frame_number: torch.Tensor   # [] int32
    status: torch.Tensor         # [] int32 (NOT_INITIALIZED/TRACKING/LOST)
    ba: ObsWindow                # local-BA window ([0]-sized with BA off)

    @staticmethod
    def initial(max_map_points: int, max_staged_points: int,
                ba_window: int = 0, *, device) -> "VOState":
        return VOState(
            map=PointStore.empty(max_map_points, device),
            staged=PointStore.empty(max_staged_points, device),
            pose=Pose.identity(device),
            motion=MotionState.initial(device),
            last_matches=torch.full((N_MATCHES_WINDOW,), MATCHES_WINDOW_INIT,
                                    dtype=torch.float32, device=device),
            frame_number=torch.zeros((), dtype=torch.int32, device=device),
            status=torch.full((), NOT_INITIALIZED, dtype=torch.int32,
                              device=device),
            ba=ObsWindow.empty(ba_window, max_map_points, device),
        )


class StepMetrics(NamedTuple):
    """Per-frame observability (the reference's recorded series, with
    per-point series aggregated to means). ``local_ba_ran``, which lvt_tpu
    does not record, says whether local BA refined the map this frame."""

    map_points_count: torch.Tensor
    staged_points_count: torch.Tensor
    image_keypoints: torch.Tensor
    tracked_map_points: torch.Tensor
    mean_age: torch.Tensor
    mean_closest_descriptor_distance: torch.Tensor
    mean_second_descriptor_distance: torch.Tensor
    mean_feature_x: torch.Tensor
    mean_feature_y: torch.Tensor
    inlier_count: torch.Tensor
    triangulated_points: torch.Tensor
    used_wide_radius: torch.Tensor
    status: torch.Tensor
    local_ba_ran: torch.Tensor

    @staticmethod
    def zero(device=None) -> "StepMetrics":
        z = torch.zeros((), dtype=torch.int32, device=device)
        f = torch.zeros((), dtype=torch.float32, device=device)
        no = torch.zeros((), dtype=torch.bool, device=device)
        return StepMetrics(z, z, z, z, f, f, f, f, f, z, z, no, z, no)
