"""Constant-velocity motion model. Port of lvt_tpu/core/motion.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.geometry import quaternion as quat
from lvt_tpu_torch.geometry.se3 import Pose


class MotionState(NamedTuple):
    last_q: torch.Tensor            # [4]
    last_position: torch.Tensor     # [3]
    linear_velocity: torch.Tensor   # [3]
    angular_velocity: torch.Tensor  # [4] quaternion per-frame increment

    @staticmethod
    def initial(device=None, dtype=torch.float32) -> "MotionState":
        return MotionState(
            last_q=quat.identity(device, dtype),
            last_position=torch.zeros(3, dtype=dtype, device=device),
            linear_velocity=torch.zeros(3, dtype=dtype, device=device),
            angular_velocity=quat.identity(device, dtype),
        )


def predict_next_pose(state: MotionState,
                      current: Pose) -> tuple[MotionState, Pose]:
    """Update velocities from ``current`` and integrate one step ahead."""
    new_lin = (current.t - state.last_position + state.linear_velocity) * 0.5

    ang_diff = quat.multiply(current.q, quat.inverse(state.last_q))
    new_ang = quat.normalize(quat.slerp(ang_diff, 0.5, state.angular_velocity))

    predicted = Pose(
        t=current.t + new_lin,
        q=quat.normalize(quat.multiply(current.q, new_ang)),
    )
    next_state = MotionState(
        last_q=current.q,
        last_position=current.t,
        linear_velocity=new_lin,
        angular_velocity=new_ang,
    )
    return next_state, predicted
