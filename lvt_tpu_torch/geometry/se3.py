"""SE(3) poses and camera-projection helpers on tensors.

Port of lvt_tpu/geometry/se3.py: a pose is ``(t[3], q[4])``, the
camera-in-world transform ``x_world = R(q) @ x_cam + t``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.geometry import quaternion as quat


class Pose(NamedTuple):
    """Camera pose in world frame: x_world = R(q) @ x_cam + t."""

    t: torch.Tensor  # [..., 3] position
    q: torch.Tensor  # [..., 4] orientation (w, x, y, z), unit

    @staticmethod
    def identity(device=None, dtype=torch.float32) -> "Pose":
        return Pose(torch.zeros(3, dtype=dtype, device=device),
                    quat.identity(device, dtype))

    def rotation_matrix(self) -> torch.Tensor:
        return quat.to_matrix(self.q)

    def matrix34(self) -> torch.Tensor:
        """Camera-to-world [R | t] (3x4)."""
        return torch.cat([self.rotation_matrix(), self.t[..., :, None]], dim=-1)

    def matrix44(self) -> torch.Tensor:
        """Camera-to-world homogeneous transform (4x4)."""
        m34 = self.matrix34()
        bottom = torch.zeros_like(m34[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([m34, bottom], dim=-2)

    @staticmethod
    def from_matrix44(m: torch.Tensor) -> "Pose":
        return Pose(m[..., :3, 3], quat.from_matrix(m[..., :3, :3]))

    def compose(self, other: "Pose") -> "Pose":
        """Composition self * other (apply other first, then self)."""
        return Pose(
            quat.rotate(self.q, other.t) + self.t,
            quat.normalize(quat.multiply(self.q, other.q)),
        )

    def inverse(self) -> "Pose":
        qi = quat.inverse(self.q)
        return Pose(-quat.rotate(qi, self.t), qi)


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [..., 3, 3] @ v [..., 3] (leading dims broadcast) as three
    products and two sums in a fixed order, so the card and the CPU give
    the same bits (a matmul may sum in another order on each)."""
    return (v[..., 0:1] * m[..., 0] + v[..., 1:2] * m[..., 1]
            + v[..., 2:3] * m[..., 2])


def world_to_camera(pose: Pose) -> torch.Tensor:
    """World->camera transform [R^T | -R^T t] (3x4)."""
    r_wc = quat.to_matrix(pose.q).T
    t_wc = -matvec(r_wc, pose.t)
    return torch.cat([r_wc, t_wc[:, None]], dim=-1)


def transform_points(m34: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [3x4] affine transform to points [..., 3]."""
    return matvec(m34[:, :3], pts) + m34[:, 3]


def project_points(pts_cam: torch.Tensor, fx, fy, cx, cy,
                   eps: float = 1e-12) -> torch.Tensor:
    """Pinhole projection of camera-frame points [..., 3] -> pixels [..., 2]."""
    z = pts_cam[..., 2]
    guard = torch.where(z < 0, -eps, eps)
    inv_z = 1.0 / torch.where(torch.abs(z) < eps, guard, z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def visibility_mask(pts_cam, uv, near, far, min_x, max_x, min_y, max_y):
    """Frustum + image-bounds check (the reference's is_point_visible)."""
    z = pts_cam[..., 2]
    ok_z = (z >= near) & (z <= far)
    u, v = uv[..., 0], uv[..., 1]
    ok_uv = (u >= min_x) & (u <= max_x) & (v >= min_y) & (v <= max_y)
    return ok_z & ok_uv
