"""Unit-quaternion operations on tensors ``[..., 4]`` stored ``(w, x, y, z)``
with the Hamilton product; ``rotate(q, v) == R(q) @ v``.

Port of lvt_tpu/geometry/quaternion.py."""

from __future__ import annotations

import torch


def identity(device=None, dtype=torch.float32) -> torch.Tensor:
    # made on the device: a host-to-device copy would sync the step
    return torch.eye(4, dtype=dtype, device=device)[0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 4] . [..., 4] -> [..., 1], summed left to right on every
    device (a reduction may sum in another order on the card)."""
    p = a * b
    return ((p[..., 0:1] + p[..., 1:2]) + p[..., 2:3]) + p[..., 3:4]


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(_dot(q, q))


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (== conjugate)."""
    return conjugate(q)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (rotation composition: first b then a)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q."""
    w = q[..., :1]
    u = q[..., 1:].expand_as(v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] of a unit quaternion."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from a rotation matrix: branch-free Shepperd-style
    extraction (all four candidates, the best picked by argmax — first
    index on ties, like jnp.argmax), canonical sign w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(cand), 4(wxyz)]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def slerp(a: torch.Tensor, t: float, b: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation from a (t=0) to b (t=1), shortest path,
    nlerp when nearly parallel (Eigen's ``a.slerp(t, b)``)."""
    dot = _dot(a, b)
    b = torch.where(dot < 0, -b, b)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    safe_sin = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    wb = torch.where(near, t, torch.sin(t * theta) / safe_sin)
    return normalize(wa * a + wb * b)


def angle_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) between two unit quaternions."""
    dot = torch.abs(_dot(a, b)[..., 0])
    return 2.0 * torch.arccos(torch.clamp(dot, -1.0, 1.0))
