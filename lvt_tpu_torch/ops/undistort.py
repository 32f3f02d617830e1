"""Lens distortion of RGB-D keypoints and the undistorted image bounds.

Port of lvt_tpu/ops/undistort.py (``distort_normalized``,
``undistort_normalized``, ``undistort_points``,
``undistorted_image_bounds``): the radial-tangential (Brown-Conrady) model
with (k1, k2, p1, p2, k3), inverted by 8 fixed-point iterations as OpenCV
does. The rectification remap of EuRoC input is not ported (ROADMAP Queue
1 item 12).
"""

from __future__ import annotations

import functools

import torch

from lvt_tpu_torch.device import scalar


def distort_normalized(xy: torch.Tensor, k1, k2, p1, p2, k3) -> torch.Tensor:
    """Apply the distortion model to normalized coords [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_dist: torch.Tensor, k1, k2, p1, p2, k3,
                         iters: int = 8) -> torch.Tensor:
    """Invert the distortion by fixed-point iteration (OpenCV-style)."""
    x0, y0 = xy_dist[..., 0], xy_dist[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def undistort_points(pts: torch.Tensor, fx, fy, cx, cy, k1, k2, p1, p2,
                     k3) -> torch.Tensor:
    """Pixel -> undistorted pixel (same intrinsics), batched [..., 2]. The
    divisions by fx and fy go through ``device.scalar`` so the card and
    the CPU round alike."""
    xn = (pts[..., 0] - cx) / scalar(fx, pts)
    yn = (pts[..., 1] - cy) / scalar(fy, pts)
    und = undistort_normalized(torch.stack([xn, yn], -1), k1, k2, p1, p2, k3)
    return torch.stack([und[..., 0] * fx + cx, und[..., 1] * fy + cy], dim=-1)


@functools.lru_cache(maxsize=None)
def undistorted_image_bounds(width: int, height: int, fx, fy, cx, cy, k1, k2,
                             p1, p2, k3) -> tuple[float, float, float, float]:
    """(min_x, max_x, min_y, max_y) from the four undistorted image corners
    (the reference's local-map constructor). Computed once per camera on
    the host's CPU in float32, as plain floats: the step embeds them as
    constants, never as a per-frame reduction on the device."""
    if abs(k1) < 1e-5:
        return 0.0, float(width), 0.0, float(height)
    corners = torch.tensor([[0.0, 0.0], [width, 0.0], [0.0, height],
                            [width, height]], dtype=torch.float32)
    und = undistort_points(corners, fx, fy, cx, cy, k1, k2, p1, p2,
                           k3).tolist()
    return (min(und[0][0], und[2][0]), max(und[1][0], und[3][0]),
            min(und[0][1], und[1][1]), max(und[2][1], und[3][1]))
