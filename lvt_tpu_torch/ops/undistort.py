"""Lens distortion of RGB-D keypoints, the undistorted image bounds, and
the stereo rectification remap of raw (EuRoC) frames.

Port of lvt_tpu/ops/undistort.py: the radial-tangential (Brown-Conrady)
model with (k1, k2, p1, p2, k3), inverted by 8 fixed-point iterations as
OpenCV does; ``make_rectify_map`` (cv::initUndistortRectifyMap, on the
host) and ``remap_bilinear`` (cv::remap with a border clamp), which
lvt_tpu runs as XLA ops, not as a Pallas kernel, and the port as plain
tensor ops.
"""

from __future__ import annotations

import functools

import numpy as np
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


def make_rectify_map(width: int, height: int, k_mat: np.ndarray,
                     dist: np.ndarray, r_rect: np.ndarray,
                     p_new: np.ndarray) -> np.ndarray:
    """The (x, y) source pixel of every rectified pixel, [H, W, 2] float32,
    for :func:`remap_bilinear` (cv::initUndistortRectifyMap): unproject
    through ``p_new`` in float64, rotate by ``r_rect``'s inverse, distort
    with ``dist`` = (k1, k2, p1, p2, k3) in float32 on the CPU (op by op, as
    lvt_tpu's eager JAX call does), project through ``k_mat``."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    ones = np.ones_like(xs)
    pix = np.stack([xs, ys, ones], axis=-1).astype(np.float64)  # [H, W, 3]
    rays = pix @ np.linalg.inv(p_new).T      # normalized, rectified frame
    rays = rays @ np.linalg.inv(r_rect).T
    xy = rays[..., :2] / rays[..., 2:3]
    xyd = distort_normalized(
        torch.from_numpy(xy.astype(np.float32)), float(dist[0]),
        float(dist[1]), float(dist[2]), float(dist[3]),
        float(dist[4])).numpy()
    u = xyd[..., 0] * k_mat[0, 0] + k_mat[0, 2]
    v = xyd[..., 1] * k_mat[1, 1] + k_mat[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img [..., H, W] at src_map [..., H, W, 2] (x, y)
    -> float32 [..., H, W]; any leading axes (a stereo pair as one batch)
    must match. Reads outside the image clamp to the border. The float32
    operations are lvt_tpu's, with the roundings its XLA fusion on the CPU
    gives them (ROADMAP H6): each row's ``i0 * (1 - fx) + i1 * fx`` adds
    the second product with one rounding, and the column's ``top * (1 -
    fy) + bot * fy`` the first; :func:`_fma` emulates those fused
    multiply-adds, so the port remaps bit for bit as lvt_tpu does, on the
    CPU and on the card."""
    h, w = img.shape[-2:]
    flat = img.float().reshape(*img.shape[:-2], h * w)
    x, y = src_map[..., 0], src_map[..., 1]
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    i00 = (y0 * w + x0).long()

    def at(offset):
        idx = (i00 + offset).reshape(*i00.shape[:-2], h * w)
        return torch.gather(flat, -1, idx).reshape(i00.shape)

    top = _fma(at(1), fx, at(0) * (1 - fx))
    bot = _fma(at(w + 1), fx, at(w) * (1 - fx))
    return _fma(top, 1 - fy, bot * fy)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, emulated in float64, where the
    product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()
