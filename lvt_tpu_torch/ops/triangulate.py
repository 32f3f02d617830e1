"""Batched stereo triangulation (left-camera frame, closed-form 3x3 normal
equations) with the reference's visibility and chi-square gating.

Port of lvt_tpu/ops/triangulate.py (``triangulate_stereo``, and
``backproject_rgbd`` for the RGB-D sensor).

The normal equations are ill-conditioned for distant points: their
determinant is 2 (x1 - x2)^2 + 2 (y1 - y2)^2 left over from terms near 4,
so at a few pixels of disparity f32 keeps only three or four digits of it.
Every summation order then gives another far point. The three small
contractions here therefore accumulate as XLA's CPU dot does, a chain of
fused multiply-adds (:func:`_fma_chain`), so the port triangulates
the same points as lvt_tpu, and the card the same as the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.device import scalar
from lvt_tpu_torch.geometry import se3


class TriangulationResult(NamedTuple):
    points_cam: torch.Tensor    # [N, 3] left-camera frame
    points_world: torch.Tensor  # [N, 3]
    valid: torch.Tensor         # [N] bool


def _fma_chain(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """sum_i xs[i] * ys[i] over the leading axis, each product added to the
    running f32 sum with one rounding (a fused multiply-add), in index
    order. Emulated in float64, where the product of two f32 values is
    exact; the sum is rounded back to f32 after every step."""
    prods = xs.double() * ys.double()
    acc = prods[0].float()
    for p in prods[1:]:
        acc = (acc.double() + p).float()
    return acc


def _solve33(m: torch.Tensor, b: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Batched 3x3 solve via the adjugate."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], dim=-2)
    x = _fma_chain(adj.movedim(-1, 0), b.movedim(-1, 0)[..., None])
    return x * inv_det[..., None]


def triangulate_stereo(
    uv_left: torch.Tensor, uv_right: torch.Tensor, pair_valid: torch.Tensor,
    pose: se3.Pose, *, fx, fy, cx, cy, baseline,
    near, far, min_x, max_x, min_y, max_y, reprojection_th2,
) -> TriangulationResult:
    """Linear-LS two-view triangulation; P_L = [I | 0], P_R = [I | (-b, 0, 0)]."""
    fx_, fy_ = scalar(fx, uv_left), scalar(fy, uv_left)
    x1 = (uv_left[:, 0] - cx) / fx_
    y1 = (uv_left[:, 1] - cy) / fy_
    x2 = (uv_right[:, 0] - cx) / fx_
    y2 = (uv_right[:, 1] - cy) / fy_
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    a3 = torch.stack([torch.stack([-ones, zeros, x1], -1),
                      torch.stack([zeros, -ones, y1], -1),
                      torch.stack([-ones, zeros, x2], -1),
                      torch.stack([zeros, -ones, y2], -1)], dim=-2)  # [N, 4, 3]
    a4 = torch.stack([zeros, zeros, baseline * ones, zeros], dim=-1)  # [N, 4]
    # (a3^T a3) X = -a3^T a4 (see the module note on the summation order)
    rows = a3.transpose(0, 1)                                  # [4, N, 3]
    m33 = _fma_chain(rows[..., :, None], rows[..., None, :])
    rhs = -_fma_chain(rows, a4.T[..., None])
    pts_cam = _solve33(m33, rhs)
    finite = torch.isfinite(pts_cam).all(dim=-1)

    uv_l = se3.project_points(pts_cam, fx, fy, cx, cy)
    vis_l = se3.visibility_mask(pts_cam, uv_l, near, far, min_x, max_x, min_y, max_y)
    pts_cam_r = torch.stack(
        [pts_cam[:, 0] - baseline, pts_cam[:, 1], pts_cam[:, 2]], dim=-1)
    uv_r = se3.project_points(pts_cam_r, fx, fy, cx, cy)
    vis_r = se3.visibility_mask(pts_cam_r, uv_r, near, far, min_x, max_x, min_y, max_y)
    err_l = ((uv_l - uv_left) ** 2).sum(dim=-1)
    err_r = ((uv_r - uv_right) ** 2).sum(dim=-1)
    ok = (pair_valid & finite & vis_l & vis_r
          & (err_l <= reprojection_th2) & (err_r <= reprojection_th2))
    pts_world = se3.transform_points(pose.matrix34(), pts_cam)
    return TriangulationResult(pts_cam, pts_world, ok)


def backproject_rgbd(uv: torch.Tensor, depth: torch.Tensor,
                     valid: torch.Tensor, pose: se3.Pose, *, fx, fy, cx,
                     cy) -> TriangulationResult:
    """Direct depth back-projection of [N, 2] pixels with [N] metric depth.
    Depth validity ([near, far]) is set at extraction, so ``valid``
    carries it."""
    x = (uv[:, 0] - cx) * depth / scalar(fx, uv)
    y = (uv[:, 1] - cy) * depth / scalar(fy, uv)
    pts_cam = torch.stack([x, y, depth], dim=-1)
    pts_world = se3.transform_points(pose.matrix34(), pts_cam)
    return TriangulationResult(pts_cam, pts_world, valid)
