"""Distributed PnP: the normal equations reduced over a ``points`` group.

Port of lvt_tpu/parallel/ba.py. The normal-equation accumulation H =
sum_i w_i J_i^T J_i, g = sum_i w_i J_i^T r_i is a shardable reduction:
each rank holds a block of the 2D-3D correspondences, forms its partial
sums, and one all-reduce over the group gives the whole system; the 6x6
solve and the pose update run on every rank alike, so the LM loop stays
consistent without other communication. The math is
``solver/pnp.py::solve_pnp(group=)``, the same code the sharded-map step
(parallel/sharded_stream.py) calls; this is the entry point for sharding
the PnP solve alone.
"""

from __future__ import annotations

import torch

from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.parallel.mesh import POINT_AXIS
from lvt_tpu_torch.solver import pnp as pnp_mod


def solve_pnp_sharded(
    initial_pose: Pose,
    points: torch.Tensor,    # [M / n, 3]: this rank's block
    obs: torch.Tensor,       # [M / n, 2]
    weights: torch.Tensor,   # [M / n]
    mesh,
    *, fx, fy, cx, cy,
    reprojection_th2: float = 5.991,
    axis: str = POINT_AXIS,
) -> pnp_mod.PnPResult:
    """``solve_pnp`` with the residual blocks sharded over the ranks of
    ``mesh``'s ``axis``: each rank passes its contiguous block of the
    points and gets the same pose, chi-square and (global) inlier count;
    its ``inlier_mask`` is its block's."""
    return pnp_mod.solve_pnp(
        initial_pose, points, obs, weights, fx=fx, fy=fy, cx=cx, cy=cy,
        reprojection_th2=reprojection_th2, group=mesh.get_group(axis))
