"""Projection matching (map -> frame) and stereo row matching.

Port of lvt_tpu/ops/matching.py. Both radii of the map match, and the row
window of the row match, reduce through kernel T (ops/top2.py), which
takes the descriptors and computes the Hamming distances itself. With a
``group``, the map match runs on this rank's block of the map (kernel T at
its rows) and reduces across the group as lvt_tpu's does across a mesh
axis: the one-to-one claims with a ``pmin``, both match counts with a
``psum`` and the claimed features with an OR.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.geometry import se3
from lvt_tpu_torch.ops import hamming
from lvt_tpu_torch.ops.collectives import por_if, psum_if
from lvt_tpu_torch.ops.top2 import hamming_top2


class MapMatchResult(NamedTuple):
    match_idx: torch.Tensor        # [M] int64 feature index, -1 unmatched, -2 invisible
    projection: torch.Tensor       # [M, 2]
    visible: torch.Tensor          # [M] bool
    d1: torch.Tensor               # [M] f32
    d2: torch.Tensor               # [M] f32
    feature_matched: torch.Tensor  # [K] bool
    matches_count: torch.Tensor    # [] int64
    used_wide_radius: torch.Tensor  # [] bool


def dual_radius_top2(q_desc, t_desc, q_uv, q_valid, t_kp, t_valid,
                     radius_a, radius_b):
    """Masked top-2 of Hamming distances under two radius predicates in one
    pass (radius_b == radius_a gives one predicate, returned twice)."""
    return hamming_top2(q_desc, t_desc, q_uv, q_valid, t_kp, t_valid,
                        r2a=float(radius_a) ** 2, r2b=float(radius_b) ** 2)


def _accept_resolve(top2, ratio_th, abs_th, num_feats, group):
    d1, d2, best, n_cand = top2
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_th, abs_th)
    return hamming.resolve_one_to_one(idx, d1, num_feats, group), d1, d2


def find_map_matches(
    map_pos, map_desc, map_valid, pose, feats: FrameFeatures, *,
    fx, fy, cx, cy, near, far, min_x, max_x, min_y, max_y,
    tracking_radius: int, ratio_threshold: float, abs_threshold: float,
    retry_min_matches: int, group=None,
) -> MapMatchResult:
    k = feats.kp.shape[0]
    w2c = se3.world_to_camera(pose)
    pts_cam = se3.transform_points(w2c, map_pos)
    uv = se3.project_points(pts_cam, fx, fy, cx, cy)
    visible = map_valid & se3.visibility_mask(pts_cam, uv, near, far,
                                              min_x, max_x, min_y, max_y)
    top2_narrow, top2_wide = dual_radius_top2(
        map_desc, feats.desc, uv, visible, feats.kp, feats.valid,
        tracking_radius, 2 * tracking_radius)
    idx1, d1a, d2a = _accept_resolve(top2_narrow, ratio_threshold,
                                     abs_threshold, k, group)
    idx2, d1b, d2b = _accept_resolve(top2_wide, ratio_threshold,
                                     abs_threshold, k, group)
    use_wide = psum_if((idx1 >= 0).sum(), group) < retry_min_matches
    idx = torch.where(use_wide, idx2, idx1)
    d1 = torch.where(use_wide, d1b, d1a)
    d2 = torch.where(use_wide, d2b, d2a)
    match_idx = torch.where(visible, torch.where(idx >= 0, idx, -1), -2)
    # one-to-one resolution leaves each feature at most one winner across
    # the ranks, so the global claim mask is the OR of the ranks'
    feature_matched = por_if(hamming.claim_mask(idx, k), group) & feats.valid
    return MapMatchResult(
        match_idx=match_idx, projection=uv, visible=visible, d1=d1, d2=d2,
        feature_matched=feature_matched,
        matches_count=psum_if((idx >= 0).sum(), group),
        used_wide_radius=use_wide,
    )


class RowMatchResult(NamedTuple):
    right_idx: torch.Tensor      # [K] int64, -1 = none
    left_matched: torch.Tensor   # [K] bool
    right_matched: torch.Tensor  # [K] bool
    count: torch.Tensor          # [] int64


def row_match(
    left: FrameFeatures, right: FrameFeatures, left_excluded: torch.Tensor, *,
    vertical_search_radius: int, ratio_threshold: float,
    abs_threshold: float, img_rows: int,
) -> RowMatchResult:
    """Epipolar row matching: right candidates lie within
    floor(y_l) -+ r rows (clamped to the image)."""
    k = left.kp.shape[0]
    query_ok = left.valid & ~left_excluded
    y_l = torch.floor(left.kp[:, 1])
    lo = torch.clamp(y_l - vertical_search_radius, min=0.0)
    hi = torch.clamp(y_l + vertical_search_radius, max=float(img_rows))
    (d1, d2, best, n_cand), _ = hamming_top2(
        left.desc, right.desc, torch.stack([lo, hi], dim=-1), query_ok,
        right.kp, right.valid, r2a=0.0, r2b=0.0, row_mode=True)
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_threshold,
                                 abs_threshold)
    idx = hamming.resolve_one_to_one(idx, d1, k)
    left_matched = idx >= 0
    return RowMatchResult(
        right_idx=idx, left_matched=left_matched,
        right_matched=hamming.claim_mask(idx, k) & right.valid,
        count=left_matched.sum(),
    )
