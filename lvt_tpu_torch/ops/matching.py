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


def project_visible(pos, valid, pose, *, fx, fy, cx, cy, near, far,
                    min_x, max_x, min_y, max_y):
    """Pixels [M, 2] of world points [M, 3] seen from the camera-in-world
    ``pose``, and which of the ``valid`` points lie in the frustum and the
    image bounds [M]: the query side of a projection match."""
    pts_cam = se3.transform_points(se3.world_to_camera(pose), pos)
    uv = se3.project_points(pts_cam, fx, fy, cx, cy)
    return uv, valid & se3.visibility_mask(pts_cam, uv, near, far, min_x,
                                           max_x, min_y, max_y)


def find_map_matches(
    map_pos, map_desc, map_valid, pose, feats: FrameFeatures, *,
    fx, fy, cx, cy, near, far, min_x, max_x, min_y, max_y,
    tracking_radius: int, ratio_threshold: float, abs_threshold: float,
    retry_min_matches: int, group=None,
) -> MapMatchResult:
    uv, visible = project_visible(map_pos, map_valid, pose, fx=fx, fy=fy,
                                  cx=cx, cy=cy, near=near, far=far,
                                  min_x=min_x, max_x=max_x, min_y=min_y,
                                  max_y=max_y)
    return match_projected(uv, visible, map_desc, feats,
                           tracking_radius=tracking_radius,
                           ratio_threshold=ratio_threshold,
                           abs_threshold=abs_threshold,
                           retry_min_matches=retry_min_matches, group=group)


def match_projected(uv, visible, map_desc, feats: FrameFeatures, *,
                    tracking_radius: int, ratio_threshold: float,
                    abs_threshold: float, retry_min_matches: int,
                    group=None) -> MapMatchResult:
    """:func:`find_map_matches` from the map's projection (``uv``,
    ``visible``: :func:`project_visible`): kernel T under both radii, the
    acceptance and one-to-one resolution of each, the wide radius where
    the narrow one matched too few."""
    k = feats.kp.shape[0]
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


def row_window(left: FrameFeatures, left_excluded: torch.Tensor, *,
               vertical_search_radius: int, img_rows: int):
    """The query side of a row match: each left feature's window of right
    rows, floor(y_l) -+ r clamped to the image, [K, 2] (lo, hi), and which
    left features query [K] (valid and not excluded)."""
    query_ok = left.valid & ~left_excluded
    y_l = torch.floor(left.kp[:, 1])
    lo = torch.clamp(y_l - vertical_search_radius, min=0.0)
    hi = torch.clamp(y_l + vertical_search_radius, max=float(img_rows))
    return torch.stack([lo, hi], dim=-1), query_ok


def row_top2(left: FrameFeatures, right: FrameFeatures, window, query_ok):
    """Kernel T in row mode: (d1, d2, best, n_cand) per left feature."""
    return hamming_top2(left.desc, right.desc, window, query_ok, right.kp,
                        right.valid, r2a=0.0, r2b=0.0, row_mode=True)[0]


def row_match(
    left: FrameFeatures, right: FrameFeatures, left_excluded: torch.Tensor, *,
    vertical_search_radius: int, ratio_threshold: float,
    abs_threshold: float, img_rows: int,
) -> RowMatchResult:
    """Epipolar row matching: right candidates lie within
    floor(y_l) -+ r rows (clamped to the image)."""
    window, query_ok = row_window(
        left, left_excluded, vertical_search_radius=vertical_search_radius,
        img_rows=img_rows)
    d1, d2, best, n_cand = row_top2(left, right, window, query_ok)
    k = left.kp.shape[0]
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_threshold,
                                 abs_threshold)
    idx = hamming.resolve_one_to_one(idx, d1, k)
    left_matched = idx >= 0
    return RowMatchResult(
        right_idx=idx, left_matched=left_matched,
        right_matched=hamming.claim_mask(idx, k) & right.valid,
        count=left_matched.sum(),
    )
