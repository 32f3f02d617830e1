"""Projection matching (map -> frame) and stereo row matching.

Port of lvt_tpu/ops/matching.py. Both radii of the map match, and the row
window of the row matches, reduce through kernel T (ops/top2.py), which
takes the descriptors and computes the Hamming distances (and in row mode
each query's window) itself. After T,
the map match's acceptance, one-to-one resolution, wide retry and claims,
and the step's observations for PnP, are the custom op
``lvt_tpu_torch::map_accept`` (:func:`map_accept`), built as kernel T's op:
one launch of ``csrc/track.cu``'s ``map_accept_kernel`` for all streams on
the card, the plain version (:func:`map_accept_plain`, the torch ops the
step ran before) on the CPU, a fake kernel, and a vmap rule that folds
vmap's axis into the stream axis. With a ``group``, the map match runs on
this rank's block of the map (kernel T at its rows) and reduces across the
group as lvt_tpu's does across a mesh axis: the one-to-one claims with a
``pmin``, both match counts with a ``psum`` and the claimed features with
an OR; the plain version runs them (a collective cannot run inside a
kernel).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from lvt_tpu_torch import kernels
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.geometry import se3
from lvt_tpu_torch.ops import hamming, top2
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
    obs: torch.Tensor              # [M, 2] the matched keypoint (PnP's)
    weights: torch.Tensor          # [M] f32 1 where matched


def dual_radius_top2(q_desc, t_desc, q_uv, q_valid, t_kp, t_valid,
                     radius_a, radius_b):
    """Masked top-2 of Hamming distances under two radius predicates in one
    pass (radius_b == radius_a gives one predicate, returned twice)."""
    return hamming_top2(q_desc, t_desc, q_uv, q_valid, t_kp, t_valid,
                        r2a=float(radius_a) ** 2, r2b=float(radius_b) ** 2)


def _accept_resolve(top2_out, ratio_th, abs_th, num_feats, group):
    d1, d2, best, n_cand = top2_out
    idx = hamming.accept_matches(d1, d2, best, n_cand, ratio_th, abs_th)
    return hamming.resolve_one_to_one(idx, d1, num_feats, group), d1, d2


# the outputs of map_accept, in the op's order
ACCEPT_FIELDS = ("match_idx", "d1", "d2", "feature_matched", "matches_count",
                 "used_wide_radius", "obs", "weights")


def map_accept_plain(top2_narrow, top2_wide, visible, feat_valid, feat_kp, *,
                     ratio_threshold: float, abs_threshold: float,
                     retry_min_matches: int, group=None) -> dict:
    """The map match after kernel T: each radius's acceptance and
    one-to-one resolution, the wide radius where the narrow one matched
    fewer than ``retry_min_matches``, the match index (-2 invisible, -1
    unmatched), the claims of the valid features, the count, and PnP's
    observations (the matched feature's keypoint, feature 0's where
    unmatched) and weights. Returns ACCEPT_FIELDS by name."""
    k = feat_valid.shape[0]
    idx1, d1a, d2a = _accept_resolve(top2_narrow, ratio_threshold,
                                     abs_threshold, k, group)
    idx2, d1b, d2b = _accept_resolve(top2_wide, ratio_threshold,
                                     abs_threshold, k, group)
    use_wide = psum_if((idx1 >= 0).sum(), group) < retry_min_matches
    idx = torch.where(use_wide, idx2, idx1)
    match_idx = torch.where(visible, torch.where(idx >= 0, idx, -1), -2)
    # one-to-one resolution leaves each feature at most one winner across
    # the ranks, so the global claim mask is the OR of the ranks'
    feature_matched = por_if(hamming.claim_mask(idx, k), group) & feat_valid
    return dict(
        match_idx=match_idx, d1=torch.where(use_wide, d1b, d1a),
        d2=torch.where(use_wide, d2b, d2a), feature_matched=feature_matched,
        matches_count=psum_if((idx >= 0).sum(), group),
        used_wide_radius=use_wide,
        obs=feat_kp[torch.clamp(match_idx, 0, k - 1)],
        weights=(match_idx >= 0).float())


def _map_accept_flat(fout, iout, visible, feat_valid, feat_kp, ratio, abs_th,
                     retry_min):
    out = map_accept_plain(*top2._unpack(fout, iout), visible, feat_valid,
                           feat_kp, ratio_threshold=ratio,
                           abs_threshold=abs_th, retry_min_matches=retry_min)
    return tuple(out[name] for name in ACCEPT_FIELDS)


@torch.library.custom_op("lvt_tpu_torch::map_accept", mutates_args=(),
                         device_types="cuda")
def map_accept_op(fout: torch.Tensor, iout: torch.Tensor,
                  visible: torch.Tensor, feat_valid: torch.Tensor,
                  feat_kp: torch.Tensor, ratio_threshold: float,
                  abs_threshold: float, retry_min_matches: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """S streams: kernel T's outputs at the map site (fout [S, 2, 2, M]
    f32, iout [S, 2, 2, M] int64, ops/top2.py's layout), the queries'
    visibility [S, M] bool, the features' validity [S, K] bool and
    keypoints [S, K, 2] f32 -> match_idx [S, M] int64, d1, d2 [S, M] f32,
    feature_matched [S, K] bool, matches_count [S] int64, used_wide_radius
    [S] bool, obs [S, M, 2] f32 and weights [S, M] f32.

    CUDA: one launch of ``csrc/track.cu``'s ``map_accept_kernel``, one
    block per stream: each radius's resolution an atomicMin per feature in
    shared memory, the counts those that found a feature's key unset, the
    claims read from the keys."""
    s, m = visible.shape
    k = feat_valid.shape[1]
    if k > top2.MAX_K:
        raise ValueError(f"K={k} feature slots exceed the kernel's "
                         f"{top2.MAX_K}")
    dev = visible.device
    for x, name, dtype, shape in (
            (fout, "fout", torch.float32, (s, 2, 2, m)),
            (iout, "iout", torch.int64, (s, 2, 2, m)),
            (visible, "visible", torch.bool, (s, m)),
            (feat_valid, "feat_valid", torch.bool, (s, k)),
            (feat_kp, "feat_kp", torch.float32, (s, k, 2))):
        kernels.require(x, name, dtype, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((s, m), dtype=torch.int64, device=dev),
            torch.empty((s, m), **f32), torch.empty((s, m), **f32),
            torch.empty((s, k), dtype=torch.bool, device=dev),
            torch.empty((s,), dtype=torch.int64, device=dev),
            torch.empty((s,), dtype=torch.bool, device=dev),
            torch.empty((s, m, 2), **f32), torch.empty((s, m), **f32))
    err = kernels.lib().lvt_map_accept(
        *(x.data_ptr() for x in (fout, iout, visible, feat_valid, feat_kp)),
        s, m, k, float(ratio_threshold), float(abs_threshold),
        int(retry_min_matches), *(x.data_ptr() for x in outs),
        kernels.stream_ptr(visible))
    kernels.check(err, "map_accept")
    map_accept.launches += 1
    return outs


def _map_accept_fake(fout, iout, visible, feat_valid, feat_kp, *scalars):
    s, m = visible.shape
    k = feat_valid.shape[1]
    return (iout.new_empty((s, m)), fout.new_empty((s, m)),
            fout.new_empty((s, m)), feat_valid.new_empty((s, k)),
            iout.new_empty((s,)), visible.new_empty((s,)),
            fout.new_empty((s, m, 2)), fout.new_empty((s, m)))


kernels.register_stream_op(
    sys.modules[__name__], "map_accept",
    lambda *a: kernels.per_stream(_map_accept_flat, 5, a), _map_accept_fake,
    5)


def map_accept(fout, iout, visible, feats: FrameFeatures, *,
               ratio_threshold: float, abs_threshold: float,
               retry_min_matches: int) -> dict:
    """:func:`map_accept_plain` for one stream from kernel T's packed
    outputs (``top2.hamming_top2_packed``): CPU tensors take the plain
    version, CUDA tensors the kernel, and under ``torch.func.vmap`` one
    launch serves every stream. Returns ACCEPT_FIELDS by name."""
    if visible.device.type not in ("cpu", "cuda"):
        raise ValueError(f"visible: expected a CUDA tensor, got "
                         f"{visible.device}")
    outs = map_accept_op(fout[None], iout[None], visible[None],
                         feats.valid[None], feats.kp[None],
                         float(ratio_threshold), float(abs_threshold),
                         int(retry_min_matches))
    return {name: x[0] for name, x in zip(ACCEPT_FIELDS, outs)}


map_accept.launches = 0


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
    ``visible``: :func:`project_visible`): kernel T under both radii, then
    :func:`map_accept` (with a ``group`` :func:`map_accept_plain` and its
    collectives)."""
    r = float(tracking_radius)
    fout, iout = top2.hamming_top2_packed(
        map_desc, feats.desc, uv, visible, feats.kp, feats.valid,
        r2a=r ** 2, r2b=(2 * r) ** 2)
    kw = dict(ratio_threshold=ratio_threshold, abs_threshold=abs_threshold,
              retry_min_matches=retry_min_matches)
    if group is None:
        out = map_accept(fout, iout, visible, feats, **kw)
    else:
        out = map_accept_plain(*top2._unpack(fout, iout), visible,
                               feats.valid, feats.kp, group=group, **kw)
    return MapMatchResult(projection=uv, visible=visible, **out)


def row_top2_packed(left: FrameFeatures, right: FrameFeatures,
                    left_excluded, left_included=None, *,
                    vertical_search_radius: int, img_rows: int):
    """Kernel T in row mode, packed as the op writes it (fout [2, 2, K] f32,
    iout [2, 2, K] int64; ``top2._pack``): each valid left feature not in
    ``left_excluded`` queries the right features within floor(y_l) -+ r
    rows (clamped to the image; the kernel computes the window), and with
    ``left_included`` the valid left features in it query the same window
    as the second predicate, in the same launch."""
    return top2.hamming_top2_packed(
        left.desc, right.desc, left.kp, left.valid, right.kp, right.valid,
        left_excluded, left_included, row_mode=True,
        row_radius=float(vertical_search_radius), img_rows=float(img_rows))
