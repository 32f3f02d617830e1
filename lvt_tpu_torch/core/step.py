"""The per-frame tracking step: extraction + one predicated tracking body.

Port of lvt_tpu/core/step.py (stereo, rectified stereo from raw frames,
stereo at external corners and RGB-D; single device, windowed local BA
optional). The reference's state machine is ONE computation: the
init frame is a tracking frame over an empty map at a forced-identity pose
with triangulation forced on, and the lost frame is an output select. Every
retry and policy branch is computed and then selected with
``torch.where``, so the step has fixed shapes and no data-dependent Python
branch or host sync — the form a CUDA graph can capture. lvt_tpu's one
``lax.cond``, local BA on its schedule, is ``graphs.cond``: in a captured
step a CUDA IF node on the device predicate, so BA runs only on its
frames; in the eager step and under vmap BA is computed on every frame
and selected, as JAX's vmapped path lowers it. lvt_tpu's
``jax.jit`` of the step and ``lax.scan`` over a chunk are one CUDA graph of
the step, captured once and replayed per frame on the state's static
buffers (core/graphs.py); ``graphs.disable_graphs()`` runs it eagerly.

The step is also the body of the multi-stream step
(parallel/multistream.py), which runs :func:`track_features` under
``torch.func.vmap`` as lvt_tpu runs it under ``jax.vmap``: every op in it
has a batching rule, kernel T's included (ops/top2.py).

With a ``group`` (lvt_tpu's ``axis_name``) the step is the body of the
sharded-map modes (parallel/sharded_stream.py, parallel/stream_point.py):
the map and staged stores and the BA window's point axis are this rank's
blocks of stores sharded over the group's ranks, the features and the
pose state are the same on every rank, per-point work is local, and the
cross-shard quantities reduce over the group (ops/collectives.py): match
counts and map sizes with ``psum``, the one-to-one claims with ``pmin``,
the claimed features with an OR, the PnP and BA sums as their solvers
say. New points are partitioned over the ranks by valid rank. Without a
group the step is the one-process program, bit for bit.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.profiler import record_function as stage

from lvt_tpu_torch.config import MATCHES_WINDOW_INIT, VOConfig
from lvt_tpu_torch.core import extract, graphs
from lvt_tpu_torch.core import map as map_ops
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.core.motion import predict_next_pose
from lvt_tpu_torch.core.state import (LOST, NOT_INITIALIZED, TRACKING,
                                      ObsWindow, PointStore, StepMetrics,
                                      VOState)
from lvt_tpu_torch.geometry import se3
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import hamming, matching, triangulate, undistort
from lvt_tpu_torch.ops.collectives import (axis_index, axis_size, por_if,
                                           psum_if)
from lvt_tpu_torch.solver import bundle
from lvt_tpu_torch.solver.pnp import solve_pnp
from lvt_tpu_torch.tree import tree_map


def _select(pred, a, b):
    """Leaf-wise select of two containers on a scalar predicate."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def _shard_partition_mask(insert_mask, group):
    """Partition insertion candidates, the same on every rank, across the
    group's ranks so each point lands in exactly one shard, balanced by the
    candidates' valid rank (round-robin over the feature index would let
    clustered candidates overfill one shard)."""
    if group is None:
        return insert_mask
    rank = torch.cumsum(insert_mask.to(torch.int32), dim=0) - 1
    return insert_mask & (rank % axis_size(group) == axis_index(group))


def _image_bounds(config: VOConfig):
    """Visible pixel bounds: for distorted (RGB-D) input the undistorted
    image corners, computed once per camera on the host as plain floats;
    the image itself when k1 = 0."""
    return undistort.undistorted_image_bounds(
        config.img_width, config.img_height, config.fx, config.fy, config.cx,
        config.cy, config.k1, config.k2, config.p1, config.p2, config.k3)


def _camera_kwargs(config: VOConfig) -> dict:
    min_x, max_x, min_y, max_y = _image_bounds(config)
    return dict(fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
                near=config.near_plane_distance, far=config.far_plane_distance,
                min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y)


def _row_match(left: FrameFeatures, right: FrameFeatures, left_excluded,
               config: VOConfig):
    return matching.row_match(
        left, right, left_excluded,
        vertical_search_radius=config.row_matching_vertical_search_radius,
        ratio_threshold=config.triangulation_ratio_test_threshold,
        abs_threshold=config.descriptor_matching_threshold,
        img_rows=config.img_height,
    )


def _triangulate_new_points(left: FrameFeatures, right: FrameFeatures | None,
                            feature_matched, pose: Pose, config: VOConfig):
    """Stereo: row-match the untracked left features and triangulate them.
    RGB-D (``right`` None): back-project every depth-valid feature, matched
    or not, as the reference does; duplicates are culled by the untracked
    counter. Returns (points_world [K, 3], desc [K, W], valid [K])."""
    if right is None:
        res = triangulate.backproject_rgbd(
            left.kp, left.depth, left.valid, pose,
            fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy)
        return res.points_world, left.desc, res.valid
    rm = _row_match(left, right, feature_matched, config)
    k = left.kp.shape[0]
    uv_right = right.kp[torch.clamp(rm.right_idx, 0, k - 1)]
    res = triangulate.triangulate_stereo(
        left.kp, uv_right, rm.left_matched, pose,
        baseline=config.baseline, reprojection_th2=config.reprojection_th2,
        **_camera_kwargs(config))
    return res.points_world, left.desc, res.valid


def _policy_need_triangulation(config: VOConfig, window, map_size):
    """Triangulation policies; ``window`` is oldest-first [3] f32 including
    the current frame's match count."""
    if config.triangulation_policy == 2:
        return torch.ones((), dtype=torch.bool, device=window.device)
    if config.triangulation_policy == 3:
        return map_size < 1000
    ratio = 0.99
    return (window[1] <= ratio * window[0]) & (window[2] <= ratio * window[1])


def _staged_update(staged, pose: Pose, feats: FrameFeatures, feature_matched,
                   map_size, config: VOConfig, group=None):
    """Re-match staged points against the unmatched features; delete misses,
    promote survivors. Returns (staged', promotion candidates, marks)."""
    cam = _camera_kwargs(config)
    k = feats.kp.shape[0]
    w2c = se3.world_to_camera(pose)
    pts_cam = se3.transform_points(w2c, staged.pos)
    uv = se3.project_points(pts_cam, config.fx, config.fy, config.cx, config.cy)
    visible = staged.valid & se3.visibility_mask(
        pts_cam, uv, cam["near"], cam["far"],
        cam["min_x"], cam["max_x"], cam["min_y"], cam["max_y"])
    (d1, d2, best, n_cand), _ = matching.dual_radius_top2(
        staged.desc, feats.desc, uv, visible, feats.kp,
        feats.valid & ~feature_matched,
        config.tracking_radius, config.tracking_radius)
    idx = hamming.accept_matches(d1, d2, best, n_cand,
                                 config.tracking_ratio_test_threshold,
                                 config.descriptor_matching_threshold)
    idx = hamming.resolve_one_to_one(idx, d1, k, group)
    matched = idx >= 0
    feature_matched = feature_matched | por_if(hamming.claim_mask(idx, k),
                                               group)

    ctr = torch.where(matched, staged.counter + 1, staged.counter)
    promote = staged.valid & matched & (
        (staged.counter + 1 == config.staged_threshold)
        | (map_size < config.map_soft_cap))
    staged_out = staged._replace(counter=ctr,
                                 valid=staged.valid & matched & ~promote)
    promo = (staged.pos, staged.desc, ctr, staged.age, promote)
    return staged_out, promo, feature_matched


def _refine_structure(poses: Pose, pos, obs, w, obs_r, w_r, config: VOConfig,
                      group=None):
    """One windowed BA over the map (``bundle.refine_structure_plain``):
    the gate, the refinement, the trust region and the improvement test.
    Returns positions [M, 3]. Without a group, one launch of the op
    ``lvt_tpu_torch::ba_refine`` (``bundle.ba_refine``: the kernel of
    csrc/ba.cu on the card, the torch ops on the CPU); with one, the torch
    ops and their all-reduces."""
    kw = dict(fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
              baseline=config.baseline, iterations=config.local_ba_iterations,
              reprojection_th2=config.reprojection_th2)
    if group is None:
        return bundle.ba_refine(poses, pos, obs, w, obs_r, w_r, **kw)[0]
    return bundle.refine_structure_plain(poses, pos, obs, w, obs_r, w_r,
                                         group=group, **kw)[0]


def _local_ba_update(ba: ObsWindow, map_store: PointStore, pose_opt: Pose,
                     obs_new, w_new, obs_r_new, w_r_new, slots_invalidated,
                     frame_number, config: VOConfig, group=None):
    """Slide the observation window by this frame and, every
    ``local_ba_every`` frames once it is full, refine the map structure.
    Returns (window', the window's newest pose, map positions, whether BA
    ran). BA is lvt_tpu's ``lax.cond`` on the schedule, ``graphs.cond``: a
    CUDA IF node on the device predicate in a captured single-process or
    NCCL step, computed and selected elsewhere (no host sync either way);
    the window slides outside it, on every frame. The trajectory stays
    the PnP output."""
    alive = (map_store.valid & ~slots_invalidated)[None, :].float()

    def slide(old, new):
        return torch.cat([old[1:], new[None]], 0)

    window = ObsWindow(
        poses_t=slide(ba.poses_t, pose_opt.t),
        poses_q=slide(ba.poses_q, pose_opt.q),
        obs=slide(ba.obs, obs_new), w=slide(ba.w, w_new) * alive,
        obs_r=slide(ba.obs_r, obs_r_new), w_r=slide(ba.w_r, w_r_new) * alive,
        n=torch.clamp(ba.n + 1, max=config.local_ba_window),
    )
    do_ba = ((window.n >= config.local_ba_window)
             & (frame_number % config.local_ba_every == 0))
    map_pos = graphs.cond(do_ba, lambda: _refine_structure(
        Pose(window.poses_t, window.poses_q), map_store.pos, window.obs,
        window.w, window.obs_r, window.w_r, config, group), map_store.pos)
    return (window, Pose(window.poses_t[-1], window.poses_q[-1]), map_pos,
            do_ba)


def _track_branch(state: VOState, left: FrameFeatures,
                  right: FrameFeatures | None, config: VOConfig, is_init,
                  group=None):
    """Tracking frame, and through ``is_init`` the initialization frame;
    ``right`` is None for RGB-D. Stages carry profiler ranges named as
    lvt_tpu's jax.named_scope."""
    cam = _camera_kwargs(config)
    k = left.kp.shape[0]
    identity = Pose.identity(left.kp.device)

    with stage("motion_predict"):
        motion, predicted = predict_next_pose(state.motion, state.pose)
        predicted = _select(is_init, identity, predicted)
        motion = _select(is_init, state.motion, motion)

    with stage("map_matching"):
        mm = matching.find_map_matches(
            state.map.pos, state.map.desc, state.map.valid, predicted, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold, group=group,
            **cam)
    matches_count = mm.matches_count
    is_tracking = (matches_count >= config.min_num_matches_for_tracking) | is_init

    obs = left.kp[torch.clamp(mm.match_idx, 0, k - 1)]
    weights = (mm.match_idx >= 0).float()
    with stage("pnp_solve"):
        pnp = solve_pnp(predicted, state.map.pos, obs, weights,
                        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
                        reprojection_th2=config.reprojection_th2,
                        group=group)
    pose_opt = _select(is_init, identity, pnp.pose)

    with stage("map_bookkeeping"):
        map_bookkept = map_ops.apply_match_bookkeeping(state.map, mm.match_idx)
        map_clean, feature_matched = map_ops.clean_untracked(
            map_bookkept, mm.match_idx, mm.feature_matched,
            config.untracked_threshold, group)
    map_size = psum_if(map_clean.size(), group)

    if config.staged_threshold > 0:
        with stage("staged_update"):
            staged_out, promo, feature_matched = _staged_update(
                state.staged, pose_opt, left, feature_matched, map_size,
                config, group)
            p_pos, p_desc, p_ctr, p_age, p_mask = promo
            ins_promo = map_ops.insert_points(
                map_clean, p_pos, p_desc, p_mask, new_counter=p_ctr,
                new_age=p_age)
            map_after_promo = ins_promo.store
    else:
        staged_out = state.staged
        map_after_promo = map_clean

    window = torch.cat([state.last_matches[1:], matches_count[None].float()])
    map_size_after_promo = psum_if(map_after_promo.size(), group)
    need_tri = _policy_need_triangulation(
        config, window, map_size_after_promo) | is_init

    # lvt_tpu builds one stereo Hamming matrix for the triangulation row
    # match and the BA row match; here each row match computes its
    # distances inside kernel T, since recomputing 1536 x 1536 distances
    # costs less than writing and reading back a 9.4 MB matrix
    want_ba_rm = (config.local_ba_window > 0 and right is not None
                  and config.baseline != 0.0)

    with stage("triangulation"):
        pts, desc, tri_valid = _triangulate_new_points(
            left, right, feature_matched, pose_opt, config)
        # with a group each rank inserts its share of the candidates
        tri_valid = _shard_partition_mask(tri_valid & need_tri, group)
        to_map = ((map_size_after_promo < config.map_soft_cap)
                  | (config.staged_threshold == 0))
        ins_map = map_ops.insert_points(map_after_promo, pts, desc,
                                        tri_valid & to_map)
        ins_staged = map_ops.insert_points(staged_out, pts, desc,
                                           tri_valid & ~to_map)

    final_map, pose_final, ba_window = ins_map.store, pose_opt, state.ba
    ba_ran = torch.zeros((), dtype=torch.bool, device=left.kp.device)
    if config.local_ba_window > 0:
        removed = map_bookkept.valid & ~map_clean.valid
        recycled = ins_map.taken
        if config.staged_threshold > 0:
            recycled = recycled | ins_promo.taken
        with stage("local_ba"):
            if want_ba_rm:
                # right-camera observations of the map-matched features
                rm_ba = _row_match(left, right, ~mm.feature_matched, config)
                r_idx = rm_ba.right_idx[torch.clamp(mm.match_idx, 0, k - 1)]
                obs_r = right.kp[torch.clamp(r_idx, 0, k - 1)]
                w_r = ((mm.match_idx >= 0) & (r_idx >= 0)).float()
            else:
                # no right camera: no stereo anchor, so BA is inert
                obs_r, w_r = torch.zeros_like(obs), torch.zeros_like(weights)
            ba_window, pose_final, refined_pos, ba_ran = _local_ba_update(
                state.ba, final_map, pose_opt, obs, weights, obs_r, w_r,
                removed | recycled, state.frame_number, config, group)
        final_map = final_map._replace(pos=refined_pos)

    map_size_final = psum_if(ins_map.store.size(), group)
    init_window = torch.stack([
        map_size_final.float(),
        torch.full((), MATCHES_WINDOW_INIT, device=window.device),
        torch.full((), MATCHES_WINDOW_INIT, device=window.device)])
    window = torch.where(is_init, init_window, window)
    new_state = VOState(
        map=_select(is_tracking, final_map, map_bookkept),
        staged=_select(is_tracking, ins_staged.store, state.staged),
        pose=_select(is_tracking, pose_final, state.pose),
        motion=motion,
        last_matches=torch.where(is_tracking, window, state.last_matches),
        frame_number=state.frame_number + 1,
        status=torch.where(is_tracking, TRACKING, LOST).to(torch.int32),
        ba=_select(is_tracking & ~is_init, ba_window, state.ba),
    )
    out_pose = _select(is_tracking, pose_final, state.pose)

    matched_mask = mm.match_idx >= 0
    n_matched = torch.clamp(matches_count, min=1)

    def mean_of(v):
        return psum_if(torch.where(matched_mask, v, 0.0).sum(),
                       group) / n_matched

    metrics = StepMetrics(
        map_points_count=torch.where(
            is_init, map_size_final,
            psum_if(state.map.size(), group)).to(torch.int32),
        staged_points_count=psum_if(state.staged.size(),
                                    group).to(torch.int32),
        image_keypoints=left.count().to(torch.int32),
        tracked_map_points=matches_count.to(torch.int32),
        mean_age=mean_of(map_bookkept.age.float()),
        mean_closest_descriptor_distance=mean_of(mm.d1),
        mean_second_descriptor_distance=mean_of(mm.d2),
        mean_feature_x=mean_of(obs[:, 0]),
        mean_feature_y=mean_of(obs[:, 1]),
        inlier_count=pnp.inlier_count.to(torch.int32),
        triangulated_points=torch.where(
            is_tracking, psum_if(ins_map.n_inserted + ins_staged.n_inserted,
                                 group), 0).to(torch.int32),
        used_wide_radius=mm.used_wide_radius & ~is_init,
        status=new_state.status,
        local_ba_ran=ba_ran & is_tracking & ~is_init,
    )
    return new_state, out_pose, metrics


def track_features(state: VOState, left: FrameFeatures,
                   right: FrameFeatures | None, config: VOConfig,
                   group=None):
    """Status dispatch over extracted features (``right`` None: RGB-D, with
    ``left.depth`` set): the lost frame returns the last pose and bumps the
    frame counter, as a pure output select. ``group``: the state's stores
    are this rank's blocks of stores sharded over the group (module
    docstring); the status is the same on every rank, so every rank takes
    the same selects and the collectives line up."""
    is_init = state.status == NOT_INITIALIZED
    is_lost = state.status == LOST
    tracked_state, pose, metrics = _track_branch(state, left, right, config,
                                                 is_init, group)
    lost_state = state._replace(frame_number=state.frame_number + 1)
    lost_metrics = StepMetrics.zero(state.status.device)._replace(
        map_points_count=psum_if(state.map.size(), group).to(torch.int32),
        status=torch.full((), LOST, dtype=torch.int32,
                          device=state.status.device))
    return (_select(is_lost, lost_state, tracked_state),
            _select(is_lost, state.pose, pose),
            _select(is_lost, lost_metrics, metrics))


def _check_config(config: VOConfig) -> None:
    extract._descriptor_mode(config)


def track_step_stereo(state: VOState, img_left: torch.Tensor,
                      img_right: torch.Tensor, config: VOConfig):
    """Full stereo frame: extraction + tracking -> (state, pose, metrics)."""
    _check_config(config)
    left, right = extract.extract_features_stereo(img_left, img_right, config)
    return track_features(state, left, right, config)


def _scan(make_step, state: VOState, xs, runners: dict, kind: str, *,
          group=None, batched: bool = False):
    """The step over the frames of ``xs`` (their leading axis) in order,
    lvt_tpu's ``lax.scan`` over a chunk: the runner of entry point ``kind``
    in ``runners`` (the caller's cache, core/graphs.py; made on first use
    from ``make_step()``; ``batched``: the step vmaps ``track_features``
    over streams) replays one graph of the step per frame, writing
    ``state``'s leaves in place. Returns (state, poses [N], metrics [N])."""
    poses, metrics = graphs.runner(runners, kind, make_step, state, xs,
                                   group=group, batched=batched).run(*xs)
    return state, poses, metrics


def track_chunk_stereo(state: VOState, imgs_left: torch.Tensor,
                       imgs_right: torch.Tensor, config: VOConfig,
                       runners: dict):
    """N frames in order, through the stereo runner in ``runners`` (which
    writes ``state`` in place); returns (state, poses [N], metrics [N])."""
    return _scan(lambda: partial(track_step_stereo, config=config), state,
                 (imgs_left, imgs_right), runners, "stereo")


def track_step_rgbd(state: VOState, img_gray: torch.Tensor,
                    img_depth: torch.Tensor, config: VOConfig):
    """Full RGB-D frame (gray image, float32 metric depth): extraction with
    the depth lookup + tracking -> (state, pose, metrics)."""
    _check_config(config)
    left = extract.extract_features_rgbd(img_gray, img_depth, config)
    return track_features(state, left, None, config)


def track_chunk_rgbd(state: VOState, imgs_gray: torch.Tensor,
                     imgs_depth: torch.Tensor, config: VOConfig,
                     runners: dict):
    """N RGB-D frames in order, through the RGB-D runner in ``runners``;
    returns (state, poses [N], metrics [N])."""
    return _scan(lambda: partial(track_step_rgbd, config=config), state,
                 (imgs_gray, imgs_depth), runners, "rgbd")


def _rectify_pair(img_left: torch.Tensor, img_right: torch.Tensor,
                  map_left: torch.Tensor, map_right: torch.Tensor):
    """Rectify a raw stereo pair inside the step (the maps are fixed per
    sequence): both images as one batch of ``undistort.remap_bilinear``,
    float32 out, so extraction takes kernel A's float32 kernel and no tie
    dither."""
    with stage("rectify"):
        out = undistort.remap_bilinear(torch.stack([img_left, img_right]),
                                       torch.stack([map_left, map_right]))
    return out[0], out[1]


def track_step_stereo_rectified(state: VOState, img_left: torch.Tensor,
                                img_right: torch.Tensor,
                                map_left: torch.Tensor,
                                map_right: torch.Tensor, config: VOConfig):
    """Raw (distorted, unrectified) stereo frame and its [H, W, 2] remaps:
    rectification + extraction + tracking -> (state, pose, metrics)."""
    left, right = _rectify_pair(img_left, img_right, map_left, map_right)
    return track_step_stereo(state, left, right, config)


def track_chunk_stereo_rectified(state: VOState, imgs_left: torch.Tensor,
                                 imgs_right: torch.Tensor,
                                 map_left: torch.Tensor,
                                 map_right: torch.Tensor, config: VOConfig,
                                 runners: dict):
    """N raw stereo frames in order, each rectified inside its step,
    through the rectified runner in ``runners`` (the maps are fixed per
    runner); returns (state, poses [N], metrics [N])."""
    return _scan(lambda: partial(track_step_stereo_rectified,
                                 map_left=map_left, map_right=map_right,
                                 config=config),
                 state, (imgs_left, imgs_right), runners, "rectified")


def track_step_external_corners(state: VOState, img_left: torch.Tensor,
                                img_right: torch.Tensor,
                                corners_left: torch.Tensor,
                                corners_left_valid: torch.Tensor,
                                corners_right: torch.Tensor,
                                corners_right_valid: torch.Tensor,
                                config: VOConfig):
    """Stereo frame at caller-supplied corners ([kp_capacity, 2] each with
    validity): BRIEF at the corners of both images as one batch, then the
    tracking body (kernel T at its sites; kernels A and P do not run) ->
    (state, pose, metrics)."""
    feats = extract.describe_external_corners_batched(
        torch.stack([img_left, img_right]),
        torch.stack([corners_left, corners_right]),
        torch.stack([corners_left_valid, corners_right_valid]), config)
    left, right = (FrameFeatures(*(a[i] for a in feats)) for i in (0, 1))
    return track_features(state, left, right, config)
