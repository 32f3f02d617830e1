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

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core import extract, graphs, tail, track
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.core.state import (NOT_INITIALIZED, ObsWindow, PointStore,
                                      VOState)
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.ops import matching, top2, undistort
from lvt_tpu_torch.solver import bundle
from lvt_tpu_torch.solver.pnp import solve_pnp


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


def _refine_structure(poses: Pose, pos, obs, w, obs_r, w_r, config: VOConfig,
                      group=None):
    """One windowed BA over the map (``bundle.refine_structure_plain``):
    the gate, the refinement, the trust region and the improvement test.
    Returns positions [M, 3]. Without a group, one launch of the op
    ``lvt_tpu_torch::ba_refine`` (``bundle.ba_refine``: the kernel of
    csrc/ba.cu on the card, the torch ops on the CPU); with one, the
    launches of its phases, ``lvt_tpu_torch::ba_phase``, with the
    all-reduces of their sums between them
    (``bundle.refine_structure_phases``; on the CPU each phase's torch
    ops)."""
    kw = dict(fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
              baseline=config.baseline, iterations=config.local_ba_iterations,
              reprojection_th2=config.reprojection_th2)
    if group is None:
        return bundle.ba_refine(poses, pos, obs, w, obs_r, w_r, **kw)[0]
    return bundle.refine_structure_phases(poses, pos, obs, w, obs_r, w_r,
                                          group=group, **kw).positions


def _local_ba_update(ba: ObsWindow, map_store: PointStore, pose_opt: Pose,
                     obs_new, w_new, row_packed, match_idx, right_kp,
                     bookkept_valid, clean_valid, map_taken, promo_taken,
                     frame_number, config: VOConfig, group=None):
    """Slide the observation window by this frame and, every
    ``local_ba_every`` frames once it is full, refine the map structure.
    lvt_tpu's ``_local_ba_update`` with the BA row match folded in: the
    right observations come from kernel T's second row set
    (``row_packed``; None without a right camera) at each slot's feature
    (``match_idx``), and the slots invalidated this frame from the map's
    validity after the bookkeeping and the cull and the slots the
    insertions and promotions took (``promo_taken`` None without a staged
    set). The row match, the observations and the slide are one launch of
    the op ``lvt_tpu_torch::ba_observe`` (core/track.py), on every frame. Returns (window', the window's newest
    pose, map positions, whether BA ran). BA is lvt_tpu's ``lax.cond`` on
    the schedule, ``graphs.cond``: a CUDA IF node on the device predicate
    in a captured single-process or NCCL step, computed and selected
    elsewhere (no host sync either way). The trajectory stays the PnP
    output."""
    window, do_ba = track.ba_observe(
        row_packed, match_idx, obs_new, w_new, right_kp, pose_opt, ba,
        map_store.valid, bookkept_valid, clean_valid, map_taken, promo_taken,
        frame_number, ratio_threshold=config.triangulation_ratio_test_threshold,
        abs_threshold=config.descriptor_matching_threshold,
        local_ba_every=config.local_ba_every, group=group)
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
    lvt_tpu's jax.named_scope. Returns the tracked values as a VOState
    (its ``frame_number`` and ``status`` the state's) and what the tail
    reads besides (``tail.TailInputs``)."""
    cam = _camera_kwargs(config)

    # the motion model and the map's projection at its prediction (op
    # predict_project; its stage also holds the query side of map_matching)
    with stage("motion_predict"):
        motion, predicted, uv, visible = track.predict_project(
            state.motion, state.pose, is_init, state.map.pos,
            state.map.valid, cam, group)

    with stage("map_matching"):
        mm = matching.match_projected(
            uv, visible, state.map.desc, left,
            tracking_radius=config.tracking_radius,
            ratio_threshold=config.tracking_ratio_test_threshold,
            abs_threshold=config.descriptor_matching_threshold,
            retry_min_matches=config.n_matches_threshold, group=group)
    matches_count = mm.matches_count

    obs, weights = mm.obs, mm.weights
    with stage("pnp_solve"):
        pnp = solve_pnp(predicted, state.map.pos, obs, weights,
                        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
                        reprojection_th2=config.reprojection_th2,
                        group=group)

    # the map's bookkeeping and cull, the frame's pose and the staged
    # points' projection at it (op upkeep_pre; its stage also holds the
    # query side of staged_update)
    staged_on = config.staged_threshold > 0
    with stage("map_bookkeeping"):
        up = track.upkeep_pre(
            state.map, mm.match_idx, mm.feature_matched, left.valid, pnp.pose,
            is_init, state.staged if staged_on else None,
            config.untracked_threshold, cam, group)
    pose_opt, map_bookkept, map_clean = up.pose, up.bookkept, up.clean

    if staged_on:
        # re-match the staged points against the unclaimed features (kernel
        # T), delete misses, promote survivors (op staged_promote)
        with stage("staged_update"):
            staged_top2, _ = matching.dual_radius_top2(
                state.staged.desc, left.desc, up.staged_uv,
                up.staged_visible, left.kp, up.staged_targets,
                config.tracking_radius, config.tracking_radius)
            promo = track.staged_promote(
                staged_top2, state.staged, up.feature_matched, up.map_size,
                map_clean,
                ratio_threshold=config.tracking_ratio_test_threshold,
                abs_threshold=config.descriptor_matching_threshold,
                staged_threshold=config.staged_threshold,
                map_soft_cap=config.map_soft_cap, group=group)
        staged_out, map_after_promo = promo.staged, promo.map
        feature_matched = promo.feature_matched
    else:
        staged_out, map_after_promo = state.staged, map_clean
        feature_matched = up.feature_matched

    # lvt_tpu builds one stereo Hamming matrix for the triangulation row
    # match and the BA row match (complementary query sets); here kernel T
    # computes the distances itself, and one launch in its dual row mode
    # serves both sets over the same window
    want_ba_rm = (config.local_ba_window > 0 and right is not None
                  and config.baseline != 0.0)

    # stereo: row-match the unclaimed left features (kernel T) and
    # triangulate the pairs; RGB-D: back-project every depth-valid feature,
    # matched or not, as the reference does (duplicates are culled by the
    # untracked counter); then the policy and the insertions (op
    # triangulate_insert)
    with stage("triangulation"):
        row_packed = row_top2 = None
        if right is not None:
            row_packed = matching.row_top2_packed(
                left, right, feature_matched,
                mm.feature_matched if want_ba_rm else None,
                vertical_search_radius=(
                    config.row_matching_vertical_search_radius),
                img_rows=config.img_height)
            row_top2 = top2._unpack(*row_packed)[0]
        tri = track.triangulate_insert(
            row_top2, left, right, pose_opt, map_after_promo, staged_out,
            state.last_matches, matches_count, is_init, cam,
            track.TriangulationParams.of(config), group)

    final_map, pose_final, ba_window = tri.map, pose_opt, state.ba
    ba_ran = None
    if config.local_ba_window > 0:
        # right-camera observations of the map-matched features from T's
        # second row set; no right camera (or no baseline): no stereo
        # anchor, so BA is inert
        with stage("local_ba"):
            ba_window, pose_final, refined_pos, ba_ran = _local_ba_update(
                state.ba, final_map, pose_opt, obs, weights,
                row_packed if want_ba_rm else None, mm.match_idx,
                right.kp if want_ba_rm else None, map_bookkept.valid,
                map_clean.valid, tri.map_taken,
                promo.taken if staged_on else None, state.frame_number,
                config, group)
        final_map = final_map._replace(pos=refined_pos)

    new = VOState(map=final_map, staged=tri.staged, pose=pose_final,
                  motion=motion, last_matches=tri.window,
                  frame_number=state.frame_number, status=state.status,
                  ba=ba_window)
    return new, tail.TailInputs(
        map_bookkept.counter, map_bookkept.age, mm.match_idx, mm.d1, mm.d2,
        obs, left.valid, matches_count, tri.map_size, pnp.inlier_count,
        tri.n_inserted, mm.used_wide_radius, ba_ran)


def track_branch(state: VOState, left: FrameFeatures,
                 right: FrameFeatures | None, config: VOConfig, group=None):
    """The step before its tail: the tracked values as a VOState and what
    the tail reads besides (``tail.TailInputs``); the body that
    parallel/multistream.py vmaps over streams before one tail for all."""
    is_init = state.status == NOT_INITIALIZED
    return _track_branch(state, left, right, config, is_init, group)


def track_features(state: VOState, left: FrameFeatures,
                   right: FrameFeatures | None, config: VOConfig,
                   group=None):
    """Status dispatch over extracted features (``right`` None: RGB-D, with
    ``left.depth`` set): the lost frame returns the last pose and bumps the
    frame counter, as a pure output select. ``group``: the state's stores
    are this rank's blocks of stores sharded over the group (module
    docstring); the status is the same on every rank, so every rank takes
    the same selects and the collectives line up. The selects on the
    frame's outcome and the metrics are the profiler range ``step_tail``:
    one launch of the op ``lvt_tpu_torch::step_tail`` (core/tail.py),
    which inside the runner's frame also ends it (then the pose and
    metrics are in the chunk's rows, and None here)."""
    new, inputs = track_branch(state, left, right, config, group)
    with stage("step_tail"):
        return tail.step_tail(state, new, inputs,
                              config.min_num_matches_for_tracking, group)


def _check_config(config: VOConfig) -> None:
    extract._descriptor_mode(config)


def track_step_stereo(state: VOState, img_left: torch.Tensor,
                      img_right: torch.Tensor, config: VOConfig):
    """Full stereo frame: extraction + tracking -> (state, pose, metrics)."""
    _check_config(config)
    left, right = extract.extract_features_stereo(img_left, img_right, config)
    return track_features(state, left, right, config)


def _scan(make_step, state: VOState, xs, runners: dict, kind: str, *,
          group=None, batched: bool = False, make_reset=None):
    """The step over the frames of ``xs`` (their leading axis) in order,
    lvt_tpu's ``lax.scan`` over a chunk: the runner of entry point ``kind``
    in ``runners`` (the caller's cache, core/graphs.py; made on first use
    from ``make_step()`` and ``make_reset()``, the initial state a stream
    it loses is reset to; ``batched``: the step vmaps the tracking body
    over streams) replays one graph of the step per frame, writing
    ``state``'s leaves in place. Returns (state, poses [N], metrics
    [N])."""
    poses, metrics = graphs.runner(runners, kind, make_step, state, xs,
                                   group=group, batched=batched,
                                   make_reset=make_reset).run(*xs)
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


def track_step_packed_corners(state: VOState, img_left: torch.Tensor,
                              img_right: torch.Tensor, packed: torch.Tensor,
                              config: VOConfig):
    """:func:`track_step_external_corners` on the caller's corners as one
    upload, ``packed`` [2, kp_capacity, 3] (x, y, valid > 0) for the left
    and the right image: unpacked inside the step (on the card inside its
    graph, so a call launches only the upload and the runner's chunk of
    one from the host)."""
    valid = packed[..., 2] > 0
    return track_step_external_corners(
        state, img_left, img_right, packed[0, :, :2], valid[0],
        packed[1, :, :2], valid[1], config)
