"""Feature extraction in three descriptor modes, bit-identical at valid
keypoints:

* patch (the default): kernel A -> per-cell corner selection (the op
  ``lvt_tpu_torch::select_corners``, csrc/select.cu) -> kernel P (BRIEF
  and subpixel refinement of each slot, read from A's maps);
* dense: kernel A -> kernel B (BRIEF bit planes of every pixel) ->
  per-cell selection with subpixel refinement on the raw map (the same
  op), which also reads each slot's descriptor from the planes;
* sparse: kernel A -> the same selection -> BRIEF at each selected corner
  from A's box sums (one gather of its 64 pool samples), in torch ops, as
  lvt_tpu runs this mode in XLA ops.

Port of lvt_tpu/core/extract.py (``_descriptor_mode``,
``perception_batched``, ``_select_and_describe``, ``_extract_patch_mode``,
``extract_features_batched``, ``extract_features``,
``extract_features_stereo``, ``extract_features_rgbd`` and
``describe_external_corners``). Left and right are one batch of 2; the S
streams of the multi-stream step one batch of 2S (or S gray images for
RGB-D).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function as stage

from lvt_tpu_torch.config import VOConfig
from lvt_tpu_torch.core.features import FrameFeatures
from lvt_tpu_torch.ops import brief, detect, undistort
from lvt_tpu_torch.ops import patches as pt
from lvt_tpu_torch.ops.perception import (perception_maps_batched,
                                          perception_patch_maps_batched)


def _spread_ties(imgs: torch.Tensor) -> bool:
    """Plateau-dither selection only for integer-valued (uint8) frames."""
    return imgs.dtype == torch.uint8


def _select(nms, config: VOConfig, spread_ties: bool, raw=None,
            planes=None) -> tuple:
    """Per-cell selection into the slot buffers (``detect.select_slots``:
    one launch for all images of the frame on the card; with kernel B's
    ``planes``, each slot's descriptor from them)."""
    return detect.select_slots(
        nms, config.agast_threshold, cell_size=config.detection_cell_size,
        max_per_cell=config.max_keypoints_per_cell,
        corners_low_threshold=config.corners_low_threshold,
        spread_ties=spread_ties, capacity=config.kp_capacity, score_raw=raw,
        planes=planes)


def _extract_patch_mode(imgs: torch.Tensor, config: VOConfig) -> FrameFeatures:
    bsz, h, w = imgs.shape
    if imgs.dtype != torch.uint8:
        imgs = imgs.float()
    spread_ties = _spread_ties(imgs)
    with stage("perception"):
        nms, raw, smooth = perception_patch_maps_batched(imgs)
    with stage("corner_select"):
        xi, yi, xc, yc, score, sel_valid = _select(nms, config,
                                                   spread_ties)[:6]
    with stage("patch_describe"):
        desc, valid, kp = pt.describe_refine_batched(
            smooth, raw, xc, yc, xi, yi, sel_valid, h, w)
    return FrameFeatures(
        kp=kp, desc=desc, score=score,
        depth=torch.zeros((bsz, config.kp_capacity), dtype=torch.float32,
                          device=imgs.device),
        valid=valid,
    )


def _descriptor_mode(config: VOConfig) -> str:
    """Resolve config.descriptor_mode as lvt_tpu does (an explicit mode,
    else "sparse" when use_dense_brief is off), except that an unset mode
    is "patch" on every device (lvt_tpu picks "dense" off the TPU: both
    give the same features)."""
    mode = config.descriptor_mode
    if mode is None:
        mode = "patch" if config.use_dense_brief else "sparse"
    if mode not in ("patch", "dense", "sparse"):
        raise ValueError(f"unknown descriptor_mode {mode!r}")
    return mode


def _extract_per_cell(imgs: torch.Tensor, config: VOConfig,
                      mode: str) -> FrameFeatures:
    """The dense and sparse modes: kernel A (dense: then kernel B), per-cell
    selection with subpixel refinement on the raw map, and each corner's
    descriptor from B's planes (dense: in the selection's launch) or from
    A's box sums (sparse). Descriptors sample at the integer corner; the
    subpixel position is the observation only."""
    spread_ties = _spread_ties(imgs)
    if imgs.dtype != torch.uint8:
        imgs = imgs.float()
    with stage("perception"):
        if mode == "dense":
            raw, nms, aux = perception_maps_batched(imgs)
        else:
            nms, raw, aux = perception_patch_maps_batched(imgs)
    with stage("corner_select_describe"):
        dense = mode == "dense"
        (_, _, _, _, score, sel_valid, kp, corner, desc, valid) = _select(
            nms, config, spread_ties, raw, aux if dense else None)
        if not dense:
            desc, valid = brief.descriptors_sparse(aux, corner, sel_valid)
        return FrameFeatures(
            kp=kp, desc=desc.contiguous(), score=score,
            depth=torch.zeros((imgs.shape[0], config.kp_capacity),
                              dtype=torch.float32, device=imgs.device),
            valid=valid,
        )


def extract_features_batched(imgs: torch.Tensor, config: VOConfig) -> FrameFeatures:
    """[B, H, W] images -> batched FrameFeatures [B, kp_capacity]."""
    mode = _descriptor_mode(config)
    if mode == "patch":
        return _extract_patch_mode(imgs, config)
    return _extract_per_cell(imgs, config, mode)


def extract_features_stereo(img_left: torch.Tensor, img_right: torch.Tensor,
                            config: VOConfig):
    feats = extract_features_batched(torch.stack([img_left, img_right]), config)
    return (FrameFeatures(*(a[0] for a in feats)),
            FrameFeatures(*(a[1] for a in feats)))


def extract_features(img: torch.Tensor, config: VOConfig) -> FrameFeatures:
    """Detect + describe one grayscale image -> FrameFeatures [kp_capacity]."""
    feats = extract_features_batched(img[None], config)
    return FrameFeatures(*(a[0] for a in feats))


def apply_depth(feats: FrameFeatures, img_depth: torch.Tensor,
                config: VOConfig) -> FrameFeatures:
    """The RGB-D tail of extraction, on one image's features: the depth at
    the clipped integer keypoint, ``valid`` cleared outside [near, far]
    (fixed shapes: nothing is compacted), and the keypoints undistorted
    when |k1| > 1e-5. lvt_tpu's multi-stream ``_apply_depth`` is the same
    function; the multi-stream step runs it under vmap."""
    xi = torch.clamp(feats.kp[:, 0].to(torch.int32), 0, config.img_width - 1)
    yi = torch.clamp(feats.kp[:, 1].to(torch.int32), 0, config.img_height - 1)
    d = img_depth[yi.long(), xi.long()]
    ok = (d >= config.near_plane_distance) & (d <= config.far_plane_distance)
    kp = feats.kp
    if abs(config.k1) > 1e-5:
        kp = undistort.undistort_points(
            kp, config.fx, config.fy, config.cx, config.cy,
            config.k1, config.k2, config.p1, config.p2, config.k3)
    return feats._replace(kp=kp, depth=d, valid=feats.valid & ok)


def extract_features_rgbd(img_gray: torch.Tensor, img_depth: torch.Tensor,
                          config: VOConfig) -> FrameFeatures:
    """RGB-D frame: detect + describe the gray image, then keep only the
    keypoints with a depth in [near, far] (:func:`apply_depth`)."""
    return apply_depth(extract_features(img_gray, config), img_depth, config)


def describe_external_corners_batched(imgs: torch.Tensor,
                                      corners: torch.Tensor,
                                      corners_valid: torch.Tensor,
                                      config: VOConfig) -> FrameFeatures:
    """Descriptors only, at caller-supplied corners: imgs [B, H, W], corners
    [B, N, 2] f32 (x, y), corners_valid [B, N] -> FrameFeatures [B,
    kp_capacity] with the corners as keypoints, BRIEF from the box sums
    (``brief.compute_descriptors``), zero score and depth. No kernel runs:
    lvt_tpu computes this with XLA ops."""
    desc, valid = brief.compute_descriptors(imgs, corners, corners_valid)
    cap = config.kp_capacity
    zeros = torch.zeros((imgs.shape[0], cap), dtype=torch.float32,
                        device=imgs.device)
    return FrameFeatures(
        kp=detect.pad_to(corners.float(), cap, axis=1),
        desc=detect.pad_to(desc, cap, 1), score=zeros, depth=zeros.clone(),
        valid=detect.pad_to(valid, cap, 1))


def describe_external_corners(img: torch.Tensor, corners: torch.Tensor,
                              corners_valid: torch.Tensor,
                              config: VOConfig) -> FrameFeatures:
    """One image's :func:`describe_external_corners_batched`."""
    feats = describe_external_corners_batched(img[None], corners[None],
                                              corners_valid[None], config)
    return FrameFeatures(*(a[0] for a in feats))
